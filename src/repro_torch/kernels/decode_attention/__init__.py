"""Single-token decode attention against a KV cache: the CUDA kernel
`decode_attention.cu` (split pass and merge in one launch), its wrapper
`ops.decode_bhd` and its plain version
`ref.decode_attention_ref_explicit`."""
