"""Blocked causal / sliding-window GQA attention for prefill: the CUDA
kernel `flash_attention.cu`, its wrapper `ops.attention_bhsd` and its
plain version `ref.flash_attention_ref`."""
