"""Fleet-batched NBTI dVth advance: the CUDA kernel `aging_update.cu`,
its wrapper `ops.advance_fleet` and its plain version
`ref.aging_update_ref`."""
