"""Training substrate: AdamW + schedules (the counterpart of
`repro.training`)."""
