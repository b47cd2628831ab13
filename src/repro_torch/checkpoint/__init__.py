"""npz checkpoint store (the counterpart of `repro.checkpoint`)."""
