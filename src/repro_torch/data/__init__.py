"""Deterministic synthetic data pipeline (the counterpart of `repro.data`,
a copy: its batches are the reference's, bit for bit)."""
