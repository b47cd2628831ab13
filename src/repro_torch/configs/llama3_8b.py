"""Llama-3 8B [arXiv:2407.21783]: dense decoder, GQA, 128k vocab."""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    citation="arXiv:2407.21783",
)

# long_500k runs only in the sliding-window variant (see DESIGN.md).
LONG_CONTEXT = dataclasses.replace(FULL, sliding_window=8192)

SMOKE = dataclasses.replace(
    FULL, num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
    head_dim=32, d_ff=512, vocab_size=1000, vocab_pad_mult=128)
