"""Zamba2-7B [arXiv:2411.15242]: 81 Mamba2 layers + one SHARED attention
block applied every 6 SSM layers (13 applications + 3 tail SSM layers)."""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,          # d_model / num_heads
    d_ff=14336,            # shared block MLP
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,       # d_inner = 7168 -> 112 SSD heads
    ssm_expand=2,
    hybrid_period=6,
    citation="arXiv:2411.15242",
)

LONG_CONTEXT = dataclasses.replace(FULL, sliding_window=8192)

SMOKE = dataclasses.replace(
    FULL, num_layers=5, d_model=256, num_heads=4, num_kv_heads=4,
    head_dim=64, d_ff=512, ssm_state=16, ssm_head_dim=32,
    hybrid_period=2, vocab_size=1000, vocab_pad_mult=128)
