"""Mixtral 8x22B [arXiv:2401.04088]: 8 experts top-2, native SWA 4096."""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,     # native (Mixtral inherits Mistral SWA)
    rope_theta=1000000.0,
    citation="arXiv:2401.04088",
)

LONG_CONTEXT = FULL  # native SWA already bounds the decode working set

SMOKE = dataclasses.replace(
    FULL, num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
    head_dim=32, d_ff=256, num_experts=4, experts_per_token=2,
    sliding_window=64, vocab_size=1000, vocab_pad_mult=128)
