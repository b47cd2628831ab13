"""Phi-3 Medium 14B [arXiv:2404.14219]: dense, RoPE, SwiGLU, GQA kv=10."""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    rope_theta=10000.0,
    citation="arXiv:2404.14219",
)

LONG_CONTEXT = dataclasses.replace(FULL, sliding_window=8192)

SMOKE = dataclasses.replace(
    FULL, num_layers=2, d_model=320, num_heads=10, num_kv_heads=2,
    head_dim=32, d_ff=640, vocab_size=1000, vocab_pad_mult=128)
