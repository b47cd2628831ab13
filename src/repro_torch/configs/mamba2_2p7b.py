"""Mamba2-2.7B [arXiv:2405.21060]: attention-free SSD, state N=128."""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attn_type="none",
    ssm_state=128,
    ssm_head_dim=64,       # d_inner = 5120 -> 80 SSD heads
    ssm_expand=2,
    ssm_conv_width=4,
    citation="arXiv:2405.21060",
)

LONG_CONTEXT = FULL  # O(1) state: long_500k runs natively

SMOKE = dataclasses.replace(
    FULL, num_layers=2, d_model=256, ssm_state=32, ssm_head_dim=32,
    vocab_size=1000, vocab_pad_mult=128)
