"""IBM Granite-3 8B [hf:ibm-granite/granite-3.0-2b-base family]: dense GQA."""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=10000.0,
    citation="hf:ibm-granite/granite-3.0-2b-base",
)

LONG_CONTEXT = dataclasses.replace(FULL, sliding_window=8192)

SMOKE = dataclasses.replace(
    FULL, num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
    head_dim=32, d_ff=512, vocab_size=1000, vocab_pad_mult=128)
