"""IBM Granite-MoE 3B-A800M [hf:ibm-granite/granite-3.0-3b-a800m-base;
pool cites granite-3.0-1b-a400m]: 40 experts, top-8, per-expert d_ff=512.

Note: the pool line lists both "MoE 40e top-8" and "32 experts top-8";
the explicit config fields (40 experts) take precedence — 40e matches the
3b-a800m model card, 32e is the 1b-a400m card the bracket cites.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    experts_per_token=8,
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base (40e/top-8 per 3b-a800m card)",
)

LONG_CONTEXT = dataclasses.replace(FULL, sliding_window=8192)

SMOKE = dataclasses.replace(
    FULL, num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
    head_dim=32, d_ff=128, num_experts=4, experts_per_token=2,
    vocab_size=1000, vocab_pad_mult=128)
