"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B]: dense with Multi-head Latent
Attention (MLA). kv=40 in the pool table reflects MLA's full per-head K/V
after latent expansion; the cache itself stores the compressed latent."""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attn_type="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    citation="hf:openbmb/MiniCPM3-4B",
)

LONG_CONTEXT = dataclasses.replace(FULL, sliding_window=8192)

SMOKE = dataclasses.replace(
    FULL, num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
    d_ff=512, q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=16,
    qk_rope_dim=8, v_head_dim=16, vocab_size=1000, vocab_pad_mult=128)
