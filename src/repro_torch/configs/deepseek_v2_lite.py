"""DeepSeek-V2-Lite [hf:deepseek-ai/DeepSeek-V2-Lite, config.json;
arXiv:2405.04434]: MLA without a query LoRA (kv_lora 512, qk 128 + 64
rope, v 128, 16 heads), a dense first layer of width 10,944
(`first_k_dense_replace` 1), then 26 layers of 64 fine-grained experts of
width 1,408, softmax-scored top-6 with no renormalisation of the gates
(`norm_topk_prob` false, `routed_scaling_factor` 1), beside 2 shared
experts (one always-on SwiGLU of width 2,816); YaRN RoPE (factor 40 over
4,096 original positions, beta 32 / 1, mscale = mscale_all_dim = 0.707),
vocab 102,400, RMSNorm eps 1e-6, untied embeddings: 15.71 B parameters,
2.4 B a token. Served dropless (`moe_capacity_factor` 0), as published.

The port's own architecture: the JAX package has no counterpart. It
applies RoPE to the halves of the 64 rope columns (rotate_half); HF
applies it to interleaved pairs, which with random weights is a fixed
permutation of the rope columns of `wq` and `kv_down` and computes the
same model.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,
    vocab_size=102400,
    attn_type="mla",
    rope_theta=10000.0,
    yarn_factor=40.0,
    yarn_original_max_pos=4096,
    yarn_beta_fast=32.0,
    yarn_beta_slow=1.0,
    yarn_mscale=0.707,
    yarn_mscale_all_dim=0.707,
    q_lora_rank=0,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    num_experts=64,
    experts_per_token=6,
    moe_capacity_factor=0.0,
    moe_d_ff=1408,
    moe_shared_d_ff=2816,
    moe_renormalize=False,
    first_k_dense_replace=1,
    norm_eps=1e-6,
    citation="hf:deepseek-ai/DeepSeek-V2-Lite",
)

LONG_CONTEXT = dataclasses.replace(FULL, sliding_window=8192)

SMOKE = dataclasses.replace(
    FULL, num_layers=3, d_model=256, num_heads=4, num_kv_heads=4, d_ff=512,
    kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    num_experts=8, experts_per_token=3, moe_d_ff=64, moe_shared_d_ff=64,
    vocab_size=1000, vocab_pad_mult=128)
