"""InternVL2-2B [arXiv:2404.16821]: InternViT (STUB frontend) + InternLM2
language backbone. input_specs provides pre-projected patch embeddings."""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    frontend="vision",
    frontend_tokens=256,    # 256 patch embeddings per image (ViT stub)
    citation="arXiv:2404.16821",
)

LONG_CONTEXT = dataclasses.replace(FULL, sliding_window=8192)

SMOKE = dataclasses.replace(
    FULL, num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
    head_dim=32, d_ff=512, frontend_tokens=16, vocab_size=1000,
    vocab_pad_mult=128)
