"""SeamlessM4T-Large v2 [arXiv:2308.11596]: encoder-decoder, multimodal.
The speech frontend (mel + conv codec) is a STUB: input_specs provides
frame embeddings; we implement the 24L encoder + 24L decoder transformer.
For decode shapes the encoder memory is bounded at 4096 frames (speech
segments are chunked in streaming serving) — see DESIGN.md."""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,          # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    frontend="audio",
    frontend_tokens=1024,   # frames for train_4k (seq//4)
    citation="arXiv:2308.11596",
)

LONG_CONTEXT = dataclasses.replace(FULL, sliding_window=8192)

SMOKE = dataclasses.replace(
    FULL, num_layers=2, encoder_layers=2, d_model=256, num_heads=8,
    num_kv_heads=4, head_dim=32, d_ff=512, frontend_tokens=32,
    vocab_size=1000, vocab_pad_mult=128)
