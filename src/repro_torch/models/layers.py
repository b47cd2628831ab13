"""Common neural layers: RMSNorm, RoPE, SwiGLU, embeddings (the
counterpart of `repro.models.layers`). Plain functions on tensors, with
the reference's float32 upcasts kept where it has them."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight).to(dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embeddings, shape (head_dim//2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary position embedding.

    x: (..., S, H, D) with D even; positions: broadcastable to (..., S).
    Uses the half-split convention (rotate_half), matching Llama.
    """
    d = x.shape[-1]
    inv_freq = rope_frequencies(d, theta, x.device)              # (D/2,)
    angles = positions[..., None].float() * inv_freq             # (...,S,D/2)
    cos = torch.cos(angles)[..., None, :]                        # (...,S,1,D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g) * u) @ w_down


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup against a (padded_vocab, d_model) table."""
    return table[tokens]


def unembed(h: torch.Tensor, table: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Project to (padded) vocabulary logits; padded ids set to the
    dtype's lowest finite value."""
    logits = h @ table.T
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = torch.finfo(logits.dtype).min
    return logits


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross entropy. logits (B,S,V), labels (B,S)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
