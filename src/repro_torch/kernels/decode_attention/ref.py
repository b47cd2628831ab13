"""Plain PyTorch versions of the decode_attention kernel (the
counterparts of `repro.kernels.decode_attention.ref`).

`decode_attention_ref_explicit` is the float32 oracle: the kernel's plain
version, which its wrapper runs on CPU tensors. `decode_attention_ref`
is the reference's model math (`models.attention.attention` under the
decode mask), which rounds the probabilities to the input dtype before
the PV product.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, pos, *, window=0):
    """q: (B,H,D); caches (B,S,Hkv,D); pos (B,). Returns (B,H,D)."""
    from repro_torch.models.attention import attention, decode_mask
    mask = decode_mask(k_cache.shape[1], pos, window, q.device)
    return attention(q[:, None], k_cache, v_cache, mask)[:, 0]


def decode_attention_ref_explicit(q, k_cache, v_cache, pos, *, window=0,
                                  scale=None):
    """Fully explicit float32 oracle. q: (B, H, D); k_cache (B, S, Hkv,
    D), v_cache (B, S, Hkv, Dv); pos (B,) valid lengths. Returns (B, H,
    Dv) in q's dtype."""
    h, d = q.shape[1], q.shape[2]
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    rep = h // hkv
    k = k_cache.repeat_interleave(rep, dim=2).float()   # (B, S, H, D)
    v = v_cache.repeat_interleave(rep, dim=2).float()
    scale = d ** -0.5 if scale is None else scale
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k) * scale
    idx = torch.arange(s, device=q.device)[None, None, :]
    p = pos.reshape(-1, 1, 1)
    mask = idx < p
    if window:
        mask &= idx >= p - window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    return torch.einsum("bhs,bshd->bhd", probs, v).to(q.dtype)
