"""Plain PyTorch version of the flash_attention kernel (the counterpart
of `repro.kernels.flash_attention.ref.flash_attention_ref`).

It materializes the score matrix and keeps the softmax in float32, as
the kernel does; the model's own attention (`models.attention`) rounds
the probabilities to the input dtype instead, so at bfloat16 the kernel
is held to this version, not to the model's.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None,
                        q_offset=0):
    """q: (B, H, Sq, D); k: (B, Hkv, Skv, D); v: (B, Hkv, Skv, Dv).
    Returns (B, H, Sq, Dv) in q's dtype. Query i (global position i + q_offset) sees key j iff
    j <= i + q_offset (when causal) and j > i + q_offset - window (when
    window)."""
    h, sq, d = q.shape[1], q.shape[2], q.shape[3]
    hkv, skv = k.shape[1], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    scale = d ** -0.5 if scale is None else scale
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qp = torch.arange(sq, device=q.device)[:, None] + q_offset
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)
