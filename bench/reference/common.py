"""Plain PyTorch pieces shared by the families' references: RMSNorm,
rotary embedding, SwiGLU, and the products in the reference's precision
(float32 with TF32 off) or in the control's (FP8 e4m3 inputs).

Nothing here imports the program under test.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0       # largest finite float8_e4m3fn


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x / sqrt(mean(x^2) + eps) * w over the last dim."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding, half-split (rotate_half) convention: x (S, H, D),
    positions (S,); frequencies theta ** (-2i / D)."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=x.device) / d)
    ang = positions.float()[:, None] * inv                  # (S, D/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def f32_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in float32 (the caller turns TF32 off)."""
    return x @ w


def _fp8(t: torch.Tensor, dim) -> torch.Tensor:
    """t rounded through float8_e4m3fn with a scale of amax / 448 over
    `dim` (None: the whole tensor)."""
    amax = (t.abs().amax() if dim is None
            else t.abs().amax(dim=dim, keepdim=True)).clamp_min(1e-30)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The control's product: x rounded to FP8 e4m3 per row (token), w
    per tensor, as FP8 inference scales them; the product of the rounded
    values in float32."""
    return _fp8(x, -1) @ _fp8(w, None)


GEMMS = {"float32": f32_gemm, "fp8": fp8_gemm}


def swiglu(x, w_gate, w_up, w_down, gemm):
    return gemm(F.silu(gemm(x, w_gate)) * gemm(x, w_up), w_down)


def causal_attention(q, k, v, scale, block: int = 1024):
    """softmax(q k^T * scale, causal) v over (S, H, D) in query blocks of
    `block` rows, so the scores of one block are held at a time."""
    s = q.shape[0]
    out = []
    kh, vh = k.transpose(0, 1), v.transpose(0, 1)           # (H, S, D)
    for a in range(0, s, block):
        b = min(a + block, s)
        scores = torch.einsum("qhd,hkd->hqk", q[a:b], kh[:, :b]) * scale
        qi = torch.arange(a, b, device=q.device)[:, None]
        ki = torch.arange(b, device=q.device)[None, :]
        scores = scores.masked_fill(ki > qi, float("-inf"))
        out.append(torch.einsum("hqk,hkd->qhd", torch.softmax(scores, -1),
                                vh[:, :b]))
    return torch.cat(out)
