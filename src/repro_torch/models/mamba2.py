"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060] (the
counterpart of `repro.models.mamba2`).

Per head h with state (P, N):   (P = head dim, N = ssm state dim)

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t  (outer)  B_t
    y_t = h_t @ C_t + D * x_t

`ssd_chunked` is the chunked SSD algorithm in plain PyTorch, as the
reference writes it in jnp: an intra-chunk quadratic term plus an
inter-chunk recurrence over chunk states. `ssd_reference` is the naive
sequential recurrence (kept in `kernels/ssd_scan/ref.py`, the plain
version of the CUDA kernel, and re-exported here). The model's prefill
sends the scan through the kernel on CUDA (`models/model.py`); nothing in
this module launches it.

A block's parameters `lp` are anything indexed by the reference's names
(`lp["w_z"]`): a dict of tensors, or the port's `MambaBlock`. The depthwise
conv keeps the reference's (W, C) weight layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.ssd_scan.ref import ssd_reference
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm

__all__ = ["segsum", "ssd_chunked", "ssd_reference", "ssd_decode_step",
           "mamba2_projections", "mamba2_block", "mamba2_block_decode"]


def segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{j < tau <= i} a[..., tau].

    a: (..., Q) -> (..., Q, Q), lower-triangular valid (i >= j), -inf above.
    """
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)                    # (..., Q)
    diff = cum[..., :, None] - cum[..., None, :]     # s_i - s_j
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff + a[..., None, :] * 0.0, float("-inf"))


def ssd_chunked(x, dt, a_log, b, c, chunk: int, h0=None):
    """Chunked SSD scan.

    x:  (B, L, H, P)   inputs (post-conv, post-activation)
    dt: (B, L, H)      positive step sizes (softplus applied by caller)
    a_log: (H,)        A = -exp(a_log)
    b:  (B, L, N)      input gate (single group, broadcast over heads)
    c:  (B, L, N)      output gate
    h0: (B, H, P, N)   initial state (None = zeros)

    Returns (y (B, L, H, P) in x's dtype, h_final (B, H, P, N) float32).
    """
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    if l % chunk:
        # zero-dt padding is exact: alpha = exp(0) = 1, update term = 0,
        # so padded steps neither move the state nor contribute output.
        pad = chunk - l % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
        y, h_final = ssd_chunked(x, dt, a_log, b, c, chunk, h0)
        return y[:, :l], h_final
    nc = l // chunk
    f32 = torch.float32

    A = -torch.exp(a_log.to(f32))                            # (H,)
    dt = dt.to(f32)
    xr = x.reshape(bsz, nc, chunk, h, p)
    br = b.reshape(bsz, nc, chunk, n).to(f32)
    cr = c.reshape(bsz, nc, chunk, n).to(f32)
    dtr = dt.reshape(bsz, nc, chunk, h)
    a = dtr * A                                              # (B,nc,Q,H) <= 0
    a_hq = a.movedim(-1, -2)                                 # (B,nc,H,Q)
    cum = torch.cumsum(a_hq, dim=-1)                         # s_t

    # ---- intra-chunk (diagonal) term ---------------------------------- #
    L = torch.exp(segsum(a_hq))                              # (B,nc,H,Q,Q)
    scores = torch.einsum("bzqn,bzkn->bzqk", cr, br)         # (B,nc,Q,Q)
    g = scores[:, :, None] * L                               # (B,nc,H,Q,Q)
    xdt = xr.to(f32) * dtr[..., None]                        # (B,nc,Q,H,P)
    y_diag = torch.einsum("bzhqk,bzkhp->bzqhp", g, xdt)

    # ---- chunk states -------------------------------------------------- #
    t = torch.exp(cum[..., -1:] - cum)                       # (B,nc,H,Q)
    s_c = torch.einsum("bzhq,bzqn,bzqhp->bzhpn", t, br, xdt)  # (B,nc,H,P,N)
    decay_chunk = torch.exp(cum[..., -1])                    # (B,nc,H)

    # ---- inter-chunk recurrence (a loop over chunks) ------------------- #
    carry = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    h_prevs = []
    for z in range(nc):
        h_prevs.append(carry)                                # emit h_prev
        carry = decay_chunk[:, z, :, None, None] * carry + s_c[:, z]
    h_prevs = torch.stack(h_prevs, dim=1)                    # (B,nc,H,P,N)

    # ---- off-diagonal (state-passing) term ------------------------------ #
    y_off = torch.einsum("bzqn,bzhq,bzhpn->bzqhp", cr, torch.exp(cum),
                         h_prevs)

    y = (y_diag + y_off).reshape(bsz, l, h, p).to(x.dtype)
    return y, carry


def ssd_decode_step(state, x, dt, a_log, b, c):
    """One-token recurrent update.

    state (B,H,P,N); x (B,H,P); dt (B,H); b/c (B,N).
    Returns (y (B,H,P) in x's dtype, new_state float32)."""
    f32 = torch.float32
    A = -torch.exp(a_log.to(f32))
    alpha = torch.exp(dt.to(f32) * A)
    upd = dt.to(f32)[..., None, None] * x.to(f32)[..., None] \
        * b.to(f32)[:, None, None, :]
    new = alpha[..., None, None] * state.to(f32) + upd
    y = torch.einsum("bhpn,bn->bhp", new, c.to(f32))
    return y.to(x.dtype), new


# --------------------------------------------------------------------- #
# full Mamba2 block (projections + causal conv + SSD + gated norm)
# --------------------------------------------------------------------- #
def _causal_conv(seq: torch.Tensor, kernel: torch.Tensor,
                 prepend: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv1d (a cross-correlation, as the reference's
    `lax.conv_general_dilated`). seq (B, L, C), kernel (W, C).
    prepend: (B, W-1, C) history (decode) or None (zero left-pad).
    Returns (B, L, C), contiguous, in seq's dtype. On DTensors each device
    convolves its own channels (and batch rows) of the whole sequence."""
    if isinstance(seq, DTensor):
        mesh = seq.device_mesh
        rows = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1
                     else p for p in seq.placements)
        taps = tuple(Shard(1) if isinstance(p, Shard) and p.dim == 2
                     else Replicate() for p in rows)
        return local_map(
            _causal_conv, out_placements=(rows,),
            in_placements=(rows, taps, None if prepend is None else rows),
            device_mesh=mesh, redistribute_inputs=True)(seq, kernel, prepend)
    w = kernel.shape[0]
    full = seq.transpose(1, 2)                               # (B, C, L)
    if prepend is None:
        full = F.pad(full, (w - 1, 0))
    else:
        full = torch.cat([prepend.to(seq.dtype).transpose(1, 2), full],
                         dim=2)
    weight = kernel.to(seq.dtype).t().unsqueeze(1)           # (C, 1, W)
    out = F.conv1d(full, weight, groups=seq.shape[2])        # (B, C, L)
    return out.transpose(1, 2).contiguous()


def mamba2_projections(h: torch.Tensor, lp, cfg: ModelConfig):
    """Shared pre-SSD computation. h: (B,L,D) -> (z, xbc, dt)."""
    z = h @ lp["w_z"]                                        # (B,L,di)
    xin = h @ lp["w_x"]                                      # (B,L,di)
    bg = h @ lp["w_b"]                                       # (B,L,G*N)
    cg = h @ lp["w_c"]                                       # (B,L,G*N)
    dt = h @ lp["w_dt"]                                      # (B,L,H)
    dt = F.softplus(dt.float() + lp["dt_bias"])
    xbc = torch.cat([xin, bg, cg], dim=-1)
    return z, xbc, dt


def _gated_out(y, z, xh, lp, cfg: ModelConfig, shape):
    """The D skip, the SiLU gate, the gated norm and the out projection."""
    y = (y + lp["d_skip"][:, None] * xh).to(xh.dtype)
    y = y.reshape(shape)
    y = rms_norm(y * F.silu(z), lp["gate_ln"], cfg.norm_eps)
    return y @ lp["w_out"]


def mamba2_block(h: torch.Tensor, lp, cfg: ModelConfig,
                 use_ref: bool = False) -> torch.Tensor:
    """Full-sequence Mamba2 block (train/prefill), plain PyTorch.
    h: (B,L,D)."""
    bsz, l, _ = h.shape
    di, n = cfg.d_inner, cfg.ssm_state
    nh, p = cfg.ssm_heads, cfg.ssm_head_dim
    hn = rms_norm(h, lp["ln"], cfg.norm_eps)
    z, xbc, dt = mamba2_projections(hn, lp, cfg)
    xbc = F.silu(_causal_conv(xbc, lp["conv"]))
    xin, bg, cg = torch.split(xbc, [di, n, n], dim=-1)
    xh = xin.reshape(bsz, l, nh, p)
    if use_ref:
        y, _ = ssd_reference(xh, dt, lp["a_log"], bg, cg)
    else:
        y, _ = ssd_chunked(xh, dt, lp["a_log"], bg, cg,
                           chunk=min(cfg.ssm_chunk, l))
    return h + _gated_out(y, z, xh, lp, cfg, (bsz, l, di))


def mamba2_block_decode(h: torch.Tensor, lp, cache: dict,
                        cfg: ModelConfig):
    """One-token Mamba2 block. h: (B,1,D); cache {conv (B,W-1,C),
    state (B,H,P,N)}. Returns (h, {conv, state}), both new tensors."""
    bsz = h.shape[0]
    di, n = cfg.d_inner, cfg.ssm_state
    nh, p = cfg.ssm_heads, cfg.ssm_head_dim
    hn = rms_norm(h, lp["ln"], cfg.norm_eps)
    z, xbc, dt = mamba2_projections(hn, lp, cfg)             # L = 1
    conv_hist = cache["conv"]
    out = F.silu(_causal_conv(xbc, lp["conv"], prepend=conv_hist))
    new_conv = torch.cat([conv_hist, xbc.to(conv_hist.dtype)], dim=1)[:, 1:]
    xin, bg, cg = torch.split(out[:, 0], [di, n, n], dim=-1)
    xh = xin.reshape(bsz, nh, p)
    y, new_state = ssd_decode_step(cache["state"], xh, dt[:, 0],
                                   lp["a_log"], bg, cg)
    return (h + _gated_out(y, z, xh, lp, cfg, (bsz, 1, di)),
            {"conv": new_conv, "state": new_state})
