"""Plain PyTorch version of the ssd_scan kernel (the counterpart of
`repro.kernels.ssd_scan.ref.ssd_scan_ref`): the naive sequential
recurrence, one step per token, in float32.

The recurrence itself, `ssd_reference`, lives here and not in
`models/mamba2.py` (which re-exports it), so that the kernel package
imports nothing of `repro_torch.models`.
"""
from __future__ import annotations

import torch


def ssd_reference(x, dt, a_log, b, c, h0=None):
    """Naive sequential recurrence oracle (float32).

    x (B, L, H, P); dt (B, L, H); a_log (H,); b/c (B, L, N); h0
    (B, H, P, N) or None (zeros). Per head, with A = -exp(a_log):
        h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t.
    Returns (y (B, L, H, P) in x's dtype, final state (B, H, P, N)
    float32)."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    f32 = torch.float32
    A = -torch.exp(a_log.to(f32))
    state = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    xs, dts, bs, cs = x.to(f32), dt.to(f32), b.to(f32), c.to(f32)
    ys = []
    for t in range(l):
        xt, dtt, bt, ct = xs[:, t], dts[:, t], bs[:, t], cs[:, t]
        alpha = torch.exp(dtt * A)                            # (B, H)
        upd = (dtt[..., None, None] * xt[..., None]
               * bt[:, None, None, :])                        # (B, H, P, N)
        state = alpha[..., None, None] * state + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, ct))
    y = (torch.stack(ys, 1) if ys
         else torch.zeros((bsz, 0, h, p), dtype=f32, device=x.device))
    return y.to(x.dtype), state


def ssd_scan_ref(x, dt, a_log, b, c, *, return_state=False):
    """Same contract as the kernel: y (B, L, H, P) in x's dtype, and with
    `return_state` also the final state (B, H, P, N) float32."""
    y, state = ssd_reference(x, dt, a_log, b, c)
    return (y, state) if return_state else y
