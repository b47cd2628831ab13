"""Plain PyTorch version of the ssd_scan kernel (the counterpart of
`repro.kernels.ssd_scan.ref.ssd_scan_ref`): the naive sequential
recurrence, one step per token, in float32. Beside it, `ssd_phases`
rehearses the kernel's own decomposition for the tests.

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


def ssd_phases(x, dt, a_log, b, c, *, tile, bf16_products=False):
    """The CUDA kernel's decomposition in plain PyTorch (float32), for the
    tests only: chunk states, state passing, chunk scan, at a chunk tile
    of `tile` steps, steps past the length acting as dt = 0.

    With `bf16_products` the products' operands are rounded as the
    kernel's bfloat16 instance rounds them: M = (C B^T) o L o dt once to
    bf16, S_in to bf16 for C S_in^T, and x o w as bf16 hi + lo in the
    chunk states (x, B and C enter as they are).

    Returns (y (B, L, H, P) in x's dtype, final state (B, H, P, N), and
    the scratch: {"states": (B, H, chunks, P, N) each chunk's own
    contribution, "s_last": (B, H, chunks) s at each chunk's last step,
    "s_in": (B, H, chunks, P, N) the state entering each chunk, in
    float32 after its rounding})."""
    bsz, l, h, p = x.shape
    f32 = torch.float32
    nc = -(-l // tile)
    pad = nc * tile - l

    def tiled(t):                       # (B, L, ...) -> (B, nc, Q, ...)
        t = t.to(f32)
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(bsz, nc, tile, *t.shape[2:])

    def bf16(t):
        return t.to(torch.bfloat16).to(f32)

    xs, dts, bs, cs = tiled(x), tiled(dt), tiled(b), tiled(c)
    A = -torch.exp(a_log.to(f32))
    s = torch.cumsum(dts * A, dim=2)                         # (B,nc,Q,H)
    s_last = s[:, :, -1]                                     # (B,nc,H)

    # A: S_c = (x o w)^T B, w_j = exp(s_Q - s_j) dt_j
    w = torch.exp(s_last[:, :, None] - s) * dts
    xw = xs * w[..., None]                                   # (B,nc,Q,H,P)
    if bf16_products:
        hi = bf16(xw)
        parts = (hi, bf16(xw - hi))
    else:
        parts = (xw,)
    states = sum(torch.einsum("bzqhp,bzqn->bzhpn", part, bs)
                 for part in parts)                          # (B,nc,H,P,N)

    # B: S_in[z] = exp(s_Q[z-1]) S_in[z-1] + S_c[z-1]
    run = torch.zeros_like(states[:, 0])
    s_in = []
    for z in range(nc):
        s_in.append(run)
        run = torch.exp(s_last[:, z])[..., None, None] * run + states[:, z]
    s_in = torch.stack(s_in, 1)                              # (B,nc,H,P,N)
    if bf16_products:
        s_in = bf16(s_in)

    # C: y = M x + exp(s) o (C S_in^T), M = (C B^T) o L o dt_j
    sh = s.movedim(-1, 2)                                    # (B,nc,H,Q)
    diff = sh[..., :, None] - sh[..., None, :]               # (B,nc,H,Q,Q)
    causal = torch.ones(tile, tile, dtype=torch.bool).tril()
    decay = torch.exp(torch.where(causal, diff, -torch.inf))
    cb = torch.einsum("bzin,bzjn->bzij", cs, bs)             # (B,nc,Q,Q)
    m = cb[:, :, None] * decay * dts.movedim(-1, 2)[..., None, :]
    if bf16_products:
        m = bf16(m)
    y = (torch.einsum("bzhij,bzjhp->bzihp", m, xs)
         + torch.exp(s)[..., None]
         * torch.einsum("bzin,bzhpn->bzihp", cs, s_in))
    y = y.reshape(bsz, nc * tile, h, p)[:, :l].to(x.dtype)
    scratch = {"states": states.movedim(1, 2), "s_last": s_last.movedim(1, 2),
               "s_in": s_in.movedim(1, 2)}
    return y, run, scratch
