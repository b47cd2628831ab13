"""The Mamba2 family (arXiv:2405.21060): its parameters, its work and its
plain float32 forward pass.

Each layer, with h the residual stream (S, d) and RMSNorm n(.):

    x0 = n(h; ln)
    z = x0 Wz;  xBC = [x0 Wx, x0 WB, x0 WC];  dt = softplus(x0 Wdt + dt_bias)
    xBC = silu(causal depthwise conv over time, taps conv (W, C))
    x, B, C = split(xBC)                  x as (S, H, P); B, C (S, N)
    per head:  s_t = exp(dt_t A) s_{t-1} + dt_t x_t B_t^T,  A = -exp(a_log)
               y_t = s_t C_t + D x_t
    h += n(y * silu(z); gate_ln) Wout
    logits = n(h; final_ln) Unembed^T

The scan is computed in its chunked (state-space dual) form, the paper's
Listing 1: within a chunk of Q steps the quadratic form with the decay
mask L = exp(segsum(dt A)), across chunks the recurrence on the chunk
states. The published model ties its embeddings (so does the benchmark:
one tensor for both tables), keeps its residual stream in float32 and
has a conv bias; the program under test keeps the residual in bfloat16
and has no conv bias, which the config file lists in `reduced` (the
reference computes in float32 throughout; with no bias it computes the
program's layer). Parameter names follow the program's state dict so the
benchmark can hand one set of weights to both; nothing here imports the
program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.common import rms_norm

CHUNK = 256           # steps per chunk of the reference's own scan
#: the tests' smoke size: two layers at the published hidden size
SMOKE = dict(n_layer=2, d_state=32, headdim=32, vocab_size=1000,
             chunk_size=32)


def dims(c: dict) -> dict:
    d, di = c["d_model"], c["expand"] * c["d_model"]
    return {"d": d, "di": di, "layers": c["n_layer"], "n": c["d_state"],
            "p": c["headdim"], "heads": di // c["headdim"],
            "w": c["d_conv"], "vocab": c["vocab_size"]}


def port_config(c: dict) -> dict:
    """Keyword arguments of the program's `ModelConfig` for this file."""
    m = dims(c)
    return {"name": c["name"], "family": "ssm", "num_layers": m["layers"],
            "d_model": m["d"], "num_heads": 0, "num_kv_heads": 0, "d_ff": 0,
            "vocab_size": m["vocab"], "attn_type": "none",
            "ssm_state": m["n"], "ssm_head_dim": m["p"],
            "ssm_expand": c["expand"], "ssm_groups": c["ngroups"],
            "ssm_conv_width": m["w"], "ssm_chunk": c["chunk_size"],
            "norm_eps": float(c["rms_norm_eps"]),
            "dtype": c["torch_dtype"]}


def layer_shapes(c: dict) -> dict:
    """{name: shape} of one layer's projection matrices."""
    m = dims(c)
    d = m["d"]
    return {"w_z": (d, m["di"]), "w_x": (d, m["di"]), "w_b": (d, m["n"]),
            "w_c": (d, m["n"]), "w_dt": (d, m["heads"]),
            "w_out": (m["di"], d)}


def param_specs(c: dict, padded_vocab: int) -> list[tuple]:
    """(name, shape, init, dtype name) of every parameter. A ~ U(1, 16)
    and dt ~ logU(0.001, 0.1) as the paper initialises them; with
    `tie_embeddings` the output table is the input table's tensor (the
    program keeps two parameters; both are given the one tensor)."""
    m, dt = dims(c), c["torch_dtype"]
    unembed = ("tied", "embed") if c["tie_embeddings"] else ("normal", 0.02)
    specs = [("embed", (padded_vocab, m["d"]), ("normal", 0.02), dt),
             ("unembed", (padded_vocab, m["d"]), unembed, dt),
             ("final_ln", (m["d"],), ("ones",), dt)]
    for i in range(m["layers"]):
        p = f"layers.{i}."
        specs += [(p + n, s, ("normal", 0.02), dt)
                  for n, s in layer_shapes(c).items()]
        specs += [(p + "conv", (m["w"], m["di"] + 2 * m["n"]),
                   ("normal", 0.2), dt),
                  (p + "ln", (m["d"],), ("ones",), dt),
                  (p + "gate_ln", (m["di"],), ("ones",), dt),
                  (p + "a_log", (m["heads"],), ("log_uniform", 1.0, 16.0),
                   "float32"),
                  (p + "dt_bias", (m["heads"],),
                   ("softplus_inverse_log_uniform", 0.001, 0.1), "float32"),
                  (p + "d_skip", (m["heads"],), ("ones",), "float32")]
    return specs


# ------------------------------ work -------------------------------- #
def layer_weight_flops(c: dict) -> float:
    """2 x the parameters one token passes through in all layers (the
    projections, the out projection and the conv taps)."""
    m = dims(c)
    per = sum(a * b for a, b in layer_shapes(c).values()) \
        + m["w"] * (m["di"] + 2 * m["n"])
    return 2.0 * per * m["layers"]


def head_flops(c: dict) -> float:
    m = dims(c)
    return 2.0 * m["d"] * m["vocab"]


def mixing_flops(c: dict, visible: float) -> float:
    """The recurrence of one token in all layers: per head, the state's
    decay, the input's outer product and its add (3 P N), the read-out
    (2 P N); independent of the positions before it."""
    m = dims(c)
    return 5.0 * m["heads"] * m["p"] * m["n"] * m["layers"]


def attention_shape(c: dict):
    return None


def ssd_shape(c: dict) -> dict:
    m = dims(c)
    return {"layers": m["layers"], "heads": m["heads"], "p": m["p"],
            "n": m["n"]}


# ----------------------------- forward ------------------------------ #
def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q): sum of a over (j, i] below the diagonal,
    -inf above it."""
    q = a.shape[-1]
    x = a[..., None].expand(*a.shape, q)                     # x[..., i, j]=a_i
    low = torch.tril(torch.ones(q, q, dtype=torch.bool, device=a.device),
                     -1)
    x = x.masked_fill(~low, 0).cumsum(-2)
    keep = torch.tril(torch.ones(q, q, dtype=torch.bool, device=a.device))
    return x.masked_fill(~keep, float("-inf"))


def ssd(x, dt, a, b, c, chunk: int = CHUNK):
    """Chunked scan from a zero state: x (S, H, P), dt (S, H), a (H,)
    (A, negative), b and c (S, N); returns y (S, H, P) without D, and the
    state after the last step (H, P, N)."""
    s, h, p = x.shape
    pad = (-s) % chunk
    if pad:   # dt = 0 adds nothing and keeps the state
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        b, c = F.pad(b, (0, 0, 0, pad)), F.pad(c, (0, 0, 0, pad))
    nc = x.shape[0] // chunk
    xd = (x * dt[..., None]).view(nc, chunk, h, p)
    ad = (dt * a).view(nc, chunk, h).permute(2, 0, 1)      # (H, nc, Q)
    b, c = b.view(nc, chunk, -1), c.view(nc, chunk, -1)
    cum = ad.cumsum(-1)
    # within chunks
    lmask = torch.exp(_segsum(ad))                          # (H, nc, Q, Q)
    cb = torch.einsum("zin,zjn->zij", c, b)                 # (nc, Q, Q)
    y = torch.einsum("zij,hzij,zjhp->zihp", cb, lmask, xd)
    # each chunk's state, then the recurrence across chunks
    decay_in = torch.exp(cum[..., -1:] - cum)               # (H, nc, Q)
    states = torch.einsum("zjn,hzj,zjhp->zhpn", b, decay_in, xd)
    chunk_decay = torch.exp(cum[..., -1]).T                 # (nc, H)
    carry = torch.zeros_like(states[0])
    before = []
    for z in range(nc):
        before.append(carry)
        carry = chunk_decay[z][:, None, None] * carry + states[z]
    before = torch.stack(before)                            # (nc, H, P, N)
    y = y + torch.einsum("zin,hzi,zhpn->zihp", c, torch.exp(cum), before)
    return y.reshape(nc * chunk, h, p)[:s], carry


def logits(w: dict, c: dict, tokens: torch.Tensor, first: int,
           gemm) -> torch.Tensor:
    """float32 logits (S - first, vocab) at positions first .. S-1 of
    `tokens` (S,), each predicting the token after it; weights `w` by the
    program's names in any dtype (used in float32); products by `gemm`."""
    return forward(w, c, tokens, first, gemm)[0]


@torch.no_grad()
def forward(w: dict, c: dict, tokens: torch.Tensor, first: int, gemm,
            state: bool = False):
    """(`logits`, and with `state` the decode cache after `tokens`:
    {"conv": (layers, W - 1, C), the last W - 1 rows of the conv's input
    (zeros before a shorter sequence), "state": (layers, H, P, N)}, float32;
    else None)."""
    m, eps = dims(c), float(c["rms_norm_eps"])
    s = tokens.shape[0]
    di, n, hh, pp, width = m["di"], m["n"], m["heads"], m["p"], m["w"]
    h = w["embed"][tokens].float()
    convs, states = [], []
    for i in range(m["layers"]):
        def g(name):
            return w[f"layers.{i}.{name}"].float()
        x0 = rms_norm(h, g("ln"), eps)
        z = gemm(x0, g("w_z"))
        xbc = torch.cat([gemm(x0, g("w_x")), gemm(x0, g("w_b")),
                         gemm(x0, g("w_c"))], -1)           # (S, C)
        dt = F.softplus(gemm(x0, g("w_dt")) + g("dt_bias"))
        taps = g("conv")                                    # (W, C)
        padded = F.pad(xbc, (0, 0, width - 1, 0))
        if state:
            convs.append(padded[-(width - 1):])
        conv = sum(taps[k] * padded[k:k + s] for k in range(width))
        xbc = F.silu(conv)
        xs, bs, cs = xbc.split([di, n, n], -1)
        xs = xs.view(s, hh, pp)
        y, last = ssd(xs, dt, -torch.exp(g("a_log")), bs, cs)
        if state:
            states.append(last)
        y = y + g("d_skip")[:, None] * xs
        y = rms_norm(y.reshape(s, di) * F.silu(z), g("gate_ln"), eps)
        h = h + gemm(y, g("w_out"))
    hn = rms_norm(h[first:], w["final_ln"].float(), eps)
    out = gemm(hn, w["unembed"][:m["vocab"]].float().T)
    if not state:
        return out, None
    return out, {"conv": torch.stack(convs), "state": torch.stack(states)}


def state_gap(program: dict, ref: dict, prompt: int, rows: int) -> float:
    """The widest relative gap of one slot's cache as the program left
    it against the reference's after the same `rows` tokens: ||p - r|| /
    ||r|| of each head's SSD state (P, N) in each layer, and of each
    layer's conv history. Each head apart, so that the heads that decay
    fast, whose state a lost step changes most, are not drowned by the
    slow ones."""
    ps, rs = program["state"].float(), ref["state"]
    heads = (ps - rs).flatten(2).norm(dim=2) / \
        rs.flatten(2).norm(dim=2).clamp_min(1e-30)
    pc, rc = program["conv"].float(), ref["conv"]
    conv = (pc - rc).flatten(1).norm(dim=1) / \
        rc.flatten(1).norm(dim=1).clamp_min(1e-30)
    return max(float(heads.max()), float(conv.max()))
