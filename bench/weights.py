"""Weights from the seed, made on the device in a few large calls.

Every matrix comes from one `torch.randn` over a single buffer in the
served dtype, each parameter a view of it scaled by its own std; the
float32 per-head parameters from one `torch.rand`. The same seed on the
same device gives the same weights, so the program's set-up and the
reference, after the program is freed, each make them from the seed
alone and neither takes them from the other.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % 2**63)


def make(specs, seed: int, device) -> dict[str, torch.Tensor]:
    """{name: tensor} for `specs` of (name, shape, init, dtype name); init
    is ("normal", std), ("ones",), ("log_uniform", lo, hi): log U(lo, hi),
    ("softplus_inverse_log_uniform", lo, hi): the bias b with
    softplus(b) ~ log-uniform on [lo, hi], or ("tied", other): the very
    tensor of the parameter `other` (tied embeddings)."""
    gen = generator(seed, device)
    out = {}
    for dtype in sorted({s[3] for s in specs if s[2][0] == "normal"}):
        normal = [s for s in specs if s[2][0] == "normal" and s[3] == dtype]
        buf = torch.randn(sum(math.prod(s[1]) for s in normal),
                          generator=gen, device=device, dtype=DTYPES[dtype])
        at = 0
        for name, shape, init, _ in normal:
            n = math.prod(shape)
            out[name] = buf[at:at + n].view(shape).mul_(init[1])
            at += n
    drawn = [s for s in specs
             if s[2][0] not in ("normal", "ones", "tied")]
    u = torch.rand(sum(math.prod(s[1]) for s in drawn), generator=gen,
                   device=device, dtype=torch.float64)
    at = 0
    for name, shape, init, dtype in drawn:
        n = math.prod(shape)
        lo, hi = math.log(init[1]), math.log(init[2])
        x = torch.exp(lo + (hi - lo) * u[at:at + n].view(shape))
        at += n
        if init[0] == "log_uniform":
            out[name] = torch.log(x).to(DTYPES[dtype])
        elif init[0] == "softplus_inverse_log_uniform":
            out[name] = (x + torch.log(-torch.expm1(-x))).to(DTYPES[dtype])
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
    for name, shape, init, dtype in specs:
        if init[0] == "ones":
            out[name] = torch.ones(shape, dtype=DTYPES[dtype], device=device)
        elif init[0] == "tied":
            out[name] = out[init[1]]
    return out
