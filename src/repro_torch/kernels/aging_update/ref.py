"""Plain PyTorch version of the aging_update kernel (the counterpart of
`repro.kernels.aging_update.ref.aging_update_ref`).

Float32, in the reference's order of operations. A Python scalar
divided by a tensor would run as reciprocal-then-multiply in PyTorch, so
the two scalar numerators are materialized as float32 tensors and
divided elementwise, as jnp does.
"""
from __future__ import annotations

import torch


def aging_update_ref(dvth, temp_c, stress, tau, params):
    """Advance every core's dVth by `tau` seconds; inputs (N,) float32
    tensors on one device, `params` an `AgingParams`. Returns (N,)."""
    dvth = dvth.to(torch.float32)
    t_k = temp_c.to(torch.float32) + 273.15
    kbt = params.kB * t_k
    adf = (params.K * torch.exp(torch.full_like(t_k, -params.E0) / kbt)
           * torch.exp(torch.full_like(t_k, params.c_field * params.vdd)
                       / kbt)
           * torch.where(stress > 0, stress, 1.0) ** params.n)
    live = (stress > 0) & (tau > 0)
    safe = torch.where(live, adf, 1.0)
    eff_t = (dvth / safe) ** (1.0 / params.n)
    new = safe * (eff_t + tau) ** params.n
    return torch.where(live, new, dvth)
