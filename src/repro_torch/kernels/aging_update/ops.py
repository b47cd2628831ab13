"""Public wrapper of the aging_update kernel (the counterpart of
`repro.kernels.aging_update.ops.advance_fleet`).

On CUDA tensors it launches the hand-written kernel (`aging_update.cu`)
on the current stream; on CPU tensors it runs the plain PyTorch version
(`ref.py`). There is no other fallback: any other device, dtype or
layout raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.aging_update.ref import aging_update_ref

_P, _F = ctypes.c_void_p, ctypes.c_float

KERNEL = CudaKernel(
    "aging_update", Path(__file__).with_name("aging_update.cu"),
    "aging_update_launch",
    [_P, _P, _P, _P, _P, ctypes.c_int64, _F, _F, _F, _F, _F, _F, _P])


def _check(tensors) -> None:
    names = ("dvth", "temp_c", "stress", "tau")
    first = tensors[0]
    for name, t in zip(names, tensors):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"advance_fleet: {name} must be a tensor, "
                            f"got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"advance_fleet: {name} must be float32, "
                            f"got {t.dtype}")
        if t.dim() != 1 or t.shape != first.shape:
            raise ValueError(f"advance_fleet: inputs must be 1-D of one "
                             f"length; {name} has shape "
                             f"{tuple(t.shape)}, dvth "
                             f"{tuple(first.shape)}")
        if t.device != first.device:
            raise ValueError(f"advance_fleet: {name} is on {t.device}, "
                             f"dvth on {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"advance_fleet: {name} must be contiguous")


def advance_fleet(dvth, temp_c, stress, tau, params):
    """Advance a fleet of cores' dVth (the paper's Eq. 2 recursion).

    All inputs are (N,) contiguous float32 tensors on one device; returns
    a new (N,) float32 tensor there. `params` is an `AgingParams`.
    """
    _check((dvth, temp_c, stress, tau))
    if dvth.device.type == "cpu":
        return aging_update_ref(dvth, temp_c, stress, tau, params)
    if dvth.device.type != "cuda":
        raise ValueError(f"advance_fleet: no kernel for device "
                         f"{dvth.device}")
    out = torch.empty_like(dvth)
    n = dvth.numel()
    if n == 0:
        return out
    fn = KERNEL.function()
    with torch.cuda.device(dvth.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(dvth.data_ptr(), temp_c.data_ptr(), stress.data_ptr(),
                 tau.data_ptr(), out.data_ptr(), n, params.n,
                 1.0 / params.n, params.K, -params.E0, params.kB,
                 params.c_field * params.vdd, stream)
    if err != 0:
        raise RuntimeError(f"aging_update launch failed: CUDA error {err}")
    KERNEL.launches += 1
    return out
