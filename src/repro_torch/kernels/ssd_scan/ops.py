"""Public wrapper of the ssd_scan kernel (the counterpart of
`repro.kernels.ssd_scan.ops.ssd`).

On CUDA tensors it launches the hand-written kernel (`ssd_scan.cu`) on
the current stream; on CPU tensors, or with `use_kernel=False`, it runs
the plain PyTorch version (`ref.py`, the sequential recurrence). There is
no other fallback: any other device, dtype, P, N or layout raises. The
kernel masks the sequence by length, so nothing is padded, and reads x, b
and c through their strides (slices of one packed tensor are read in
place); only a last axis of stride other than 1 is copied.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = CudaKernel(
    "ssd_scan", Path(__file__).with_name("ssd_scan.cu"), "ssd_scan_launch",
    [_P, _P, _P, _P, _P, _P, _P, ctypes.POINTER(ctypes.c_int64), _I, _I, _I,
     _I, _I, _I, _P])

HEAD_DIMS = (32, 64)           # P
STATE_DIMS = (32, 64, 128)     # N
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, dt, a_log, b, c) -> None:
    for name, t in (("x", x), ("dt", dt), ("a_log", a_log), ("b", b),
                    ("c", c)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"ssd: {name} must be a tensor, got "
                            f"{type(t).__name__}")
        if t.device != x.device:
            raise ValueError(f"ssd: {name} is on {t.device}, x on "
                             f"{x.device}")
    if x.dim() != 4:
        raise ValueError(f"ssd: x must be (B, L, H, P), got shape "
                         f"{tuple(x.shape)}")
    bsz, l, h, _ = x.shape
    if dt.shape != (bsz, l, h) or a_log.shape != (h,):
        raise ValueError(f"ssd: dt {tuple(dt.shape)} and a_log "
                         f"{tuple(a_log.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    if b.dim() != 3 or b.shape[:2] != (bsz, l) or c.shape != b.shape:
        raise ValueError(f"ssd: b {tuple(b.shape)} and c {tuple(c.shape)} "
                         f"must be (B, L, N) and fit x {tuple(x.shape)}")


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    """`t` itself if its last axis has stride 1, else a contiguous copy."""
    return t if t.stride(-1) == 1 or t.shape[-1] == 1 else t.contiguous()


def launch(x, dt, a_log, b, c, y, state, *, stream) -> int:
    """Launch the kernel on `stream` for checked tensors (`state` may be
    None); returns the CUDA error code (0: accepted)."""
    bsz, l, h, p = x.shape
    strides = (ctypes.c_int64 * 13)(
        *x.stride()[:3], *dt.stride(), *b.stride()[:2], *c.stride()[:2],
        *y.stride()[:3])
    return KERNEL.function()(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), 0 if state is None else state.data_ptr(),
        strides, bsz, l, h, p, b.shape[-1], DTYPES[x.dtype], stream)


def ssd(x, dt, a_log, b, c, *, chunk=256, use_kernel=True,
        return_state=False):
    """Chunked SSD. x (B, L, H, P), dt (B, L, H), a_log (H,), b/c
    (B, L, N), b and c shared by every head. Returns y (B, L, H, P) in x's
    dtype, and with `return_state` also the final state (B, H, P, N)
    float32.

    `chunk` is the Pallas kernel's chunk length, kept for the reference's
    signature: the CUDA kernel tiles the sequence in chunks of 64 steps
    whatever it is (the chunked algebra is exact for any chunk length),
    and the plain version has no chunks.
    """
    _check(x, dt, a_log, b, c)
    if chunk < 1:
        raise ValueError(f"ssd: chunk must be positive, got {chunk}")
    if not use_kernel or x.device.type == "cpu":
        return ssd_scan_ref(x, dt, a_log, b, c, return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {x.device}")
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    if (x.dtype not in DTYPES or b.dtype != x.dtype or c.dtype != x.dtype
            or dt.dtype != torch.float32 or a_log.dtype != torch.float32):
        raise TypeError(f"ssd: the kernel takes x, b and c of one dtype, "
                        f"float32 or bfloat16, with dt and a_log float32; "
                        f"got x {x.dtype}, b {b.dtype}, c {c.dtype}, dt "
                        f"{dt.dtype}, a_log {a_log.dtype}")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"ssd: the kernel takes P in {HEAD_DIMS} and N in "
                         f"{STATE_DIMS}, got P {p}, N {n}")
    x, b, c = _unit_last(x), _unit_last(b), _unit_last(c)
    a_log = a_log.contiguous()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    state = (torch.empty((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if return_state else None)
    with torch.cuda.device(x.device):
        err = launch(x, dt, a_log, b, c, y, state,
                     stream=torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    KERNEL.launches += 1
    return (y, state) if return_state else y
