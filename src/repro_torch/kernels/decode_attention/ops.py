"""Public wrapper of the decode_attention kernel (the counterpart of
`repro.kernels.decode_attention.ops.decode_bhd`).

On CUDA tensors it launches the hand-written split-KV kernel
(`decode_attention.cu`: one launch, which also merges the slices) on the
current stream; on CPU tensors, or with `use_kernel=False`, it runs the
plain PyTorch version (`ref.py`). There is no other fallback: any other
device, dtype, pair of head dims or layout raises; the instances are B2's
(`flash_attention.ops.HEAD_DIMS`: equal q/k and v head dims of 32, 64,
128 or Zamba2's 112, and MLA's 96 with 64). `pos` stays on the device:
nothing on the path reads it back to the host.

The kernel's last CTA of each (sequence, cache head) merges the slices; it
finds out that it is last from a ticket counter in `counters(device, n)`,
an int32 buffer kept per device, zeroed once when it is made and reset to
0 by the kernel itself. The buffer assumes one stream at a time: two
launches in flight at once on two streams of one device would share
tickets.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref_explicit)
from repro_torch.kernels.flash_attention.ops import (DTYPES, _aligned,
                                                     check_head_dims,
                                                     check_instance)

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = CudaKernel(
    "decode_attention", Path(__file__).with_name("decode_attention.cu"),
    "decode_attention_launch",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.POINTER(ctypes.c_int64), _I,
     _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P])

MAX_GROUPS = 16      # query heads per cache head the kernel holds
SMS = 132            # streaming multiprocessors of an H100 SXM
WAVES = 2            # CTAs per SM that the slices may fill
SLICE_KEYS = 128     # fewest cache rows per slice
MAX_SPLITS = 64      # most slices the kernel merges (kMaxSplits)

_COUNTERS: dict[torch.device, torch.Tensor] = {}


def n_splits(batch: int, n_kv_heads: int, max_len: int) -> int:
    """Slices per (sequence, cache head): the most that keep the grid
    within WAVES CTAs per SM, with at least SLICE_KEYS rows of the cache
    per slice and at most MAX_SPLITS; at least one."""
    want = WAVES * SMS // max(batch * n_kv_heads, 1)
    return max(1, min(want, max_len // SLICE_KEYS, MAX_SPLITS))


def counters(device, n: int) -> torch.Tensor:
    """The kernel's int32 ticket counters on `device`, at least `n` of
    them: made zeroed once, replaced by a zeroed buffer twice as large
    when a call needs more, and kept. The kernel leaves them at 0, so no
    call zeroes them (that would be a second launch per call) and a CUDA
    graph may replay the kernel."""
    device = torch.device(device)
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        size = max(n, 2 * buf.numel() if buf is not None else n)
        buf = torch.zeros(size, dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def _check(q, k_cache, v_cache) -> None:
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"decode_bhd: {name} must be a tensor, got "
                            f"{type(t).__name__}")
        if t.device != q.device:
            raise ValueError(f"decode_bhd: {name} is on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"decode_bhd: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"decode_bhd: q must be (B, H, D) and the caches "
                         f"(B, S, Hkv, D), got {tuple(q.shape)} and "
                         f"{tuple(k_cache.shape)}")
    b, h, d = q.shape
    if (k_cache.shape[:3] != v_cache.shape[:3] or k_cache.shape[0] != b
            or k_cache.shape[3] != d):
        raise ValueError(f"decode_bhd: caches {tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if q.device.type != "cpu":
        check_head_dims("decode_bhd", d, v_cache.shape[3])
    if k_cache.shape[2] == 0 or h % k_cache.shape[2]:
        raise ValueError(f"decode_bhd: {h} query heads do not group over "
                         f"{k_cache.shape[2]} cache heads")


def _positions(pos, batch: int, device) -> torch.Tensor:
    """`pos` (int, 0-d or (B,)) as a contiguous (B,) int32 tensor on
    `device`, without a host round trip."""
    pos = torch.as_tensor(pos, device=device).to(torch.int32)
    if pos.dim() == 0:
        pos = pos.expand(batch)
    if pos.shape != (batch,):
        raise ValueError(f"decode_bhd: pos must be () or ({batch},), got "
                         f"{tuple(pos.shape)}")
    return pos.contiguous()


def launch(q, k_cache, v_cache, pos, out, *, window, scale, stream) -> int:
    """Launch the kernel on `stream` for checked tensors; returns the CUDA
    error code (0: accepted)."""
    b, h, d = q.shape
    s, hkv, dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    split = n_splits(b, hkv, s)
    parts = b * hkv * split * (h // hkv)
    work = torch.empty(parts * (dv + 2), dtype=torch.float32,
                       device=q.device)
    acc, m, l = work[:parts * dv], work[parts * dv:parts * (dv + 1)], \
        work[parts * (dv + 1):]
    tickets = counters(q.device, b * hkv)
    strides = (ctypes.c_int64 * 10)(
        *q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3],
        *out.stride()[:2])
    return KERNEL.function()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), tickets.data_ptr(),
        out.data_ptr(), strides,
        b, h, hkv, s, d, dv, DTYPES[q.dtype], window, split, scale, stream)


def decode_bhd(q, k_cache, v_cache, pos, *, window=0, use_kernel=True,
               scale=None):
    """q: (B, H, D); k_cache (B, S, Hkv, D), v_cache (B, S, Hkv, Dv); pos
    () or (B,) valid lengths (the current token already written at
    pos - 1). Returns (B, H, Dv) in q's dtype; Dv may differ from D (MLA):
    on CPU tensors for any pair, on CUDA for the kernel's instances.
    `scale` defaults to D ** -0.5 (Python double, rounded to float32 by
    the kernel)."""
    _check(q, k_cache, v_cache)
    b, h, d = q.shape
    pos = _positions(pos, b, q.device)
    scale = d ** -0.5 if scale is None else scale
    if not use_kernel or q.device.type == "cpu":
        return decode_attention_ref_explicit(q, k_cache, v_cache, pos,
                                             window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_bhd: no kernel for device {q.device}")
    check_instance("decode_bhd", q.dtype, d, v_cache.shape[3])
    if h // k_cache.shape[2] > MAX_GROUPS:
        raise ValueError(f"decode_bhd: the kernel holds at most "
                         f"{MAX_GROUPS} query heads per cache head, got "
                         f"{h // k_cache.shape[2]}")
    q, k_cache, v_cache = _aligned(q), _aligned(k_cache), _aligned(v_cache)
    out = torch.empty((b, h, v_cache.shape[3]), dtype=q.dtype,
                      device=q.device)
    with torch.cuda.device(q.device):
        err = launch(q, k_cache, v_cache, pos, out, window=window,
                     scale=scale,
                     stream=torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    KERNEL.launches += 1
    return out
