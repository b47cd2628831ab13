"""Public wrapper of the flash_attention kernel (the counterpart of
`repro.kernels.flash_attention.ops.attention_bhsd`).

On CUDA tensors it launches the hand-written kernel
(`flash_attention.cu`) on the current stream; on CPU tensors, or with
`use_kernel=False`, it runs the plain PyTorch version (`ref.py`). There is
no other fallback: any other device, dtype, pair of head dims or layout
raises. The instances take a q/k head dim equal to v's (32, 64, 128 and
Zamba2's 112) and MLA's 96 with a v head dim of 64 (`HEAD_DIMS`).
The C entry point holds two kernels and picks one by dtype: bfloat16 runs
on the tensor cores (wgmma, with Q, K and V copied by TMA through tensor
maps that this wrapper describes per call, `tensor_map_geometry`);
float32 runs on the CUDA cores in float32 FMAs, since TF32 or bf16
products cannot meet the reference's float32 tolerance. Both read the
model's (B, S, H, D) layout through its strides and mask keys by length,
so nothing is padded, sliced or transposed.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = CudaKernel(
    "flash_attention", Path(__file__).with_name("flash_attention.cu"),
    "flash_attention_launch",
    [_P, _P, _P, _P, ctypes.POINTER(ctypes.c_int64),
     ctypes.POINTER(ctypes.c_int64), _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
     _I, ctypes.c_float, _P])

#: (q/k head dim, v head dim) of the kernels' instances (and of B3's):
#: equal dims, MLA's 96 / 64 (MiniCPM3) and Zamba2's 112
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (96, 64), (112, 112))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: rows of the bfloat16 kernel's query tile and key tile (kTcBQ, kTcBK)
BLOCK_Q, BLOCK_KV = 128, 64


def tensor_map_geometry(t: torch.Tensor, rows: int) -> tuple[int, ...]:
    """The 11 numbers of the TMA tensor map over a (B, S, H, D) tensor
    whose tiles are `rows` sequence positions of one head: the dims
    innermost first (D, H, S, B) in elements; the byte strides of H, S
    and B; the box (columns, 1, rows, 1), whose columns span one swizzle
    row: 128 bytes where that divides the row, the whole row where it is
    shorter, else 64 bytes where that divides it (MLA's q and k rows of
    96 bf16 values: three boxes of 32 columns), else 128 bytes over boxes
    that reach past the row (Zamba2's rows of 112: two boxes of 64
    columns, the tensor map's D staying 112, so that TMA fills columns
    112 to 127 of the tile with zeros). Each tensor gets its own D, so
    v's may differ from q's. A dim of size 1 gets the stride it would
    have in a packed tensor: its coordinate is always 0, and the tensor
    map wants 16-byte multiples."""
    b, s, h, d = t.shape
    size = t.element_size()
    strides = [t.stride(2) * size, t.stride(1) * size, t.stride(0) * size]
    inner = d * size
    for i, n in enumerate((h, s, b)):
        if n == 1:
            strides[i] = inner
        inner = strides[i] * n
    row = d * size
    swizzle = 128 if row % 128 == 0 else row if row < 128 else \
        64 if row % 64 == 0 else 128
    return (d, h, s, b, *strides, swizzle // size, 1, rows, 1)


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"attention_bhsd: {name} must be a tensor, got "
                            f"{type(t).__name__}")
        if t.dim() != 4:
            raise ValueError(f"attention_bhsd: {name} must be (B, S, H, "
                             f"D), got shape {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"attention_bhsd: {name} is on {t.device}, q "
                             f"on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"attention_bhsd: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
    b, _, h, d = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"attention_bhsd: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if q.device.type != "cpu":
        check_head_dims("attention_bhsd", d, v.shape[3])
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"attention_bhsd: {h} query heads do not group "
                         f"over {k.shape[2]} KV heads")


def check_head_dims(fn: str, d: int, dv: int) -> None:
    """Off the CPU, raise ValueError for a v head dim other than q's
    unless (d, dv) is an instance (`HEAD_DIMS`): there is no plain route
    for it there. Equal dims outside the instances are refused where the
    kernel is chosen."""
    if dv != d and (d, dv) not in HEAD_DIMS:
        raise ValueError(f"{fn}: q/k head dim {d} with v head dim {dv} is "
                         f"no instance of the kernel (instances: "
                         f"{HEAD_DIMS}), and there is no plain route off "
                         f"the CPU")


def check_instance(fn: str, dtype: torch.dtype, d: int, dv: int) -> None:
    """Raise ValueError unless the kernel has an instance for `dtype` and
    the pair of head dims (d, dv)."""
    if dtype in DTYPES and (d, dv) in HEAD_DIMS:
        return
    raise ValueError(f"{fn}: the kernel takes float32 or bfloat16 with "
                     f"(q/k, v) head dims in {HEAD_DIMS}, got {dtype}, "
                     f"({d}, {dv})")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` itself if the kernel's 16-byte row loads and TMA copies may
    read it in place (unit stride on head_dim, rows and base 16-byte
    aligned), else a contiguous copy."""
    vec = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:-1])):
        return t
    return t.contiguous()


def launch(q, k, v, out, *, causal, window, scale, q_offset, stream) -> int:
    """Launch the kernel on `stream` for checked (B, S, H, D) tensors;
    returns the CUDA error code (0: accepted)."""
    b, sq, h, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3])
    geometry = None
    if q.dtype == torch.bfloat16:
        geometry = (ctypes.c_int64 * 33)(
            *tensor_map_geometry(q, BLOCK_Q),
            *tensor_map_geometry(k, BLOCK_KV),
            *tensor_map_geometry(v, BLOCK_KV))
    return KERNEL.function()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        geometry, b, h, hkv, sq, skv, d, dv, DTYPES[q.dtype], q_offset,
        int(causal), window, scale, stream)


def attention_bhsd(q, k, v, *, causal=True, window=0, use_kernel=True,
                   scale=None, q_offset=0):
    """Flash attention in (B, S, H, D) model layout. GQA-aware.

    q: (B, Sq, H, D); k: (B, Skv, Hkv, D); v: (B, Skv, Hkv, Dv) with
    H % Hkv == 0. Returns (B, Sq, H, Dv) in q's dtype. Dv may differ from
    D (MLA): on CPU tensors for any pair, on CUDA for the instances
    (`HEAD_DIMS`). `scale` defaults to D ** -0.5, formed in Python double
    and rounded to float32, as the reference forms it.
    """
    _check(q, k, v)
    d = q.shape[3]
    scale = d ** -0.5 if scale is None else scale
    if not use_kernel or q.device.type == "cpu":
        out = flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, scale=scale, q_offset=q_offset)
        return out.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bhsd: no kernel for device {q.device}")
    check_instance("attention_bhsd", q.dtype, d, v.shape[3])
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((*q.shape[:3], v.shape[3]), dtype=q.dtype,
                      device=q.device)
    with torch.cuda.device(q.device):
        err = launch(q, k, v, out, causal=causal, window=window,
                     scale=scale, q_offset=q_offset,
                     stream=torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err}")
    KERNEL.launches += 1
    if not causal:
        KERNEL.variant_launches["noncausal"] += 1
    return out
