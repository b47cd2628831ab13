"""Public wrapper of the ssd_scan kernel (the counterpart of
`repro.kernels.ssd_scan.ops.ssd`).

On CUDA tensors it launches the hand-written kernel (`ssd_scan.cu`) on
the current stream; on CPU tensors, or with `use_kernel=False`, it runs
the plain PyTorch version (`ref.py`, the sequential recurrence). There is
no other fallback: any other device, dtype, P, N or layout raises. The
kernel masks the sequence by length, so nothing is padded, and reads x, b
and c through their strides (slices of one packed tensor are read in
place); only a last axis of stride other than 1 is copied.

One call makes three launches on the device (chunk states, state
passing, chunk scan; `Plan.device_launches`) and counts once in
`KERNEL.launches`. `plan` sizes them: the chunk tile of the dtype's
instance, the heads each CTA takes, the grids, and the one allocation
that holds y and the scratch of chunk states. The C entry point takes its
arguments packed in one buffer: the pointers of the call, then the
strides and sizes, packed once per plan and layout (`_layout_args`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import struct
from pathlib import Path

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

KERNEL = CudaKernel(
    "ssd_scan", Path(__file__).with_name("ssd_scan.cu"), "ssd_scan_launch",
    [ctypes.c_char_p, ctypes.c_void_p])
#: `Args` of ssd_scan.cu: ten pointers (x, dt, a_log, b, c, y, state,
#: states, s_last, s_in), `vec` and four bytes of padding; then 13 int64
#: strides and eight int32 (batch, len, heads, P, N, dtype, tile, group)
_POINTERS = struct.Struct("=10Qi4x")
_LAYOUT = struct.Struct("=13q8i")

HEAD_DIMS = (32, 64)           # P
STATE_DIMS = (32, 64, 128)     # N
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: steps per chunk tile of each instance (`kQf`, `kQtc` in ssd_scan.cu)
TILES = {torch.float32: 64, torch.bfloat16: 128}
MAX_GROUP = 8                  # heads per CTA of phases A and C (`kMaxGroup`)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one `ssd` call runs on the card."""

    batch: int
    length: int
    heads: int
    head_dim: int
    state_dim: int
    dtype: torch.dtype
    tile: int       # steps per chunk
    group: int      # heads per CTA of the chunk-state and chunk-scan phases

    @property
    def chunks(self) -> int:
        return -(-self.length // self.tile)

    @property
    def grid(self) -> tuple[int, int, int]:
        """(chunk, head group, row): the grid of phases A and C."""
        return self.chunks, -(-self.heads // self.group), self.batch

    @property
    def device_launches(self) -> int:
        return 3 if self.length and self.batch and self.heads else 0

    def scratch_shapes(self) -> dict:
        """name -> (shape, dtype) of the scratch each call allocates."""
        b, h, c = self.batch, self.heads, self.chunks
        pn = (self.head_dim, self.state_dim)
        return {"states": ((b, h, c, *pn), torch.float32),
                "s_last": ((b, h, c), torch.float32),
                "s_in": ((b, h, c, *pn), self.dtype)}

    @functools.cached_property
    def scratch_layout(self) -> dict:
        """name -> (byte offset, bytes) of y and of each part of the
        scratch in the one allocation of a call (`buffer`), each starting
        on a 256-byte boundary, y first."""
        parts = {"y": ((self.batch, self.length, self.heads,
                        self.head_dim), self.dtype), **self.scratch_shapes()}
        layout, offset = {}, 0
        for name, (shape, dtype) in parts.items():
            n = dtype.itemsize
            for d in shape:
                n *= d
            layout[name] = (offset, n)
            offset += -(-n // 256) * 256
        return layout

    @functools.cached_property
    def scratch_bytes(self) -> int:
        """Bytes of the one allocation of a call, y included (a multiple
        of the dtype's size: the allocation ends with S_in)."""
        return max(off + n for off, n in self.scratch_layout.values())


@functools.lru_cache(maxsize=256)
def plan(batch: int, length: int, heads: int, head_dim: int,
         state_dim: int, dtype: torch.dtype, sms: int) -> Plan:
    """The tile is the instance's. Phases A and C run one CTA per SM (the
    chunk scan's shared memory allows no second), each walking its group
    of heads with the next head's tiles in flight; the head group is the
    smallest (up to `MAX_GROUP`) that covers every (chunk, head, row) in
    one wave of `sms` CTAs, so long prompts share C B^T over several
    heads and short ones still spread over the SMs."""
    tile = TILES[dtype]
    units = -(-length // tile) * heads * batch
    group = max(1, min(MAX_GROUP, heads, -(-units // sms)))
    return Plan(batch, length, heads, head_dim, state_dim, dtype, tile,
                group)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


@functools.lru_cache(maxsize=256)
def _layout_args(p: Plan, sx, sdt, sb, sc, sy) -> tuple[bytes, bool]:
    """The strides and sizes of a call of `p` with x, dt, b, c and y of
    strides `sx` to `sy`, packed as the kernel takes them, and whether
    every stride of x, b and c but the last allows 16-byte loads of their
    rows (the kernel loads by 16 bytes where their starts do too)."""
    size = p.dtype.itemsize
    rows = not any(s * size % 16 for st in (sx, sb, sc) for s in st[:-1])
    return _LAYOUT.pack(*sx[:3], *sdt, *sb[:2], *sc[:2], *sy[:3], p.batch,
                        p.length, p.heads, p.head_dim, p.state_dim,
                        DTYPES[p.dtype], p.tile, p.group), rows


def buffer(p: Plan, device) -> torch.Tensor:
    """The one allocation of a call (`Plan.scratch_layout`: y, then the
    scratch), flat in the plan's dtype, uninitialised (every element is
    written before it is read)."""
    return torch.empty(p.scratch_bytes // p.dtype.itemsize, dtype=p.dtype,
                       device=device)


def scratch_views(p: Plan, raw: torch.Tensor) -> dict:
    """name -> the part of the allocation `raw` of `p` (`buffer`) as a
    tensor of its shape and dtype (for inspection)."""
    shapes = {"y": ((p.batch, p.length, p.heads, p.head_dim), p.dtype),
              **p.scratch_shapes()}
    raw = raw.view(torch.uint8)
    return {name: raw[off:off + n].view(shapes[name][1])
            .view(shapes[name][0])
            for name, (off, n) in p.scratch_layout.items()}


def launch(x, dt, a_log, b, c, y, state, p: Plan, raw, *, stream) -> int:
    """Launch the kernel's phases on `stream` for checked tensors (`state`
    may be None) with the scratch in the allocation `raw` of `p`
    (`buffer`; y may be its first part or a tensor of its own); returns
    the CUDA error code (0: every launch accepted)."""
    tail, rows = _layout_args(p, x.stride(), dt.stride(), b.stride(),
                              c.stride(), y.stride())
    xp, bp, cp = x.data_ptr(), b.data_ptr(), c.data_ptr()
    base = raw.data_ptr()
    layout = p.scratch_layout
    head = _POINTERS.pack(
        xp, dt.data_ptr(), a_log.data_ptr(), bp, cp, y.data_ptr(),
        0 if state is None else state.data_ptr(),
        base + layout["states"][0], base + layout["s_last"][0],
        base + layout["s_in"][0], rows and not (xp | bp | cp) % 16)
    return KERNEL.function()(head + tail, stream)


def ssd(x, dt, a_log, b, c, *, chunk=256, use_kernel=True,
        return_state=False):
    """Chunked SSD. x (B, L, H, P), dt (B, L, H), a_log (H,), b/c
    (B, L, N), b and c shared by every head. Returns y (B, L, H, P) in x's
    dtype, and with `return_state` also the final state (B, H, P, N)
    float32.

    `chunk` is the Pallas kernel's chunk length, kept for the reference's
    signature: the CUDA kernel tiles the sequence in chunks of its own
    (`TILES`: 128 steps in bfloat16, 64 in float32) whatever it is (the
    chunked algebra is exact for any chunk length), and the plain version
    has no chunks.
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
    state = (torch.empty((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if return_state else None)
    with torch.cuda.device(x.device):
        pl = plan(bsz, l, h, p, n, x.dtype,
                  _sms(torch.cuda.current_device()))
        raw = buffer(pl, x.device)
        # y is the allocation's first part; it holds the scratch alive
        # only as long as the caller holds y
        y = raw.as_strided(x.shape, (l * h * p, h * p, p, 1))
        err = launch(x, dt, a_log, b, c, y, state, pl, raw,
                     stream=torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    KERNEL.launches += 1
    return (y, state) if return_state else y
