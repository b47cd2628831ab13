"""Collective traffic per device (the roofline's collective term; the
counterpart of `repro.distributed.hlo_analysis`).

The reference scans compiled HLO text for all-reduce / all-gather /
reduce-scatter / all-to-all / collective-permute ops and sums their
result-buffer sizes; `collective_bytes` and `duplicate_fusion_count` are
its text functions, kept for HLO text. The port compiles no HLO: its
source of the same dict is `CollectiveLog`, a dispatch mode that records
each c10d functional collective that DTensor issues on a rank's local
tensors, under the reference's HLO names, summing result bytes as the
reference does. Local shapes are per-device, so totals are per-device
bytes.
"""
from __future__ import annotations

import re
from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([0-9,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * DTYPE_BYTES.get(dtype, 4)


def collective_bytes(hlo_text: str) -> dict:
    """Returns {op_name: bytes, ..., 'total': bytes, 'count': int}."""
    totals: dict = defaultdict(int)
    count = 0
    for line in hlo_text.splitlines():
        stripped = line.strip()
        if " = " not in stripped:
            continue
        op = None
        for cand in COLLECTIVE_OPS:
            # match the op invocation, not a variable name mention
            if f" {cand}(" in stripped or f" {cand}-start(" in stripped:
                op = cand
                break
        if op is None:
            continue
        # "-done" ops carry the same buffer as "-start"; count starts only.
        if f" {op}-done(" in stripped:
            continue
        lhs = stripped.split(" = ", 1)[1]
        # result shapes (possibly a tuple) precede " <op>(" / " <op>-start("
        cut = lhs.find(f" {op}(")
        if cut < 0:
            cut = lhs.find(f" {op}-start(")
        shapes_str = lhs[:cut] if cut >= 0 else lhs.split("(", 1)[0]
        nbytes = sum(_shape_bytes(dt, dims)
                     for dt, dims in _SHAPE_RE.findall(shapes_str))
        totals[op] += nbytes
        count += 1
    totals["total"] = sum(totals[o] for o in COLLECTIVE_OPS if o in totals)
    totals["count"] = count
    return dict(totals)


def duplicate_fusion_count(hlo_text: str) -> int:
    """Rough remat indicator: repeated identical fusion computations."""
    names = re.findall(r"^\s*%?(fused_computation[\w.]*)", hlo_text,
                       re.MULTILINE)
    return len(names) - len(set(names))


# c10d functional ops (and DTensor's own all-to-all) -> the HLO op name
COLLECTIVES = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
}


def _op_name(func) -> str:
    """"namespace.name" of an op overload, without its overload."""
    return func._schema.name.replace("::", ".")


class CollectiveLog(TorchDispatchMode):
    """Records each collective run on local tensors while the mode is on:
    `as_dict()` gives {HLO op name: result bytes, ..., "total": bytes,
    "count": collectives}, `collective_bytes`' contract. Ops on DTensors
    pass through to DTensor, which issues the collectives on the local
    tensors this mode sees; `wait_tensor` and `_wrap_tensor_autograd` are
    not collectives."""

    def __init__(self):
        super().__init__()
        self.by_op: dict = defaultdict(int)
        self.count = 0

    def as_dict(self) -> dict:
        out = dict(self.by_op)
        out["total"] = sum(self.by_op.values())
        out["count"] = self.count
        return out

    def _log(self, func, out) -> None:
        name = COLLECTIVES.get(_op_name(func))
        if name is None:
            return
        self.by_op[name] += sum(t.numel() * t.element_size()
                                for t in tree_leaves(out)
                                if isinstance(t, torch.Tensor))
        self.count += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(isinstance(t, DTensor) for t in tree_leaves((args, kwargs))):
            return NotImplemented
        out = func(*args, **kwargs)
        self._log(func, out)
        return out
