"""What a traced run keeps: the benchmark's own host spans around the calls
into each layer, and the device's operations from `torch.profiler` over
a steady stretch of the window, reduced in memory.

Host spans are (label, start, end) in `time.perf_counter_ns`. The
profiler records the device only (CUDA activity): its events carry the
profiler's own clock, which is tied to the host's by the runtime's
`cudaDeviceSynchronize` that opens the stretch (the host brackets it with
its own clock); without that event, by the offset of the wall clock.
Each idle gap of the device is named after the innermost host span it
falls in: a model call's issue or wait, the core manager, the engine's
own code in `step()`, or the client (everything outside `step()`).
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import time

TOP = 10
INNER = ("model_prefill_issue", "model_prefill_wait", "model_decode_issue",
         "model_decode_wait", "core_manager")


@dataclasses.dataclass
class Stretch:
    """The traced stretch: its length, the device's busy time in it, the
    device's operations by name, idle time by host span, the model calls
    made in it, and the anchor's offset between the clocks."""
    window_s: float
    busy_s: float
    ops_s: dict
    idle_s: dict
    idle_n: dict
    calls: list
    anchor: str

    def kernel_s(self, parts) -> float:
        """Device seconds of the operations whose names hold any of
        `parts`."""
        return sum(s for name, s in self.ops_s.items()
                   if any(p in name for p in parts))

    def breakdown(self) -> dict:
        ops = sorted(self.ops_s.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[f"{n} ({self.idle_n[n]} gaps)", s]
                              for n, s in gaps]}


def merge(intervals):
    """Sorted, non-overlapping union of (start, end) pairs."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Labeller:
    """The innermost host span around an instant: the INNER spans (model
    calls, core manager) do not overlap one another and lie inside
    `engine_step` spans; outside every span the host is the client's."""

    def __init__(self, spans):
        inner = sorted((a, b, n) for n, a, b in spans if n in INNER)
        outer = sorted((a, b) for n, a, b in spans if n == "engine_step")
        self.inner, self.inner_at = inner, [s[0] for s in inner]
        self.outer, self.outer_at = outer, [s[0] for s in outer]

    def __call__(self, t: float) -> str:
        i = bisect.bisect_right(self.inner_at, t) - 1
        if i >= 0 and self.inner[i][1] >= t:
            return self.inner[i][2]
        j = bisect.bisect_right(self.outer_at, t) - 1
        if j >= 0 and self.outer[j][1] >= t:
            return "engine_self"
        return "client"


def reduce(prof, t0: int, t1: int, sync: tuple, spans, calls) -> Stretch:
    """The Stretch of a profiler `prof` (CUDA activity) run from host
    instant t0 to t1 (perf_counter_ns); `sync` the host's (before, after)
    around the synchronize that opened it."""
    from torch.autograd import DeviceType
    device, anchor_events = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            device.append((start, start + e.duration_ns(), e.name()))
        elif e.name() == "cudaDeviceSynchronize":
            anchor_events.append((start, start + e.duration_ns()))
    if anchor_events:
        a, b = min(anchor_events)
        shift = (a + b) / 2 - (sync[0] + sync[1]) / 2
        anchor = (f"cudaDeviceSynchronize; the wall-clock offset differs "
                  f"by {(shift - _wall_shift()) / 1e6:.3f} ms")
    else:
        shift = _wall_shift()
        anchor = "wall clock (no cudaDeviceSynchronize event)"
    lo, hi = t0 + shift, t1 + shift
    ops = collections.defaultdict(float)
    inside = []
    for a, b, name in device:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            inside.append((a, b))
            ops[name] += (b - a) / 1e9
    busy = merge(inside)
    label = Labeller(spans)
    idle, idle_n = collections.defaultdict(float), collections.Counter()
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            name = label((a + b) / 2 - shift)
            idle[name] += (b - a) / 1e9
            idle_n[name] += 1
    return Stretch(window_s=(t1 - t0) / 1e9,
                   busy_s=sum(b - a for a, b in busy) / 1e9,
                   ops_s=dict(ops), idle_s=dict(idle), idle_n=dict(idle_n),
                   calls=[c for c in calls if t0 <= c[2] <= t1],
                   anchor=anchor)


def _wall_shift() -> int:
    """profiler clock - perf_counter clock, if the profiler keeps the
    wall clock (nanoseconds since the epoch)."""
    return time.time_ns() - time.perf_counter_ns()
