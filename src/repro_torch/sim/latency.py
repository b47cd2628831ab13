"""Bounded request-latency aggregation for the event engine, copied
from `repro.sim.latency` (exact mode included).

`metrics.collect` historically materialized one latency array over every
completed request (`[rs.t_done - rs.t_arrival for rs in
cluster.completed]`) — O(requests) memory held until collection, the
exact pattern the fleet engine replaced with streaming `mw_*` window
columns. `LatencyAggregate` is the event-engine counterpart: the
cluster observes each completion as it happens and collection reads the
aggregate.

Two regimes:

  * Up to `exact_cap` completions the raw samples are buffered and
    `mean()` / `percentile()` evaluate `np.mean` / `np.percentile` over
    them — **bit-identical** to the historical per-request-list math
    (same values in the same order), which is what keeps the pinned
    goldens and the drift gate green without re-pinning.
  * Past the cap the buffer is spilled into a fixed log-spaced histogram
    plus running count/sum/min/max, and the memory stays O(bins)
    forever — week-long event-engine horizons no longer accumulate
    per-request state. Mean stays exact to running-sum precision;
    percentiles interpolate within the owning histogram bin.
"""
from __future__ import annotations

import numpy as np

#: default exact-buffer size — default configs complete ~1e4 requests,
#: so bit-exact mode comfortably covers every pinned golden
DEFAULT_EXACT_CAP = 1 << 18


class LatencyAggregate:
    """Streaming latency summary: exact up to a cap, bounded after."""

    __slots__ = ("count", "exact_cap", "_sum", "_min", "_max",
                 "_samples", "_edges", "_hist")

    def __init__(self, exact_cap: int = DEFAULT_EXACT_CAP,
                 bins: int = 512, lo_s: float = 1e-3, hi_s: float = 1e4):
        if exact_cap < 1:
            raise ValueError(f"exact_cap must be >= 1, got {exact_cap}")
        self.count = 0
        self.exact_cap = int(exact_cap)
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._samples: list[float] | None = []
        # log-spaced bin edges; samples outside [lo_s, hi_s] clamp into
        # the first/last bin (min/max stay exact regardless)
        self._edges = np.geomspace(lo_s, hi_s, bins + 1)
        self._hist: np.ndarray | None = None

    def observe(self, latency_s: float) -> None:
        self.count += 1
        self._sum += latency_s
        if latency_s < self._min:
            self._min = latency_s
        if latency_s > self._max:
            self._max = latency_s
        if self._samples is not None:
            self._samples.append(latency_s)
            if len(self._samples) > self.exact_cap:
                self._spill()
        else:
            self._hist[self._bin(latency_s)] += 1

    def _bin(self, x: float) -> int:
        i = int(np.searchsorted(self._edges, x, side="right")) - 1
        return min(max(i, 0), len(self._edges) - 2)

    def _spill(self) -> None:
        """Cap crossed: fold the exact buffer into the histogram and
        switch to bounded mode."""
        self._hist = np.zeros(len(self._edges) - 1, dtype=np.int64)
        idx = np.clip(
            np.searchsorted(self._edges, self._samples, side="right") - 1,
            0, len(self._edges) - 2)
        np.add.at(self._hist, idx, 1)
        self._samples = None

    @property
    def exact(self) -> bool:
        """True while every sample is still buffered (bit-exact mode)."""
        return self._samples is not None

    def mean(self) -> float:
        if self.count == 0:
            return float("nan")
        if self._samples is not None:
            # identical expression to the historical per-request list
            return float(np.asarray(self._samples).mean())
        return self._sum / self.count

    def percentile(self, p: float) -> float:
        if self.count == 0:
            return float("nan")
        if self._samples is not None:
            return float(np.percentile(np.asarray(self._samples), p))
        # histogram interpolation: walk the cumulative counts to the
        # owning bin, interpolate linearly inside it, clamp to observed
        # min/max so degenerate bins can't over/undershoot
        target = p / 100.0 * (self.count - 1)
        cum = np.cumsum(self._hist)
        b = int(np.searchsorted(cum, target, side="right"))
        b = min(b, len(self._hist) - 1)
        prev = cum[b - 1] if b > 0 else 0
        inbin = max(int(self._hist[b]), 1)
        frac = min(max((target - prev) / inbin, 0.0), 1.0)
        lo, hi = self._edges[b], self._edges[b + 1]
        return float(min(max(lo + frac * (hi - lo), self._min), self._max))
