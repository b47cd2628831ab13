"""Per-core C-state residency accounting — what the power models consume.

A machine's operational energy is determined by how long its cores sat
in each power regime, not by a flat utilization assumption. The
`CoreManager` keeps a `ResidencyAccumulator` in lockstep with its
event-loop bookkeeping: every state transition (assign / release /
gate / wake / settle) first banks the elapsed interval's core-seconds
under the *old* regime counts, exactly mirroring how dVth settlement
banks aging under the old ADF.

Regimes (the four states a `PowerModel` prices):

  busy        — C0, running an inference task (active-allocated)
  shallow idle — C0, no task (active-unallocated; clock-gated at best)
  gated       — C6 deep idle / power-gated (Algorithm 2's recovery
                state; the simulator's CState has one deep-idle level,
                so deep-idle and power-gated coincide here)

Alongside the scalar integrals the accumulator banks the same
core-seconds into fixed-width time windows, so operational carbon can
be priced against a *time-varying* grid intensity (power x intensity
integrated window by window) — the hook temporal scheduling needs.
The accumulator is pure bookkeeping: it never reads or perturbs the
aging state, so the settle hot path stays bit-exact.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator


@dataclasses.dataclass(frozen=True)
class StateResidency:
    """Frozen per-machine core-state residency record over one horizon.

    All `*_core_s` fields are integrals of core-counts over time
    (core-seconds); `busy + idle + gated == num_cores * duration_s` up
    to float association. `freq_busy_core_s` weights each busy
    core-second by the settled frequency factor the task ran at, so
    `mean_busy_frequency` is the energy-relevant mean P-state.
    """

    num_cores: int
    duration_s: float
    busy_core_s: float
    idle_core_s: float
    gated_core_s: float
    freq_busy_core_s: float
    window_s: float
    window_busy_s: tuple[float, ...] = ()
    window_idle_s: tuple[float, ...] = ()
    window_gated_s: tuple[float, ...] = ()

    @property
    def utilization(self) -> float:
        """Fraction of core-time spent running tasks."""
        total = self.num_cores * self.duration_s
        return self.busy_core_s / total if total > 0.0 else 0.0

    @property
    def idle_frac(self) -> float:
        total = self.num_cores * self.duration_s
        return self.idle_core_s / total if total > 0.0 else 0.0

    @property
    def gated_frac(self) -> float:
        total = self.num_cores * self.duration_s
        return self.gated_core_s / total if total > 0.0 else 0.0

    @property
    def mean_busy_frequency(self) -> float:
        """Busy-time-weighted mean settled frequency factor (nominal
        1.0); 1.0 when nothing ever ran (it then only multiplies a zero
        busy fraction)."""
        if self.busy_core_s > 0.0:
            return self.freq_busy_core_s / self.busy_core_s
        return 1.0

    def iter_windows(self) -> Iterator[tuple[float, float, float, float,
                                             float]]:
        """Yield `(t_start, elapsed_s, busy_frac, idle_frac,
        gated_frac)` per non-empty time window. Windows are contiguous
        from t=0; only the final one may be partial."""
        n = self.num_cores
        for i, (b, s, g) in enumerate(zip(self.window_busy_s,
                                          self.window_idle_s,
                                          self.window_gated_s)):
            elapsed = (b + s + g) / n
            if elapsed <= 0.0:
                continue
            denom = n * elapsed
            yield (i * self.window_s, elapsed,
                   b / denom, s / denom, g / denom)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "StateResidency":
        d = dict(d)
        for f in ("window_busy_s", "window_idle_s", "window_gated_s"):
            d[f] = tuple(float(x) for x in d.get(f, ()))
        return cls(**d)


class ResidencyAccumulator:
    """Mutable residency integrator owned by one `CoreManager`.

    `advance(now, n_busy, n_gated)` banks `[last_t, now)` under the
    given counts — callers must advance BEFORE changing any count,
    mirroring the settle-before-regime-change rule of the aging
    bookkeeping. O(1) per call (the interval lands in one time window
    except across the rare window boundary).
    """

    __slots__ = ("num_cores", "window_s", "last_t", "busy_core_s",
                 "idle_core_s", "gated_core_s", "freq_busy_core_s",
                 "_wb", "_wi", "_wg")

    def __init__(self, num_cores: int, window_s: float = 1.0):
        if window_s <= 0.0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.num_cores = num_cores
        self.window_s = window_s
        self.last_t = 0.0
        self.busy_core_s = 0.0
        self.idle_core_s = 0.0
        self.gated_core_s = 0.0
        self.freq_busy_core_s = 0.0
        self._wb: list[float] = []
        self._wi: list[float] = []
        self._wg: list[float] = []

    def advance(self, now: float, n_busy: int, n_gated: int) -> None:
        t0 = self.last_t
        dt = now - t0
        if dt <= 0.0:
            return
        self.last_t = now
        n_idle = self.num_cores - n_busy - n_gated
        self.busy_core_s += n_busy * dt
        self.idle_core_s += n_idle * dt
        self.gated_core_s += n_gated * dt
        w = self.window_s
        wb, wi, wg = self._wb, self._wi, self._wg
        i0 = int(t0 / w)
        i1 = int(now / w)
        if i1 >= len(wb):
            ext = i1 + 1 - len(wb)
            wb.extend([0.0] * ext)
            wi.extend([0.0] * ext)
            wg.extend([0.0] * ext)
        if i0 == i1:                      # common case: one window
            wb[i0] += n_busy * dt
            wi[i0] += n_idle * dt
            wg[i0] += n_gated * dt
            return
        t = t0
        for i in range(i0, i1 + 1):       # split across window boundaries
            seg = min((i + 1) * w, now) - t
            if seg > 0.0:
                wb[i] += n_busy * seg
                wi[i] += n_idle * seg
                wg[i] += n_gated * seg
            t += seg

    def add_busy_frequency(self, speed: float, duration_s: float) -> None:
        """Bank `duration_s` busy core-seconds weighted by the settled
        frequency factor the task ran at (called on release)."""
        if duration_s > 0.0:
            self.freq_busy_core_s += speed * duration_s

    def snapshot(self) -> StateResidency:
        return StateResidency(
            num_cores=self.num_cores,
            duration_s=self.last_t,
            busy_core_s=self.busy_core_s,
            idle_core_s=self.idle_core_s,
            gated_core_s=self.gated_core_s,
            freq_busy_core_s=self.freq_busy_core_s,
            window_s=self.window_s,
            window_busy_s=tuple(self._wb),
            window_idle_s=tuple(self._wi),
            window_gated_s=tuple(self._wg),
        )
