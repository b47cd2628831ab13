"""Arrival processes — the *when* layer of a workload scenario.

All processes draw from the single generator a `Scenario.generate` call
owns, one `next_gap` at a time, so the composed request stream is
deterministic per seed. `rate_rps` is always the *mean* cluster request
rate: temporal shapes (diurnal swing, MMPP bursts, flash crowds)
modulate around it without changing the delivered request volume, which
keeps throughput-normalized comparisons across scenarios honest.

Non-homogeneous processes use Lewis thinning: candidate arrivals are
drawn at the peak rate and accepted with probability rate(t)/peak — the
standard exact method for a time-varying Poisson process.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def _thinned_gap(rng: np.random.Generator, t: float, peak: float,
                 rate) -> float:
    """One inter-arrival gap of a non-homogeneous Poisson process via
    Lewis thinning: candidates at `peak`, accepted w.p. rate(t)/peak."""
    t_cand = t
    while True:
        t_cand += rng.exponential(1.0 / peak)
        if rng.random() * peak <= rate(t_cand):
            return t_cand - t


@dataclasses.dataclass
class PoissonArrivals:
    """Homogeneous Poisson process (the paper's / Splitwise default)."""

    rate_rps: float

    def next_gap(self, rng: np.random.Generator, t: float) -> float:
        return rng.exponential(1.0 / self.rate_rps)


@dataclasses.dataclass
class ConstantArrivals:
    """Deterministic fixed-gap arrivals (closed-loop load generators)."""

    rate_rps: float

    def next_gap(self, rng: np.random.Generator, t: float) -> float:
        return 1.0 / self.rate_rps


@dataclasses.dataclass
class DiurnalPoissonArrivals:
    """Sinusoidal day/night-modulated Poisson process.

    rate(t) = rate_rps * (1 + amplitude * sin(2*pi*t/period + phase));
    with the default amplitude 0.6 the peak:trough ratio is 4:1, the
    order of the day/night swing in the Azure LLM inference traces the
    paper (and EcoServe, arXiv:2502.05043) evaluate against. `phase`
    defaults so a trace starting at t=0 begins mid-ramp.
    """

    rate_rps: float
    amplitude: float = 0.6
    period_s: float = 86_400.0
    phase: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError(f"amplitude must be in [0, 1), got "
                             f"{self.amplitude}")

    def rate(self, t: float) -> float:
        return self.rate_rps * (1.0 + self.amplitude * math.sin(
            2.0 * math.pi * t / self.period_s + self.phase))

    def next_gap(self, rng: np.random.Generator, t: float) -> float:
        peak = self.rate_rps * (1.0 + self.amplitude)
        return _thinned_gap(rng, t, peak, self.rate)


@dataclasses.dataclass
class MMPPArrivals:
    """Two-state Markov-modulated Poisson process (bursty load).

    Alternates between a quiet regime and a burst regime with
    exponentially distributed sojourns. Regime rates are solved so the
    long-run mean equals `rate_rps`:

        mean = (r_quiet * s_quiet + r_burst * s_burst) / (s_quiet + s_burst)

    with r_burst = burst_factor * r_quiet.
    """

    rate_rps: float
    burst_factor: float = 6.0
    quiet_sojourn_s: float = 20.0
    burst_sojourn_s: float = 4.0
    _state: int = dataclasses.field(default=0, repr=False)       # 0=quiet
    _switch_in: float | None = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.burst_factor < 1.0:
            raise ValueError("burst_factor must be >= 1")
        s_q, s_b = self.quiet_sojourn_s, self.burst_sojourn_s
        r_quiet = self.rate_rps * (s_q + s_b) / (
            s_q + self.burst_factor * s_b)
        self._rates = (r_quiet, self.burst_factor * r_quiet)
        self._sojourns = (s_q, s_b)

    def next_gap(self, rng: np.random.Generator, t: float) -> float:
        gap = 0.0
        if self._switch_in is None:
            # Start from the stationary regime distribution, else short
            # traces (always opening in the quiet regime) systematically
            # under-deliver the configured mean rate.
            s_q, s_b = self._sojourns
            self._state = 0 if rng.random() < s_q / (s_q + s_b) else 1
            self._switch_in = rng.exponential(self._sojourns[self._state])
        while True:
            arrival = rng.exponential(1.0 / self._rates[self._state])
            if arrival < self._switch_in:
                self._switch_in -= arrival
                return gap + arrival
            # The regime switches first; the leftover exponential beyond
            # the switch is discarded (memorylessness makes this exact).
            gap += self._switch_in
            self._state = 1 - self._state
            self._switch_in = rng.exponential(self._sojourns[self._state])


@dataclasses.dataclass
class FlashCrowdArrivals:
    """Baseline Poisson load with one rectangular traffic spike.

    Outside [spike_start_s, spike_start_s + spike_duration_s) requests
    arrive at a reduced base rate; inside, at `spike_multiplier` times
    the base rate. The base rate is solved per-duration at scenario
    build time so the *mean* over `norm_duration_s` equals `rate_rps`.
    """

    rate_rps: float
    spike_multiplier: float = 8.0
    spike_start_s: float = 40.0
    spike_duration_s: float = 20.0
    norm_duration_s: float = 120.0

    def __post_init__(self):
        if self.spike_multiplier < 1.0:
            raise ValueError("spike_multiplier must be >= 1")
        # volume = base*(D - d) + base*mult*d  ==  rate_rps * D, where d
        # is the spike's overlap with [0, D) — a spike extending past
        # the trace end contributes only its in-trace part.
        lo = min(self.spike_start_s, self.norm_duration_s)
        hi = min(self.spike_start_s + self.spike_duration_s,
                 self.norm_duration_s)
        d = max(0.0, hi - lo)
        base = self.rate_rps * self.norm_duration_s / (
            self.norm_duration_s + (self.spike_multiplier - 1.0) * d)
        self._base = base

    def rate(self, t: float) -> float:
        in_spike = (self.spike_start_s <= t
                    < self.spike_start_s + self.spike_duration_s)
        return self._base * (self.spike_multiplier if in_spike else 1.0)

    def next_gap(self, rng: np.random.Generator, t: float) -> float:
        peak = self._base * self.spike_multiplier
        return _thinned_gap(rng, t, peak, self.rate)
