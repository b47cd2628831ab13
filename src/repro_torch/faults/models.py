"""Built-in fault models (see `repro_torch.faults.base` for the
protocol), copied from `repro.faults.models`.

  none            — bit-exact no-op. The engines build NO fault
                    machinery at all when `fault_model == "none"`, so
                    faultless runs draw no extra RNG, schedule no extra
                    events, and stay bit-identical to pre-fault goldens.
  guardband       — a core whose ΔVth-driven settled frequency has eaten
                    more than `margin` of the guardband fails
                    probabilistically, coupling failure rate to the
                    aging state each policy produces: policies that age
                    cores harder (or less evenly) lose more cores.
  machine-crash   — Poisson whole-machine crashes (rate 1/mttf_s) with a
                    deterministic `reboot_s` recovery window.
  transient-stall — temporary single-core slowdowns (Poisson onsets,
                    fixed slowdown factor and duration).
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.faults.base import FaultDecision, FaultModel, FaultView
from repro_torch.faults.registry import register_fault_model


@register_fault_model("none")
class NoFaults(FaultModel):
    """Nothing ever fails — the default, and deliberately *absent* at
    runtime: engines skip fault construction entirely for this name, so
    it exists to make the registry axis total (`get_fault_model("none")`
    resolves) and as the minimal protocol reference."""

    def periodic(self, view: FaultView) -> FaultDecision | None:
        return None


@register_fault_model("guardband")
class GuardbandFaults(FaultModel):
    """Aging-coupled core failures at the frequency guardband edge.

    A core is *eligible* once its settled `dvth / headroom` — the
    fraction of the frequency guardband its NBTI shift has consumed —
    exceeds `margin`. Each period an eligible core fails with
    probability `1 - exp(-hazard_per_s * over * period)` where
    `over = (dvth/headroom - margin) / margin`: the further past the
    margin, the steeper the hazard. This couples failures to the aging
    distribution each policy produces, which is the acceptance handle —
    `proposed` keeps per-core wear lower and more even than `linux`, so
    at equal horizons it must lose strictly fewer cores.

    One uniform is drawn per core every period *regardless* of
    eligibility, so the RNG stream is identical across policies and
    failure-count comparisons reflect aging state, not stream drift.
    """

    def __init__(self, margin: float = 0.012, hazard_per_s: float = 2.0,
                 max_failed_frac: float = 0.5):
        if margin <= 0.0:
            raise ValueError(f"margin must be > 0, got {margin}")
        if hazard_per_s <= 0.0:
            raise ValueError(f"hazard_per_s must be > 0, got {hazard_per_s}")
        if not 0.0 < max_failed_frac <= 1.0:
            raise ValueError(f"max_failed_frac must be in (0, 1], got "
                             f"{max_failed_frac}")
        self.margin = float(margin)
        self.hazard_per_s = float(hazard_per_s)
        self.max_failed_frac = float(max_failed_frac)

    def periodic(self, view: FaultView) -> FaultDecision | None:
        # Draw BEFORE any early-out so the stream stays policy-invariant.
        u = view.rng.random(view.num_cores)
        if not view.up:
            return None
        failed = view.failed_mask
        if failed.sum() >= self.max_failed_frac * view.num_cores:
            return None
        over = (view.degradation() - self.margin) / self.margin
        p = -np.expm1(-self.hazard_per_s * view.period_s
                      * np.maximum(over, 0.0))
        hits = np.flatnonzero((over > 0.0) & ~failed & (u < p))
        if not len(hits):
            return None
        return FaultDecision(fail_cores=tuple(int(c) for c in hits))


@register_fault_model("machine-crash")
class MachineCrashFaults(FaultModel):
    """Poisson machine crashes with a deterministic reboot window.

    Crash inter-arrivals are Exp(mttf_s) from the fault axis' seeded
    per-machine stream (the next crash time is pre-drawn, so detection
    is deterministic given the seed); recovery takes exactly `reboot_s`
    — everything in flight on the machine dies and is re-dispatched by
    the cluster's retry layer.
    """

    def __init__(self, mttf_s: float = 1800.0, reboot_s: float = 30.0):
        if mttf_s <= 0.0:
            raise ValueError(f"mttf_s must be > 0, got {mttf_s}")
        if reboot_s <= 0.0:
            raise ValueError(f"reboot_s must be > 0, got {reboot_s}")
        self.mttf_s = float(mttf_s)
        self.reboot_s = float(reboot_s)
        self._next_crash: float | None = None

    def periodic(self, view: FaultView) -> FaultDecision | None:
        if self._next_crash is None:
            self._next_crash = float(view.rng.exponential(self.mttf_s))
        if not view.up or view.now < self._next_crash:
            return None
        self._next_crash = (view.now + self.reboot_s
                            + float(view.rng.exponential(self.mttf_s)))
        return FaultDecision(crash=True, reboot_s=self.reboot_s)


@register_fault_model("transient-stall")
class TransientStallFaults(FaultModel):
    """Temporary single-core slowdowns (thermal throttling, SMIs, noisy
    neighbors): stall onsets are Poisson per machine (`rate_per_s`), a
    uniformly-drawn core runs at `slowdown` x its settled speed for
    `stall_s` seconds, then recovers. In-flight work on the core is
    re-rated through the same rebanking path promotions use."""

    def __init__(self, rate_per_s: float = 0.02, slowdown: float = 0.4,
                 stall_s: float = 5.0):
        if rate_per_s <= 0.0:
            raise ValueError(f"rate_per_s must be > 0, got {rate_per_s}")
        if not 0.0 < slowdown < 1.0:
            raise ValueError(f"slowdown must be in (0, 1), got {slowdown}")
        if stall_s <= 0.0:
            raise ValueError(f"stall_s must be > 0, got {stall_s}")
        self.rate_per_s = float(rate_per_s)
        self.slowdown = float(slowdown)
        self.stall_s = float(stall_s)

    def periodic(self, view: FaultView) -> FaultDecision | None:
        # Fixed two draws per period keep the stream policy-invariant.
        u = view.rng.random()
        core = int(view.rng.integers(view.num_cores))
        if not view.up:
            return None
        p = -math.expm1(-self.rate_per_s * view.period_s)
        if u >= p or view.failed_mask[core]:
            return None
        return FaultDecision(stall_cores=(core,),
                             stall_factor=self.slowdown,
                             stall_s=self.stall_s)
