"""The paper's technique: Algorithm 1 mapping + Algorithm 2 idling."""
from __future__ import annotations

from repro_torch.core import idling
from repro_torch.core.policies.base import CorePolicy, CoreView, IdleCorrection
from repro_torch.core.policies.registry import register_policy


@register_policy("proposed")
class ProposedPolicy(CorePolicy):
    """Aging-aware core management (paper Algorithms 1 + 2).

    Tasks go to the free working-set core with the highest idle score
    (sum of its last eight idle durations — a cheap lesser-aged
    estimate), and a per-period reaction function sizes the working set
    to throughput, power-gating spare cores most-aged-first so their
    NBTI aging halts.

    `carbon_aware=True` adds the temporal dimension: during dirty-grid
    hours (current `CarbonIntensity` above `dirty_frac` x its mean) the
    periodic correction is reshaped by `idling.temporal_adjustment` —
    gating amplified by `gate_gain`, wake-ups partially deferred by
    `defer_frac` while at most `guard_tasks` tasks are oversubscribed
    (the p99-latency guard). The default (`carbon_aware=False`) is
    bit-exact with the pre-option behaviour.
    """

    def __init__(self, carbon_aware: bool = False,
                 intensity="diurnal", intensity_opts=None,
                 dirty_frac: float = 1.05, defer_frac: float = 0.5,
                 guard_tasks: int = 2, gate_gain: float = 2.0):
        if not 0.0 <= defer_frac <= 1.0:
            raise ValueError(f"defer_frac must be in [0, 1], got "
                             f"{defer_frac}")
        if gate_gain < 1.0:
            raise ValueError(f"gate_gain must be >= 1, got {gate_gain}")
        if guard_tasks < 0:
            raise ValueError(f"guard_tasks must be >= 0, got "
                             f"{guard_tasks}")
        if dirty_frac <= 0.0:
            raise ValueError(f"dirty_frac must be > 0, got {dirty_frac}")
        self.carbon_aware = bool(carbon_aware)
        self.dirty_frac = dirty_frac
        self.defer_frac = defer_frac
        self.guard_tasks = guard_tasks
        self.gate_gain = gate_gain
        self._intensity = None
        self._intensity_mean = 0.0
        if self.carbon_aware:
            from repro_torch.carbon.intensity import get_intensity
            self._intensity = get_intensity(
                intensity, **dict(intensity_opts or {}))
            self._intensity_mean = self._intensity.mean_g_per_kwh()

    def select_core(self, view: CoreView) -> int:
        # Algorithm 1's masked argmax, answered by the manager's
        # incremental free-core index (same selection as
        # `mapping.select_core(view.active_mask, view.assigned_mask,
        # view.idle_history)`, without rebuilding masks per task).
        return view.best_idle_core()

    def periodic(self, view: CoreView) -> IdleCorrection | None:
        active_mask = view.active_mask
        assigned_mask = view.assigned_mask
        corr = idling.core_correction(
            view.num_cores,
            int(active_mask.sum()),
            int(assigned_mask.sum()),
            view.oversub_count,
        )
        cause = "policy"
        deferred = 0
        if self._intensity is not None:
            corr0 = corr
            corr = idling.temporal_adjustment(
                corr, self._intensity.g_per_kwh(view.now),
                self._intensity_mean, view.oversub_count,
                dirty_frac=self.dirty_frac, defer_frac=self.defer_frac,
                guard_tasks=self.guard_tasks, gate_gain=self.gate_gain)
            if corr != corr0:
                cause = "carbon-aware"
                if corr0 < 0:
                    # corr0 wanted -corr0 wake-ups; the adjustment kept
                    # only -corr of them (corr > corr0 here).
                    deferred = corr - corr0
        to_idle, to_wake = idling.apply_correction(
            corr, active_mask, assigned_mask, view.dvth,
            failed_mask=view.failed_mask)
        if not (len(to_idle) or len(to_wake) or deferred):
            return None
        return IdleCorrection(to_idle=to_idle, to_wake=to_wake,
                              cause=cause, deferred_wakes=deferred)
