"""Core-policy protocol: the pluggable task-to-core decision surface.

A `CorePolicy` makes three kinds of decisions for one server's CPU:

  * `select_core(view)` — which free core runs the next inference task
    (Algorithm 1 in the proposed technique; CFS-like placement in the
    Linux baseline; age-proxy argmins in the others).
  * `on_release(view, core)` — observe a task leaving a core (hook for
    policies that keep their own bookkeeping).
  * `periodic(view)` — once per idling period, optionally return an
    `IdleCorrection` telling the manager which cores to power-gate or
    wake (Algorithm 2 for the proposed technique; `None` = leave the
    working set alone, the baseline behaviour).

Policies never mutate manager state directly: they see a read-only
`CoreView`, so the NBTI bookkeeping (lazy dVth settlement, idle-history
ring buffers, task maps) cannot be corrupted by a buggy or adversarial
policy. A policy instance is owned by exactly one `CoreManager` — any
internal state (stickiness memory, round-robin cursor) is per-server.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np

from repro_torch.core.temperature import CState


def _empty() -> np.ndarray:
    return np.empty(0, dtype=np.int64)


def _readonly(a: np.ndarray) -> np.ndarray:
    v = a.view()
    v.flags.writeable = False
    return v


class CoreView:
    """Read-only window onto one CoreManager's per-core state.

    Arrays are zero-copy read-only views refreshed on every property
    access (the manager reassigns some of them during settlement), so a
    policy may hold the `CoreView` itself but should not cache arrays
    across calls.
    """

    __slots__ = ("_m",)

    def __init__(self, manager):
        self._m = manager

    # -- shape / clock ------------------------------------------------- #
    @property
    def num_cores(self) -> int:
        return self._m.num_cores

    @property
    def now(self) -> float:
        """Manager's current simulation/wall time."""
        return self._m.now

    @property
    def idling_period_s(self) -> float:
        return self._m.idling_period_s

    # -- per-core state ------------------------------------------------ #
    @property
    def active_mask(self) -> np.ndarray:
        """(N,) bool — core is in the working set (C0, not power-gated)."""
        return self._m.c_state == CState.ACTIVE

    @property
    def assigned_mask(self) -> np.ndarray:
        """(N,) bool — core currently runs an inference task."""
        return self._m.task_of_core >= 0

    @property
    def idle_history(self) -> np.ndarray:
        """(N, IDLE_HISTORY_LEN) float — rolling idle-duration windows."""
        return _readonly(self._m.idle_history)

    @property
    def dvth(self) -> np.ndarray:
        """(N,) float — threshold-voltage shift as of each core's last
        settlement (lazily updated; see `dvth_now` for settled values)."""
        return _readonly(self._m.dvth)

    @property
    def f0(self) -> np.ndarray:
        """(N,) float — process-variation initial max frequencies."""
        return _readonly(self._m.f0)

    @property
    def cum_work(self) -> np.ndarray:
        """(N,) float — cumulative task-seconds executed per core (the
        Zhao'23 least-aged age proxy, maintained by the manager)."""
        return _readonly(self._m.cum_work)

    @property
    def failed_mask(self) -> np.ndarray:
        """(N,) bool — cores permanently offlined by the fault layer
        (`repro.faults`). All-False unless a fault model is active;
        failed cores are held in deep idle and must never be woken."""
        return _readonly(self._m.failed)

    @property
    def oversub_count(self) -> int:
        """Number of tasks currently waiting without a core."""
        return len(self._m.oversub_tasks)

    @property
    def rng(self) -> np.random.Generator:
        """The manager's RNG — shared so seeded runs are reproducible."""
        return self._m.rng

    # -- derived ------------------------------------------------------- #
    def best_idle_core(self) -> int:
        """Free working-set core with the highest idle score, or -1 —
        Algorithm 1's argmax, answered from the manager's incremental
        free-core index instead of a fresh masked argmax. Equivalent to
        `mapping.select_core(active_mask, assigned_mask, idle_history)`
        including first-index tie-breaking (pinned by
        tests/test_fastpath.py); read-only from the policy's view."""
        return self._m._peek_best_free()

    def dvth_now(self) -> np.ndarray:
        """(N,) float — dVth settled to `now` without mutating manager
        state. Models reading accurate aging-sensor data (paper §5)."""
        out = self._m._settled_dvth(self._m.now)
        out.flags.writeable = False
        return out


@dataclasses.dataclass(frozen=True)
class IdleCorrection:
    """Periodic working-set adjustment returned by `CorePolicy.periodic`.

    The manager applies it: `to_idle` cores are settled, their idle
    window recorded, and power-gated (C6); `to_wake` cores return to C0.
    Cores running a task must never appear in `to_idle`.

    `cause` attributes the decision for telemetry ("policy" for the
    plain reaction function, "carbon-aware" when
    `idling.temporal_adjustment` reshaped it); `deferred_wakes` counts
    wake-ups the carbon-aware path held back this period. Both are
    observability-only — the manager applies `to_idle`/`to_wake`
    identically regardless.
    """

    # default factories, not a shared ndarray default: Python 3.11+
    # refuses an unhashable dataclass default (the reference's
    # `src/repro/core/policies/base.py` does not import there)
    to_idle: np.ndarray = dataclasses.field(default_factory=_empty)
    to_wake: np.ndarray = dataclasses.field(default_factory=_empty)
    cause: str = "policy"
    deferred_wakes: int = 0

    def __bool__(self) -> bool:
        return bool(len(self.to_idle) or len(self.to_wake))


class CorePolicy:
    """Base class for task-to-core management policies.

    Subclasses register under a string key with `@register_policy(name)`
    and are instantiated per-manager via `get_policy(name, **opts)`.
    """

    #: canonical registry key, set by @register_policy
    name: ClassVar[str] = "?"

    def select_core(self, view: CoreView) -> int:
        """Pick a core for the next task, or -1 to oversubscribe."""
        raise NotImplementedError

    def on_release(self, view: CoreView, core: int) -> None:
        """A task just left `core` (policy-side bookkeeping hook)."""

    def periodic(self, view: CoreView) -> IdleCorrection | None:
        """Once per idling period; return a correction or None."""
        return None

    # Legacy alias: pre-registry code read `manager.policy.value` off the
    # old `Policy` enum; the registry key plays that role now.
    @property
    def value(self) -> str:
        return self.name

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"
