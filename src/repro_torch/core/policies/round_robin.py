"""Round-robin baseline: naive stateless wear-leveling."""
from __future__ import annotations

from repro_torch.core.policies.base import CorePolicy, CoreView
from repro_torch.core.policies.registry import register_policy


@register_policy("round-robin")
class RoundRobinPolicy(CorePolicy):
    """Cycle a cursor over the cores and take the next free one.

    The classic wear-leveling strawman: perfectly uniform task counts,
    but blind to both process variation and accumulated aging, and it
    keeps the whole working set in C0 (no age-halting). Included to
    separate "spread the load evenly" from "spread the *stress*
    evenly" in policy sweeps.
    """

    def __init__(self):
        self._cursor = 0

    def select_core(self, view: CoreView) -> int:
        n = view.num_cores
        free = view.active_mask & ~view.assigned_mask
        if not free.any():
            return -1
        for k in range(n):
            core = (self._cursor + k) % n
            if free[core]:
                self._cursor = (core + 1) % n
                return core
        return -1
