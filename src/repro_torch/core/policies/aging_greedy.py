"""Aging-greedy oracle baseline: route by true current degradation."""
from __future__ import annotations

import numpy as np

from repro_torch.core.policies.base import CorePolicy, CoreView
from repro_torch.core.policies.registry import register_policy


@register_policy("aging-greedy")
class AgingGreedyPolicy(CorePolicy):
    """Assign each task to the free core with the smallest *settled*
    threshold-voltage shift — the natural oracle for Algorithm 1's
    idle-score heuristic, as if per-core aging sensors were read on
    every placement (paper §5 assumes such reads are only affordable on
    the slow periodic path). Upper-bounds what dVth-exact placement
    buys without selective idling: like least-aged it never power-gates,
    so mean aging matches the always-C0 baselines.
    """

    def select_core(self, view: CoreView) -> int:
        cand = view.active_mask & ~view.assigned_mask
        if not cand.any():
            return -1
        return int(np.argmin(np.where(cand, view.dvth_now(), np.inf)))
