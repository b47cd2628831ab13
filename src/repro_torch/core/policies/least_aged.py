"""Least-aged baseline (Zhao'23): route away from worked cores."""
from __future__ import annotations

import numpy as np

from repro_torch.core.policies.base import CorePolicy, CoreView
from repro_torch.core.policies.registry import register_policy


@register_policy("least-aged")
class LeastAgedPolicy(CorePolicy):
    """Assign each task to the free core with the least cumulative
    executed work — the age estimate of Zhao'23. Evens wear out but
    keeps every core in C0, so total aging is never reduced.
    """

    def select_core(self, view: CoreView) -> int:
        cand = view.active_mask & ~view.assigned_mask
        if not cand.any():
            return -1
        return int(np.argmin(np.where(cand, view.cum_work, np.inf)))
