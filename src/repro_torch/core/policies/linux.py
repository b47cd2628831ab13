"""Stock-Linux baseline: probabilistic CFS-like task placement."""
from __future__ import annotations

import numpy as np

from repro_torch.core.policies.base import CorePolicy, CoreView
from repro_torch.core.policies.registry import register_policy


@register_policy("linux")
class LinuxPolicy(CorePolicy):
    """Probabilistic model of a stock Linux LLM inference server (paper
    §6.1.1), built from captured CPU data: CFS mostly picks an idle core
    but exhibits cache-affinity stickiness, with a skewed preference for
    low-numbered cores (topology order, per Wilkins'24 captures). All
    cores stay in C0 — no selective idling, aging never halts.
    """

    def __init__(self, stickiness: float = 0.3):
        self.stickiness = float(stickiness)
        self._last_core = -1

    def select_core(self, view: CoreView) -> int:
        cand = np.flatnonzero(view.active_mask & ~view.assigned_mask)
        if cand.size == 0:
            return -1
        last = self._last_core
        if last in cand and view.rng.random() < self.stickiness:
            core = last
        else:
            w = 1.0 / (1.0 + 0.05 * np.arange(cand.size))
            core = int(view.rng.choice(cand, p=w / w.sum()))
        self._last_core = core
        return core
