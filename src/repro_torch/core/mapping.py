"""Task-to-Core Mapping (paper Algorithm 1).

Selects, among the *working set* (active cores) that have no task
assigned, the core with the highest *idle score* — the sum of its last
eight idle durations (the same rolling window the Linux cpuidle governor
keeps).  A mostly-idle core is an inexpensive estimate of a lesser-aged
core, so stress is distributed least-aged-first without CPU profiling.

These functions are the *reference* implementation of Algorithm 1: the
event-loop hot path in `CoreManager` answers the same argmax from an
incrementally-maintained idle-score array + lazy free-core heap
(`CoreView.best_idle_core`), and tests/test_fastpath.py pins the two
against each other bit-exactly.
"""
from __future__ import annotations

import numpy as np

IDLE_HISTORY_LEN = 8  # paper: "last eight idle durations", like cpuidle


def idle_scores(idle_history: np.ndarray) -> np.ndarray:
    """Sum the rolling idle-duration window per core. (N, 8) -> (N,)."""
    return idle_history.sum(axis=-1)


def select_core(
    active_mask: np.ndarray,
    task_assigned: np.ndarray,
    idle_history: np.ndarray,
) -> int:
    """Algorithm 1. Returns the selected core index, or -1 if none free.

    Args:
      active_mask:   (N,) bool — core is in the working set (C0).
      task_assigned: (N,) bool — core already runs an inference task.
      idle_history:  (N, IDLE_HISTORY_LEN) float seconds.
    """
    candidates = active_mask & ~task_assigned
    if not candidates.any():
        return -1
    scores = idle_scores(idle_history)
    # Non-candidates must never win the argmax.
    masked = np.where(candidates, scores, -np.inf)
    return int(np.argmax(masked))


def record_idle_end(idle_history: np.ndarray, hist_pos: np.ndarray,
                    core: int, idle_duration: float) -> None:
    """Push a finished idle period into the core's rolling window."""
    idle_history[core, hist_pos[core] % IDLE_HISTORY_LEN] = idle_duration
    hist_pos[core] += 1
