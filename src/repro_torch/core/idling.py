"""Selective Core Idling (paper Algorithm 2) and its reaction function.

Periodically sizes the dynamic *working set* of C0 cores to the current
inference throughput.  The controller computes a normalized error

    e = (N - C_sleep - T) / N,   T = min(N, assigned + oversubscribed)

(positive => spare active cores => underutilization; negative =>
oversubscription) and maps it through an asymmetric piecewise reaction
function:

    F(e) = tan(0.785 * e)     e >= 0   (slow: aging is a long-term effect)
    F(e) = arctan(1.55 * e)   e <  0   (fast: latency impact is immediate)

The scaled correction int(N * F(e)) is the number of cores to put to deep
idle (positive, most-aged first) or wake up (negative, least-aged first) —
both orderings complement the even-out behaviour of Algorithm 1.
"""
from __future__ import annotations

import math

import numpy as np

UNDERUTIL_GAIN = 0.785   # tan gain   (paper Alg. 2 line 11)
OVERSUB_GAIN = 1.55      # arctan gain (paper Alg. 2 line 13)


def reaction_function(e_norm: float) -> float:
    """Piecewise reaction F: [-1, 1] -> (-1, 1). See module docstring."""
    if e_norm >= 0.0:
        return math.tan(UNDERUTIL_GAIN * e_norm)
    return math.atan(OVERSUB_GAIN * e_norm)


def core_correction(
    total_cores: int,
    active_cores: int,
    assigned_tasks: int,
    oversub_tasks: int,
) -> int:
    """Algorithm 2 lines 1-17: number of cores to idle (+) or wake (-)."""
    n = total_cores
    c_sleep = n - active_cores
    tasks = min(n, assigned_tasks + oversub_tasks)
    e = (n - c_sleep - tasks) / n
    return int(n * reaction_function(e))


def temporal_adjustment(
    correction: int,
    intensity_now: float,
    intensity_mean: float,
    oversub_tasks: int,
    dirty_frac: float = 1.05,
    defer_frac: float = 0.5,
    guard_tasks: int = 2,
    gate_gain: float = 2.0,
) -> int:
    """Carbon-aware temporal reshaping of Algorithm 2's correction.

    During *dirty-grid* hours (`intensity_now > dirty_frac *
    intensity_mean`) the controller leans harder into deep idling:
    gating corrections are amplified (`gate_gain`), and wake-up
    corrections are partially deferred (`defer_frac` of the requested
    wakes held back) so cores stay power-gated — not aging, not burning
    watts — until the grid is cleaner. The p99-latency guard: deferral
    only applies while at most `guard_tasks` tasks are oversubscribed;
    beyond that, latency is already at stake and every requested wake
    goes through. Clean hours pass the correction through unchanged,
    so the reaction function's steady-state behaviour is untouched.
    """
    if correction == 0 or intensity_now <= dirty_frac * intensity_mean:
        return correction
    if correction > 0:
        return int(correction * gate_gain)
    if oversub_tasks > guard_tasks:
        return correction
    return correction + int(-correction * defer_frac)


def apply_correction(
    correction: int,
    active_mask: np.ndarray,
    task_assigned: np.ndarray,
    age_key: np.ndarray,
    failed_mask: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Algorithm 2 lines 18-22: flip idle states, aging-aware ordering.

    Args:
      correction: +k => put k cores to deep idle; -k => wake k cores.
      active_mask: (N,) bool, True = C0.
      task_assigned: (N,) bool; cores running a task are never idled.
      age_key: (N,) float, larger = more aged (we use dVth directly — the
        periodic path may read accurate aging-sensor data, paper §5).
      failed_mask: optional (N,) bool of permanently-failed cores
        (`repro.faults`); a failed core is parked in deep idle and must
        never be woken. None (or all-False) leaves the selection
        identical to the pre-fault behavior.

    Returns (indices_to_idle, indices_to_wake); caller mutates state so it
    can also account idle-history bookkeeping and timestamps.
    """
    if correction > 0:
        # Most-aged-first among active cores without a task (failed
        # cores are never active, so no extra mask is needed here).
        cand = np.flatnonzero(active_mask & ~task_assigned)
        order = cand[np.argsort(-age_key[cand], kind="stable")]
        return order[:correction], np.empty(0, dtype=np.int64)
    if correction < 0:
        # Least-aged-first among deep-idle survivors.
        idle = ~active_mask if failed_mask is None \
            else ~active_mask & ~failed_mask
        cand = np.flatnonzero(idle)
        order = cand[np.argsort(age_key[cand], kind="stable")]
        return np.empty(0, dtype=np.int64), order[: -correction]
    empty = np.empty(0, dtype=np.int64)
    return empty, empty
