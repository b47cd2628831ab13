"""Core temperature model (paper Table 1, derived from Fig. 4).

The paper measures an Intel Xeon while toggling cores between C0/C6:

    | Idle-state | C-state | Inference task | Temperature |
    | Active     | C0      | Allocated      | 54.00 C     |
    | Active     | C0      | Unallocated    | 51.08 C     |
    | Deep idle  | C6      | N/A            | 48.00 C     |

Stress Y follows the paper's worst-case assumption: any executing work
(inference task, or OS time-sharing system tasks on unallocated active
cores) applies Y = 1; power-gated C6 cores switch no transistors (Y = 0).
"""
from __future__ import annotations

import enum

import numpy as np


class CState(enum.IntEnum):
    ACTIVE = 0      # C0
    DEEP_IDLE = 1   # C6


TEMP_ACTIVE_ALLOCATED_C = 54.0
TEMP_ACTIVE_UNALLOCATED_C = 51.08
TEMP_DEEP_IDLE_C = 48.0

STRESS_ACTIVE = 1.0   # paper: worst-case stress for any active core
STRESS_DEEP_IDLE = 0.0


def core_temperature_c(c_state: CState, task_allocated: bool) -> float:
    if c_state == CState.DEEP_IDLE:
        return TEMP_DEEP_IDLE_C
    return TEMP_ACTIVE_ALLOCATED_C if task_allocated else TEMP_ACTIVE_UNALLOCATED_C


def core_stress(c_state: CState, task_allocated: bool) -> float:
    del task_allocated  # worst-case: active cores always stressed (OS tasks)
    return STRESS_DEEP_IDLE if c_state == CState.DEEP_IDLE else STRESS_ACTIVE


def regime_arrays(c_state, task_allocated):
    """Vectorized Table-1 regimes: (temps_C, stress) arrays from per-core
    C-states and allocation flags. Both `CoreManager._settled_dvth` and
    the fleet-batched settler (`repro.sim.fleetstate`) derive regimes
    through this one helper — their outputs must stay byte-identical for
    batched settlement to remain bit-exact with per-machine settlement.

    Args:
      c_state:        (...,) int array of `CState` values.
      task_allocated: (...,) bool array — core currently runs a task.
    """
    active = np.asarray(c_state) == CState.ACTIVE
    temps = np.where(
        active,
        np.where(task_allocated, TEMP_ACTIVE_ALLOCATED_C,
                 TEMP_ACTIVE_UNALLOCATED_C),
        TEMP_DEEP_IDLE_C,
    )
    stress = np.where(active, STRESS_ACTIVE, STRESS_DEEP_IDLE)
    return temps, stress
