"""The paper's primary contribution, ported: aging-aware CPU core
management (copies of `repro.core`, numpy float64 on the host).

  aging       — NBTI reaction-diffusion physics (Eq. 1, 2, recursion)
  variation   — process-variation f0 sampling
  temperature — Table-1 C-state temperature/stress model
  mapping     — Algorithm 1 (Task-to-Core Mapping)
  idling      — Algorithm 2 (Selective Core Idling + reaction function)
  policies    — pluggable CorePolicy registry (proposed, linux,
                least-aged, round-robin, aging-greedy, + user-defined)
  manager     — policy-agnostic CoreManager runtime
  carbon      — compatibility re-export of `repro_torch.carbon`
"""
from repro_torch.core import (aging, carbon, idling, mapping, policies,
                              temperature, variation)
from repro_torch.core.manager import (OVERSUBSCRIBED, CoreManager,
                                      ManagerMetrics)
from repro_torch.core.policies import (CorePolicy, CoreView, IdleCorrection,
                                       available_policies, get_policy,
                                       register_policy)

__all__ = [
    "aging", "carbon", "idling", "mapping", "policies", "temperature",
    "variation", "CoreManager", "ManagerMetrics", "OVERSUBSCRIBED",
    "CorePolicy", "CoreView", "IdleCorrection", "available_policies",
    "get_policy", "register_policy",
]
