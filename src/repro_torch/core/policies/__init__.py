"""Pluggable task-to-core management policies.

Built-ins (importing this package registers them):

  proposed     — paper Algorithms 1+2 (idle-score mapping + selective idling)
  linux        — probabilistic stock-Linux placement model (§6.1.1)
  least-aged   — Zhao'23 cumulative-work baseline
  round-robin  — naive wear-leveling strawman
  aging-greedy — dVth-exact placement oracle (no idling)

Adding a policy:

    from repro_torch.core.policies import CorePolicy, register_policy

    @register_policy("my-policy")
    class MyPolicy(CorePolicy):
        def select_core(self, view):
            ...

then `CoreManager(n, policy="my-policy")` or
`ExperimentConfig(policy="my-policy")` picks it up by name.
"""
from repro_torch.core.policies.base import CorePolicy, CoreView, IdleCorrection
from repro_torch.core.policies.registry import (available_policies,
                                          canonical_policy_name, get_policy,
                                          register_policy)

# Import built-ins for their @register_policy side effects.
from repro_torch.core.policies import aging_greedy as _aging_greedy  # noqa: F401
from repro_torch.core.policies import least_aged as _least_aged      # noqa: F401
from repro_torch.core.policies import linux as _linux                # noqa: F401
from repro_torch.core.policies import proposed as _proposed          # noqa: F401
from repro_torch.core.policies import round_robin as _round_robin    # noqa: F401

__all__ = [
    "CorePolicy", "CoreView", "IdleCorrection", "available_policies",
    "canonical_policy_name", "get_policy", "register_policy",
]
