"""String-keyed registry of workload scenarios (mirrors
`repro.core.policies.registry`).

    @register_scenario("conversation-poisson")
    def conversation_poisson() -> Scenario: ...

    sc = get_scenario("conversation-poisson")       # fresh scenario
    sc = get_scenario("conversation-mmpp", burst_factor=8.0)

Names are case-insensitive and underscore/hyphen-insensitive. Factories
(not instances) are registered so every `get_scenario` call can take
constructor options and returns an independent scenario object.

The mechanics live in the shared `repro.registry.Registry` (one
implementation for the policy / scenario / router axes).
"""
from __future__ import annotations

from repro_torch.registry import Registry, canonical_name
from repro_torch.workloads.base import WorkloadScenario


def _check_scenario(key: str, scenario):
    if not isinstance(scenario, WorkloadScenario):
        raise TypeError(f"scenario factory for {key!r} returned "
                        f"{scenario!r}, which lacks generate()/name")
    return scenario


_SCENARIOS = Registry(
    noun="scenario", kind="workload scenario",
    decorator="register_scenario", expects="callable factory",
    check=callable, set_name=False, quote_prev=True,
    post_get=_check_scenario,
)
#: historical module-level alias (tests clean up through it)
_REGISTRY = _SCENARIOS.store


def canonical_scenario_name(name: str) -> str:
    """Normalize a user-supplied scenario key ("Conv_Poisson" style)."""
    return canonical_name(name)


def register_scenario(name: str):
    """Decorator: register a factory returning a `WorkloadScenario`."""
    return _SCENARIOS.register(name)


def get_scenario(name: str, **opts) -> WorkloadScenario:
    """Build the scenario registered under `name` with `opts`."""
    return _SCENARIOS.get(name, **opts)


def available_scenarios() -> tuple[str, ...]:
    """Sorted canonical names of every registered scenario."""
    return _SCENARIOS.available()
