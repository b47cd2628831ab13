"""Pluggable workload-scenario subsystem (paper §6.1.2 opened wide).

The paper evaluates against replayed Azure LLM inference traces with
distinct temporal patterns; this package makes the workload axis
pluggable the same way `repro.core.policies` made the policy axis
pluggable. Three composable layers:

  arrivals  — *when* requests land (Poisson, diurnal, MMPP bursts,
              flash crowd, constant-rate)
  mixes     — *how big* requests are (Splitwise conversation / code,
              long-context, blends)
  traceio   — ingest/replay/export real traces in the Azure CSV schema

and a string-keyed registry of named scenarios:

    from repro_torch.workloads import get_scenario, available_scenarios

    trace = get_scenario("conversation-mmpp").generate(
        rate_rps=60, duration_s=120, seed=0)

Experiments select scenarios by name: `ExperimentConfig(scenario=...)`,
and `run_policy_sweep(..., scenarios=(...))` runs policy x scenario
grids. Adding a scenario:

    from repro_torch.workloads import Scenario, register_scenario, mixes

    @register_scenario("my-scenario")
    def my_scenario() -> Scenario:
        return Scenario("my-scenario", mixes.CONVERSATION, my_arrivals)
"""
from repro_torch.workloads import arrivals, mixes, traceio
from repro_torch.workloads.base import (ArrivalProcess, Request, TokenMix,
                                  WorkloadScenario, request_stats)
from repro_torch.workloads.registry import (available_scenarios,
                                      canonical_scenario_name, get_scenario,
                                      register_scenario)
# Importing the module registers the built-in scenario library.
from repro_torch.workloads.scenario import Scenario
from repro_torch.workloads.traceio import (ReplayScenario, export_csv,
                                     export_csv_str, load_csv, rescale_rate,
                                     splice, time_scale)

__all__ = [
    "ArrivalProcess", "Request", "TokenMix", "WorkloadScenario",
    "request_stats", "available_scenarios", "canonical_scenario_name",
    "get_scenario", "register_scenario", "Scenario", "ReplayScenario",
    "export_csv", "export_csv_str", "load_csv", "rescale_rate", "splice",
    "time_scale", "arrivals", "mixes", "traceio",
]
