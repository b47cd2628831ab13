"""The simulator of the port: the vectorized fleet engine with its
config, results, metrics and runner (the counterparts of `repro.sim`).

The event engine (`Cluster` and its machines, routing, the batched
aging settler and telemetry) joins with ROADMAP A3/A5.
"""
from repro_torch.sim.config import ExperimentConfig
from repro_torch.sim.fleetsim import (FleetEngine, run_fleet_experiment,
                                      state_from_numpy, state_to_numpy)
from repro_torch.sim.metrics import (PERCENTILES, carbon_comparison,
                                     price_and_build)
from repro_torch.sim.results import ExperimentResult, Provenance, SweepResult
from repro_torch.sim.runner import (DEFAULT_SWEEP, run_experiment,
                                    run_policy_sweep)
from repro_torch.sim.tasks import CPUTask, TASK_DURATIONS_S, TaskIdAllocator
from repro_torch.workloads import Request

__all__ = [
    "ExperimentConfig", "ExperimentResult", "Provenance", "SweepResult",
    "FleetEngine", "run_fleet_experiment", "state_from_numpy",
    "state_to_numpy", "PERCENTILES", "carbon_comparison",
    "price_and_build", "DEFAULT_SWEEP", "run_experiment",
    "run_policy_sweep", "CPUTask", "TASK_DURATIONS_S", "TaskIdAllocator",
    "Request",
]
