"""The simulator of the port (the counterpart of `repro.sim`): the
event engine (`Cluster` and its machines, routing, the batched aging
settler, `collect`) and the vectorized fleet engine, with their config,
results and runner.

Workloads come from `repro_torch.workloads` (`Request` is re-exported
here for convenience); carbon accounting from `repro_torch.carbon`;
fault injection from `repro_torch.faults` and telemetry from
`repro_torch.telemetry`, on both engines.
"""
from repro_torch.sim.cluster import (Cluster, Machine, PromptInstance,
                                     TokenInstance)
from repro_torch.sim.config import ExperimentConfig
from repro_torch.sim.events import EventQueue
from repro_torch.sim.fleetsim import (FleetEngine, run_fleet_experiment,
                                      state_from_numpy, state_to_numpy)
from repro_torch.sim.fleetstate import (FleetAgingSettler,
                                        GroupedAgingSettler, settle_fleet)
from repro_torch.sim.metrics import (PERCENTILES, carbon_comparison,
                                     collect, price_and_build)
from repro_torch.sim.results import ExperimentResult, Provenance, SweepResult
from repro_torch.sim.routing import (ClusterRouter, FleetView, MachineAging,
                                     available_routers,
                                     canonical_router_name, get_router,
                                     register_router)
from repro_torch.sim.runner import (DEFAULT_SWEEP, run_experiment,
                                    run_policy_sweep)
from repro_torch.sim.tasks import CPUTask, TASK_DURATIONS_S, TaskIdAllocator
from repro_torch.workloads import Request

#: historical alias — `ExperimentMetrics` became the frozen,
#: serializable `ExperimentResult` (same field names).
ExperimentMetrics = ExperimentResult

__all__ = [
    "Cluster", "Machine", "PromptInstance", "TokenInstance", "EventQueue",
    "ExperimentConfig", "ExperimentMetrics", "ExperimentResult",
    "Provenance", "SweepResult", "FleetAgingSettler", "GroupedAgingSettler",
    "settle_fleet", "PERCENTILES", "carbon_comparison", "collect",
    "price_and_build", "ClusterRouter", "FleetView", "MachineAging",
    "available_routers", "canonical_router_name", "get_router",
    "register_router", "FleetEngine", "run_fleet_experiment",
    "state_from_numpy", "state_to_numpy", "DEFAULT_SWEEP", "run_experiment",
    "run_policy_sweep", "CPUTask", "TASK_DURATIONS_S", "TaskIdAllocator",
    "Request",
]
