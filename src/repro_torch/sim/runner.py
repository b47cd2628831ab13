"""Experiment runner of the port: replay a workload scenario against the
fleet engine under a policy (the counterpart of `repro.sim.runner`).

    cfg = ExperimentConfig(duration_s=60.0).with_engine("fleet")
    result = run_experiment(cfg)            # torch backend, on CUDA
    sweep = run_policy_sweep(cfg, policies=("linux", "proposed"))

Only `engine="fleet"` is ported. The event engine and telemetry raise
NotImplementedError here, and what the fleet engine does not run yet
raises there (`repro_torch.sim.fleetsim.FleetEngine`), each naming its
ROADMAP item, rather than falling back to anything.
"""
from __future__ import annotations

from repro_torch.carbon import get_carbon_model
from repro_torch.hardware.inventory import canonical_fleet_name, resolve_fleet
from repro_torch.power import get_power_model
from repro_torch.power.registry import canonical_power_model_name
from repro_torch.registry import canonical_name
from repro_torch.sim.config import ExperimentConfig
from repro_torch.sim.fleetsim import run_fleet_experiment
from repro_torch.sim.results import ExperimentResult, SweepResult
from repro_torch.workloads import canonical_scenario_name, get_scenario

DEFAULT_SWEEP = ("linux", "least-aged", "proposed")


def run_experiment(cfg: ExperimentConfig,
                   telemetry=None) -> ExperimentResult:
    if not isinstance(cfg, ExperimentConfig):
        raise TypeError(
            "run_experiment takes an ExperimentConfig (the pre-registry "
            "run_experiment(policy, **kwargs) signature was removed); "
            f"got {cfg!r}")
    if cfg.engine != "fleet":
        raise NotImplementedError(
            f"engine={cfg.engine!r} is not ported yet: ROADMAP A3/A5 "
            f"(event engine); use cfg.with_engine('fleet')")
    if telemetry is not None or cfg.telemetry:
        raise NotImplementedError(
            "telemetry is not ported yet: ROADMAP A5 (telemetry)")
    # Resolve every axis up front so a typo'd name fails before the
    # simulation runs; the resolved models are handed on.
    carbon_model = get_carbon_model(cfg.carbon_model, **cfg.carbon_options)
    power_model = get_power_model(cfg.power_model, **cfg.power_options)
    scenario = get_scenario(cfg.scenario, **cfg.scenario_options)
    resolve_fleet(cfg.fleet, cfg.fleet_options, cfg.n_machines)
    return run_fleet_experiment(cfg, carbon_model=carbon_model,
                                power_model=power_model,
                                scenario=scenario)


def run_policy_sweep(
    cfg: ExperimentConfig | None = None,
    policies=DEFAULT_SWEEP,
    scenarios=None,
    routers=None,
    power_models=None,
    fault_models=None,
    fleets=None,
) -> SweepResult:
    """Run the same experiment across policies (x scenarios x routers
    x power models x fault models x fleets), keyed as
    `repro.sim.runner.run_policy_sweep` keys them. With every axis but
    policies left at None the result is keyed by policy name; each axis
    given appends its part of the key. Cells run one after another in
    this process (the reference's `parallel=` pool is not ported).
    Without `cfg`, the default config runs on the fleet engine."""
    if cfg is None:
        cfg = ExperimentConfig().with_engine("fleet")
    scenario_axis = scenarios is not None
    router_axis = routers is not None
    power_axis = power_models is not None
    fault_axis = fault_models is not None
    fleet_axis = fleets is not None
    axes = (("policy",)
            + (("scenario",) if scenario_axis else ())
            + (("router",) if router_axis else ())
            + (("power_model",) if power_axis else ())
            + (("fault_model",) if fault_axis else ())
            + (("fleet",) if fleet_axis else ()))
    cells: list[tuple[object, ExperimentConfig]] = []
    for s in (scenarios if scenario_axis else (cfg.scenario,)):
        s_name = canonical_scenario_name(s)
        s_cfg = cfg if s_name == cfg.scenario else cfg.with_scenario(s_name)
        for r in (routers if router_axis else (cfg.router,)):
            r_name = canonical_name(r)
            r_cfg = s_cfg if r_name == s_cfg.router \
                else s_cfg.with_router(r_name)
            for w in (power_models if power_axis else (cfg.power_model,)):
                w_name = canonical_power_model_name(w)
                w_cfg = r_cfg if w_name == r_cfg.power_model \
                    else r_cfg.with_power_model(w_name)
                for fm in (fault_models if fault_axis
                           else (cfg.fault_model,)):
                    f_name = canonical_name(fm)
                    f_cfg = w_cfg if f_name == w_cfg.fault_model \
                        else w_cfg.with_fault_model(f_name)
                    for fl in (fleets if fleet_axis else (cfg.fleet,)):
                        fl_name = canonical_fleet_name(fl)
                        fl_cfg = f_cfg if fl_name == f_cfg.fleet \
                            else f_cfg.with_fleet(fl_name)
                        for p in policies:
                            run_cfg = _with_policy(fl_cfg, p)
                            key = ((run_cfg.policy,)
                                   + ((s_name,) if scenario_axis else ())
                                   + ((r_name,) if router_axis else ())
                                   + ((w_name,) if power_axis else ())
                                   + ((f_name,) if fault_axis else ())
                                   + ((fl_name,) if fleet_axis else ()))
                            cells.append((key if len(key) > 1 else key[0],
                                          run_cfg))
    return SweepResult(((key, run_experiment(run_cfg))
                        for key, run_cfg in cells), axes=axes)


def _with_policy(cfg: ExperimentConfig, policy) -> ExperimentConfig:
    name = canonical_name(policy)
    return cfg if name == cfg.policy else cfg.with_policy(name)
