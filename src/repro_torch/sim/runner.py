"""Experiment runner of the port: replay a workload scenario against a
cluster under a policy (the counterpart of `repro.sim.runner`).

    cfg = ExperimentConfig(duration_s=60.0)
    result = run_experiment(cfg)            # the event engine, host numpy
    fleet = run_experiment(cfg.with_engine("fleet"))   # torch, on CUDA
    sweep = run_policy_sweep(cfg, policies=("linux", "proposed"))

`engine="event"` (the default, as in the reference) runs the bit-exact
event loop of `repro_torch.sim.cluster` and `collect`s its result;
`engine="fleet"` runs the vectorized fleet engine. Both run every
built-in fault model (`repro_torch.faults`) and record into a telemetry
hub (`repro_torch.telemetry`) when `cfg.telemetry` is set or the caller
passes one. On the event engine the result then carries the hub's
`summary()` and, with `export_dir` in `telemetry_opts`, its exports. On
the fleet engine the hub is filled but, as in the reference, the result
carries no summary and nothing is exported (ROADMAP R7).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import multiprocessing
import os
import time

from repro_torch.carbon import get_carbon_model
from repro_torch.core.policies import canonical_policy_name
from repro_torch.faults.registry import (canonical_fault_model_name,
                                         get_fault_model)
from repro_torch.hardware.inventory import canonical_fleet_name, resolve_fleet
from repro_torch.power import get_power_model
from repro_torch.power.registry import canonical_power_model_name
from repro_torch.sim.cluster import Cluster
from repro_torch.sim.config import ExperimentConfig
from repro_torch.sim.fleetsim import run_fleet_experiment
from repro_torch.sim.metrics import collect
from repro_torch.sim.results import ExperimentResult, SweepResult
from repro_torch.sim.routing import canonical_router_name
from repro_torch.telemetry import TelemetryHub, export_run
from repro_torch.workloads import canonical_scenario_name, get_scenario

DEFAULT_SWEEP = ("linux", "least-aged", "proposed")


def run_experiment(cfg: ExperimentConfig,
                   telemetry=None) -> ExperimentResult:
    if not isinstance(cfg, ExperimentConfig):
        raise TypeError(
            "run_experiment takes an ExperimentConfig (the pre-registry "
            "run_experiment(policy, **kwargs) signature was removed); "
            f"got {cfg!r}")
    # `cfg.telemetry=True` builds a hub from `cfg.telemetry_opts`; a
    # caller-supplied hub wins (so a long-lived hub can span several
    # runs). None = zero-cost off.
    hub = telemetry
    if hub is None and cfg.telemetry:
        hub = TelemetryHub.from_opts(cfg.telemetry_options)
    # Resolve every axis up front so a typo'd name fails before the
    # simulation runs; the resolved models are handed on.
    carbon_model = get_carbon_model(cfg.carbon_model, **cfg.carbon_options)
    power_model = get_power_model(cfg.power_model, **cfg.power_options)
    scenario = get_scenario(cfg.scenario, **cfg.scenario_options)
    # Fault axis fail-fast: instantiate once to validate name + opts
    # (the engines build their own per-machine instances).
    get_fault_model(cfg.fault_model, **cfg.fault_options)
    resolve_fleet(cfg.fleet, cfg.fleet_options, cfg.n_machines)
    if cfg.engine == "fleet":
        return run_fleet_experiment(cfg, telemetry=hub,
                                    carbon_model=carbon_model,
                                    power_model=power_model,
                                    scenario=scenario)
    if hub is None:
        trace = scenario.generate(rate_rps=cfg.rate_rps,
                                  duration_s=cfg.duration_s, seed=cfg.seed)
        cluster = Cluster(cfg)
        cluster.run(trace, cfg.duration_s,
                    sample_period_s=cfg.sample_period_s)
        return collect(cluster, cfg, carbon_model=carbon_model,
                       power_model=power_model)
    return _run_with_telemetry(cfg, hub, carbon_model, power_model,
                               scenario)


def _run_with_telemetry(cfg, hub, carbon_model, power_model,
                        scenario) -> ExperimentResult:
    """Telemetry-on path of the event engine: the same simulation, plus
    per-phase wall-time / event-loop-throughput gauges and the post-run
    export. Recording is pure observation, so the result's scalars stay
    bit-identical to the hub-less path."""
    def phase(name, fn):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        hub.set_gauge(f"phase/{name}_wall_s", dt)
        hub.event("phase", 0.0, phase=name, wall_s=dt)
        return out

    trace = phase("trace_gen", lambda: scenario.generate(
        rate_rps=cfg.rate_rps, duration_s=cfg.duration_s, seed=cfg.seed))
    cluster = phase("cluster_build", lambda: Cluster(cfg, telemetry=hub))
    # The aging settler's backend, as a gauge that keeps the reference's
    # name so the exports compare: 1.0 for the float32 accelerator
    # settler ("jax" there, "torch" here), 0.0 for the numpy one.
    backend = cluster.fleet_settler.backend
    hub.event("engine", 0.0, engine="event", aging_backend=backend)
    hub.set_gauge("engine/aging_backend_is_jax",
                  1.0 if backend == "torch" else 0.0)
    phase("sim_run", lambda: cluster.run(
        trace, cfg.duration_s, sample_period_s=cfg.sample_period_s))
    sim_wall = hub.gauge("phase/sim_run_wall_s").value
    hub.set_gauge("events_processed", cluster.queue.processed)
    if sim_wall > 0:
        hub.set_gauge("events_per_sec", cluster.queue.processed / sim_wall)
    result = phase("collect", lambda: collect(
        cluster, cfg, carbon_model=carbon_model, power_model=power_model,
        telemetry=hub))

    summary = hub.summary()
    export_dir = cfg.telemetry_options.get("export_dir")
    if export_dir:
        out_dir = os.path.join(str(export_dir),
                               f"{cfg.policy}-{cfg.fingerprint()}")
        summary["export"] = export_run(hub, out_dir, t_end=cfg.duration_s)
    return dataclasses.replace(result, telemetry_summary=summary)


def run_policy_sweep(
    cfg: ExperimentConfig | None = None,
    policies=DEFAULT_SWEEP,
    scenarios=None,
    routers=None,
    power_models=None,
    fault_models=None,
    fleets=None,
    parallel: int | None = None,
) -> SweepResult:
    """Run the same experiment across policies (x scenarios x routers
    x power models x fault models x fleets), keyed as
    `repro.sim.runner.run_policy_sweep` keys them. With every axis but
    policies left at None the result is keyed by policy name; each axis
    given appends its part of the key. Without `cfg`, the default config
    runs (the event engine, as in the reference).

    `parallel=N` fans the grid's cells across a process pool of N
    workers. Every cell's seeding is carried by its frozen
    `ExperimentConfig`, so the result equals the serial sweep, key for
    key, whatever the worker count or completion order. The pool starts
    its workers with `spawn`, never `fork`: a child forked after its
    parent initialised CUDA cannot use CUDA (the torch fleet backend's
    cells), and forking a process with threads, as torch's, may
    deadlock. So policies, scenarios or routers registered at run time
    (not in an imported module) are unknown to the workers; the
    reference's `fork` pool sees them.
    """
    if cfg is None:
        cfg = ExperimentConfig()
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
            r_name = canonical_router_name(r)
            r_cfg = s_cfg if r_name == s_cfg.router \
                else s_cfg.with_router(r_name)
            for w in (power_models if power_axis else (cfg.power_model,)):
                w_name = canonical_power_model_name(w)
                w_cfg = r_cfg if w_name == r_cfg.power_model \
                    else r_cfg.with_power_model(w_name)
                for fm in (fault_models if fault_axis
                           else (cfg.fault_model,)):
                    f_name = canonical_fault_model_name(fm)
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
    if parallel is not None and int(parallel) > 1 and len(cells) > 1:
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=int(parallel),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            # `map` preserves submission order, so keys zip back exactly.
            results = list(pool.map(run_experiment,
                                    [c for _, c in cells]))
        return SweepResult(zip([k for k, _ in cells], results), axes=axes)
    return SweepResult(((key, run_experiment(run_cfg))
                        for key, run_cfg in cells), axes=axes)


def _with_policy(cfg: ExperimentConfig, policy) -> ExperimentConfig:
    name = canonical_policy_name(policy)
    return cfg if name == cfg.policy else cfg.with_policy(name)
