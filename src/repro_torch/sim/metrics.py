"""Metric aggregation shared by the engines (paper §6.1.3), copied
from `repro.sim.metrics`.

`collect` reads a finished event-engine `Cluster` (its fault layer's
robustness scalars included), and the fleet engine feeds stacked arrays;
both go through `price_and_build`, which prices per-machine aging and
state residencies into the frozen `ExperimentResult` and, given a
telemetry hub, writes the fleet's per-window carbon rows into it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.carbon import get_carbon_model, reference_degradation
from repro_torch.carbon.base import CarbonModel, LifetimeEstimate
from repro_torch.carbon.intensity import ConstantIntensity
from repro_torch.carbon.models import HOURS_PER_YEAR
from repro_torch.power import get_power_model
from repro_torch.power.base import PowerModel
from repro_torch.sim.config import ExperimentConfig
from repro_torch.sim.results import ExperimentResult, Provenance

PERCENTILES = (1, 25, 50, 75, 90, 99)
_SECONDS_PER_YEAR = HOURS_PER_YEAR * 3600.0


def _role_weighted_cv(degs: np.ndarray, n_prompt: int) -> float:
    """Cross-machine degradation CV within each serving role, weighted
    by machine count (see `ExperimentResult.fleet_degradation_cv`)."""
    parts = []
    for group in (degs[:n_prompt], degs[n_prompt:]):
        mean = float(group.mean()) if len(group) else 0.0
        if mean > 0:
            parts.append((len(group), float(group.std()) / mean))
    if not parts:
        return float("nan")
    total = sum(n for n, _ in parts)
    return sum(n * cv for n, cv in parts) / total


def collect(cluster, cfg: ExperimentConfig,
            carbon_model: CarbonModel | None = None,
            power_model: PowerModel | None = None,
            telemetry=None) -> ExperimentResult:
    """Aggregate a finished `repro_torch.sim.cluster.Cluster` run into an
    `ExperimentResult` (the counterpart of `repro.sim.metrics.collect`).

    `carbon_model` / `power_model` let a caller that already resolved
    `cfg.carbon_model` / `cfg.power_model` pass them in instead of
    constructing them twice. With a fault model other than "none" the
    cluster's `FaultCoordinator` supplies the robustness scalars.
    `telemetry` (a `repro_torch.telemetry.TelemetryHub`) additionally
    receives the fleet's per-window power / energy / intensity /
    operational-carbon rows.
    """
    cvs, degs, idle_all = [], [], []
    task_samples = []
    for m in cluster.machines:
        snap = m.manager.snapshot()
        cvs.append(snap["cv"])
        degs.append(snap["mean_degradation"])
        idle_all.extend(m.manager.metrics.idle_norm_samples)
        task_samples.append(np.asarray(m.task_count_samples))
    cvs = np.asarray(cvs)
    degs = np.asarray(degs)
    idle_all = np.asarray(idle_all) if idle_all else np.zeros(1)
    # The cluster observed each completion as it happened; in exact mode
    # the aggregate evaluates the same numpy expressions over the same
    # sample order a per-request array would. When nothing completed it
    # reports NaN, not a fabricated perfect latency of 0.0.
    mean_latency = cluster.latency.mean()
    p99_latency = cluster.latency.percentile(99)
    all_tasks = np.concatenate(task_samples) if task_samples else np.zeros(1)

    elapsed = max(m.manager.now for m in cluster.machines)
    residencies = tuple(m.manager.residency() for m in cluster.machines)
    robustness = None
    if cluster.faults is not None:
        fc = cluster.faults
        robustness = fc.robustness(elapsed)
        # conservation residual: requests still in flight at the horizon
        robustness["pending_requests"] = (
            fc.submitted - cluster.completed_count
            - fc.failed_requests - fc.rejected_requests)
    return price_and_build(
        cfg,
        cvs=cvs,
        degs=degs,
        idle_norm_percentiles=percentile_dict(idle_all),
        oversub_frac_below=float((idle_all < -0.1).mean()),
        task_count_mean=float(all_tasks.mean()),
        task_count_max=int(all_tasks.max()),
        mean_latency_s=mean_latency,
        p99_latency_s=p99_latency,
        completed=cluster.completed_count,
        aging_params=cluster.machines[0].manager.params,
        elapsed=elapsed,
        residencies=residencies,
        robustness=robustness,
        per_machine_idle_norm=tuple(
            tuple(float(x) for x in m.manager.metrics.idle_norm_samples)
            for m in cluster.machines),
        per_machine_task_samples=tuple(
            tuple(int(x) for x in samples) for samples in task_samples),
        engine="event",
        carbon_model=carbon_model,
        power_model=power_model,
        fleet_inventory=cluster.inventory,
        telemetry=telemetry,
    )


def percentile_dict(x) -> dict[int, float]:
    """The result schema's standard percentile summary of a sample."""
    return {p: float(np.percentile(x, p)) for p in PERCENTILES}


def price_and_build(cfg: ExperimentConfig, *,
                    cvs, degs,
                    idle_norm_percentiles: dict[int, float],
                    oversub_frac_below: float,
                    task_count_mean: float, task_count_max: int,
                    mean_latency_s: float, p99_latency_s: float,
                    completed: int,
                    aging_params, elapsed: float,
                    residencies,
                    per_machine_idle_norm=None,
                    per_machine_task_samples=None,
                    engine: str = "event",
                    robustness: dict | None = None,
                    carbon_model: CarbonModel | None = None,
                    power_model: PowerModel | None = None,
                    fleet_inventory=None,
                    telemetry=None) -> ExperimentResult:
    """Price per-machine aging + residencies into carbon/power columns
    and assemble the `ExperimentResult`. Shared by both engines: the
    event path (`collect`, from a finished `Cluster`) and the fleet
    path (`repro.sim.fleetsim`, from stacked arrays) feed the same
    observables through the exact same pricing expressions, so a parity
    diff between engines compares simulation physics, not accounting.

    `fleet_inventory` (a `repro.hardware.FleetInventory`, None on the
    uniform default) switches pricing from fleet-wide constants to each
    machine's own SKU: per-SKU embodied figures and baseline lifespans
    on the carbon side, TDP-scaled power/energy, per-SKU aging
    references, and `t0_s`-phase-shifted intensity signals.
    """
    cvs = np.asarray(cvs)
    degs = np.asarray(degs)
    inv = fleet_inventory

    # Fleet-level aging imbalance + per-machine embodied carbon vs the
    # worst-case linear-aging reference at the same horizon, priced by
    # the experiment's configured carbon model.
    fleet_cv = _role_weighted_cv(degs, cfg.n_prompt)
    deg_ref = reference_degradation(aging_params, elapsed)
    model = carbon_model if carbon_model is not None else \
        get_carbon_model(cfg.carbon_model, **cfg.carbon_options)
    if inv is None:
        per_machine_carbon = tuple(
            model.lifetime(deg_ref, max(float(d), 0.0)) for d in degs)
    else:
        # Each machine prices against its own SKU: its embodied figure
        # and baseline lifespan, and the aging reference of its own
        # process corner (f_nominal enters the linear reference).
        models = inv.carbon_models(cfg.carbon_model, cfg.carbon_options)
        deg_refs = tuple(reference_degradation(p, elapsed)
                         for p in inv.aging_params)
        per_machine_carbon = tuple(
            models[i].lifetime(deg_refs[i], max(float(d), 0.0))
            for i, d in enumerate(degs))
    fleet_yearly = float(sum(e.yearly_kgco2eq for e in per_machine_carbon))

    # Operational side: price each machine's measured C-state residency
    # through the configured power model, and its energy through the
    # carbon model's grid intensity (flat world-average when the model
    # carries none) — window by window, so time-of-day carbon variation
    # genuinely reaches the headline numbers.
    power = power_model if power_model is not None else \
        get_power_model(cfg.power_model, **cfg.power_options)
    residencies = tuple(residencies)
    intensity = getattr(model, "intensity", None)
    if intensity is None:
        intensity = ConstantIntensity()
    if inv is None:
        energies = tuple(power.energy_kwh(r) for r in residencies)
        op_kg = float(sum(power.operational_g(r, intensity)
                          for r in residencies)) / 1000.0
    else:
        # TDP-scaled per SKU; operational carbon integrates against the
        # machine's own (possibly phase-shifted) intensity signal.
        energies = tuple(inv.power_scales[i] * power.energy_kwh(r)
                         for i, r in enumerate(residencies))
        op_kg = float(sum(
            inv.power_scales[i]
            * power.operational_g(r, inv.intensity_for(i, intensity))
            for i, r in enumerate(residencies))) / 1000.0
    fleet_energy = float(sum(energies))
    if elapsed > 0:
        yearly_op = op_kg * (_SECONDS_PER_YEAR / elapsed)
        mean_power_w = (fleet_energy * 3.6e6
                        / (elapsed * len(residencies)))
    else:
        yearly_op = mean_power_w = float("nan")

    if telemetry is not None:
        _emit_carbon_windows(telemetry, residencies, power, intensity)

    return ExperimentResult(
        policy=cfg.policy,
        num_cores=cfg.num_cores,
        rate_rps=cfg.rate_rps,
        scenario=cfg.scenario,
        freq_cv_percentiles=percentile_dict(cvs),
        mean_degradation_percentiles=percentile_dict(degs),
        idle_norm_percentiles=idle_norm_percentiles,
        oversub_frac_below=oversub_frac_below,
        task_count_mean=task_count_mean,
        task_count_max=task_count_max,
        mean_latency_s=mean_latency_s,
        p99_latency_s=p99_latency_s,
        completed=completed,
        router=cfg.router,
        carbon_model=cfg.carbon_model,
        carbon_opts=cfg.carbon_opts,
        fleet_degradation_cv=fleet_cv,
        per_machine_carbon=per_machine_carbon,
        fleet_yearly_kgco2eq=fleet_yearly,
        deg_reference=float(deg_ref),
        power_model=cfg.power_model,
        power_opts=cfg.power_opts,
        per_machine_energy_kwh=energies,
        per_machine_residency=residencies,
        fleet_energy_kwh=fleet_energy,
        mean_machine_power_w=mean_power_w,
        fleet_operational_kgco2eq=op_kg,
        fleet_yearly_operational_kgco2eq=yearly_op,
        fleet_yearly_total_kgco2eq=fleet_yearly + yearly_op,
        per_machine_cv=tuple(float(x) for x in cvs),
        per_machine_degradation=tuple(float(x) for x in degs),
        per_machine_idle_norm=per_machine_idle_norm,
        per_machine_task_samples=per_machine_task_samples,
        engine=engine,
        fault_model=cfg.fault_model,
        fault_opts=cfg.fault_opts,
        fleet=cfg.fleet,
        fleet_opts=cfg.fleet_opts,
        per_machine_sku=(None if inv is None else inv.sku_names),
        **(robustness or {}),
        provenance=Provenance(config_hash=cfg.fingerprint(),
                              seed=cfg.seed),
    )


def _emit_carbon_windows(telemetry, residencies, power, intensity) -> None:
    """Fleet per-window power/energy/intensity/operational-carbon rows
    into the hub's `fleet/carbon_windows` timeline — the same windowed
    integral `operational_g` prices, kept visible instead of collapsed
    to one scalar. Row layout: `(window_s, fleet_power_w, energy_kwh,
    g_per_kwh, operational_g)`; pure reads of frozen residencies."""
    fleet: dict[float, list[float]] = {}    # t_start -> [elapsed, joules]
    for r in residencies:
        f = r.mean_busy_frequency
        n = r.num_cores
        for t_start, elapsed, bf, if_, gf in r.iter_windows():
            w = fleet.setdefault(t_start, [0.0, 0.0])
            w[0] = max(w[0], elapsed)
            w[1] += power.machine_power_w(bf, if_, gf, f, n) * elapsed
    tl = telemetry.timeline("fleet/carbon_windows",
                            maxlen=max(len(fleet), 1))
    for t_start in sorted(fleet):
        elapsed, joules = fleet[t_start]
        g = intensity.g_per_kwh(t_start + 0.5 * elapsed)
        kwh = joules / 3.6e6
        power_w = joules / elapsed if elapsed > 0 else 0.0
        tl.record(t_start, (elapsed, power_w, kwh, g, kwh * g))


def carbon_comparison(linux_metrics: ExperimentResult,
                      technique_metrics: ExperimentResult,
                      percentile: int = 99,
                      model: str | CarbonModel | None = None,
                      ) -> LifetimeEstimate:
    """Fig. 7: estimate yearly embodied carbon from the p-th percentile of
    mean-frequency-degradation performance (paper uses p99 and p50).

    `model` selects the carbon model (registry name or instance); the
    default honours the technique result's own `carbon_model` *and*
    `carbon_opts`, so a sweep run under `reliability-threshold` — or a
    custom `embodied_kg` — is compared under exactly that pricing. A
    name passed explicitly is built with default opts.
    """
    if model is None:
        model = get_carbon_model(technique_metrics.carbon_model,
                                 **dict(technique_metrics.carbon_opts))
    elif not isinstance(model, CarbonModel):
        model = get_carbon_model(model)
    deg_linux = linux_metrics.mean_degradation_percentiles[percentile]
    deg_tech = technique_metrics.mean_degradation_percentiles[percentile]
    return model.lifetime(deg_linux, deg_tech)
