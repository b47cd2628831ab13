"""Reproduce the paper's headline numbers end-to-end and print a report:
37.67% yearly embodied carbon reduction (p99), 77% less underutilization,
<10% oversubscription.

  PYTHONPATH=src python examples_torch/carbon_report.py [--duration 300]
      [--carbon-model reliability-threshold] [--power-model minmax-linear]
      [--save sweep.json]

`--carbon-model` re-prices the aging data under any registered
`repro_torch.carbon` model; `--power-model` prices per-core state
residencies into measured energy/operational carbon under any registered
`repro_torch.power` model; `--save` persists the whole sweep as a
`SweepResult` JSON that `repro_torch.sim.SweepResult.load` restores
losslessly (provenance included) for cross-run diffs.

The sweep runs the event engine on the host (numpy), as
`examples/carbon_report.py` does on the reference, and prints its
report lines letter for letter.
"""
import argparse

from repro_torch.carbon import get_carbon_model
from repro_torch.carbon.models import HOURS_PER_YEAR
from repro_torch.sim import (ExperimentConfig, carbon_comparison,
                             run_policy_sweep)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--rate", type=float, default=70.0)
    ap.add_argument("--cores", type=int, default=40)
    ap.add_argument("--router", default="jsq",
                    help="cluster request router (see "
                    "repro_torch.sim.available_routers())")
    ap.add_argument("--carbon-model", default="linear-extension",
                    help="carbon-accounting model (see "
                    "repro_torch.carbon.available_carbon_models())")
    ap.add_argument("--power-model", default="flat-tdp",
                    help="power model pricing per-core residencies into "
                    "energy (see "
                    "repro_torch.power.available_power_models())")
    ap.add_argument("--intensity", type=float, default=436.0,
                    help="grid carbon intensity [gCO2eq/kWh] for the "
                    "operational+embodied footprint line")
    ap.add_argument("--save", default=None, metavar="PATH",
                    help="write the sweep as a SweepResult JSON")
    ap.add_argument("--telemetry", nargs="?", const="", default=None,
                    metavar="DIR",
                    help="record streaming telemetry; with DIR, export "
                    "JSONL events / Chrome trace / series / Prometheus "
                    "snapshot per policy run under DIR "
                    "(see repro_torch.telemetry)")
    args = ap.parse_args()

    cfg = ExperimentConfig(
        num_cores=args.cores, rate_rps=args.rate,
        duration_s=args.duration, seed=1, router=args.router,
        carbon_model=args.carbon_model, power_model=args.power_model)
    if args.telemetry is not None:
        cfg = cfg.with_telemetry(
            **({"export_dir": args.telemetry} if args.telemetry else {}))
    res = run_policy_sweep(cfg)
    linux, proposed = res["linux"], res["proposed"]

    print(f"cluster: 22 machines (5 prompt + 17 token), {args.cores}-core "
          f"VMs, {args.rate} req/s, {args.duration:.0f}s Azure-like trace\n")
    print(f"{'metric':44s} {'paper':>10s} {'ours':>10s}")
    est99 = carbon_comparison(linux, proposed, 99)
    est50 = carbon_comparison(linux, proposed, 50)
    print(f"{'yearly embodied carbon reduction (p99)':44s} "
          f"{'37.67%':>10s} {100*est99.reduction_frac:>9.2f}%")
    print(f"{'yearly embodied carbon reduction (p50)':44s} "
          f"{'49.01%':>10s} {100*est50.reduction_frac:>9.2f}%")
    underutil = 100 * (1 - proposed.idle_norm_percentiles[90]
                       / max(linux.idle_norm_percentiles[90], 1e-9))
    print(f"{'CPU underutilization reduction (p90)':44s} "
          f"{'>=77%':>10s} {underutil:>9.1f}%")
    print(f"{'oversubscription bound (p1 idle norm)':44s} "
          f"{'>-0.1':>10s} {proposed.idle_norm_percentiles[1]:>10.3f}")
    lat = 100 * (proposed.p99_latency_s / linux.p99_latency_s - 1)
    print(f"{'service quality impact (p99 latency)':44s} "
          f"{'<10%':>10s} {lat:>+9.2f}%")
    print(f"\nrouter: {args.router} — fleet degradation CV "
          f"{proposed.fleet_degradation_cv:.4f}, fleet yearly embodied "
          f"{proposed.fleet_yearly_kgco2eq:.1f} kgCO2eq "
          f"[{args.carbon_model}]")
    yearly_kwh = proposed.mean_machine_power_w * HOURS_PER_YEAR / 1000.0
    print(f"power: {args.power_model} — fleet horizon energy "
          f"{proposed.fleet_energy_kwh:.4f} kWh (mean machine draw "
          f"{proposed.mean_machine_power_w:.0f} W), fleet yearly "
          f"operational {proposed.fleet_yearly_operational_kgco2eq:.1f} "
          f"kgCO2eq, total {proposed.fleet_yearly_total_kgco2eq:.1f}")

    deg_l = linux.mean_degradation_percentiles[99]
    deg_p = proposed.mean_degradation_percentiles[99]
    fp = get_carbon_model(
        "operational-embodied",
        intensity="constant",
        intensity_opts={"value_g_per_kwh": args.intensity},
        lifetime_model=args.carbon_model,
    ).footprint(deg_l, deg_p, energy_kwh_per_year=yearly_kwh)
    print(f"per-server total @ {args.intensity:.0f} gCO2/kWh: "
          f"{fp.total_kg:.0f} kgCO2eq/yr (operational "
          f"{fp.operational_kg:.0f}, CPU embodied {fp.cpu_embodied_kg:.1f}, "
          f"accel embodied {fp.gpu_embodied_kg:.1f}; embodied share "
          f"{100*fp.embodied_frac:.1f}%)")

    if args.telemetry is not None:
        s = proposed.telemetry_summary or {}
        kinds = s.get("event_kinds", {})
        print(f"\ntelemetry: {s.get('events', 0)} events "
              f"({', '.join(f'{k}:{v}' for k, v in kinds.items())}), "
              f"{len(s.get('series', {}))} series, "
              f"{len(s.get('timelines', {}))} timelines")
        for surface, path in (s.get("export") or {}).items():
            print(f"  {surface}: {path}")

    if args.save:
        res.save(args.save)
        print(f"\nsweep saved to {args.save} "
              f"(SweepResult.load round-trips it, provenance included)")


if __name__ == "__main__":
    main()
