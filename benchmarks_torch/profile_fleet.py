#!/usr/bin/env python3
"""Where the time of the port's torch fleet engine goes, on one GPU.

    python3 benchmarks_torch/profile_fleet.py [--fault-model NAME]
        [--fleet SPEC] [--telemetry]
    python3 benchmarks_torch/profile_fleet.py --turns

Runs the fleet cell of `chip_smoke.py` (its `FLEET` config: 200
machines x 40 cores, conversation-poisson at 545.455 rps, policy
"proposed"; with `--fault-model guardband` or `machine-crash`, its
fault cells `FLEET_GUARDBAND` or `FLEET_CRASH`) cut to the first 60
simulated seconds, under `torch.profiler`, after one untimed warm-up run
of the same length. `--fleet SPEC` runs a fleet spec of
`repro_torch.hardware` in its place (`--fleet mixed` is the smoke's
`FLEET_MIXED`, "xeon-40c:100+epyc-64c:rest", its core axis padded to
64), and `--telemetry` hands both runs a `TelemetryHub` and prints what
it holds after the profiled one.
Prints the wall time of the profiled run, the summed device time of its
kernels, the device's idle share
(1 - device time / wall), the count of kernel launches per simulated
period, and the kernels that take the most device time. Where the
profiler records no device time it prints "not measured" for the
device numbers. `--turns` profiles nothing: it times the torch engine
on the whole hour of the three cells, on one trace, in turns (none,
guardband, machine-crash, machine-crash, guardband, none), so that the
host's drift falls on all three alike. Needs CUDA; exits 1 without it.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SECONDS = 60.0      # simulated horizon: 60 of the cell's 3,600 periods
TOP = 12            # kernels listed by device time


def turns(torch, cells) -> None:
    """The torch engine's wall on each cell's whole hour, in turns."""
    from repro_torch.sim import ExperimentConfig
    from repro_torch.sim.fleetsim import run_fleet_experiment
    from repro_torch.workloads import get_scenario

    cfgs = {name: ExperimentConfig(**kw).with_engine("fleet",
                                                     backend="torch")
            for name, kw in cells.items()}
    first = next(iter(cfgs.values()))
    reqs = get_scenario(first.scenario).generate(
        rate_rps=first.rate_rps, duration_s=first.duration_s,
        seed=first.seed)
    walls = {name: [] for name in cfgs}
    order = list(cfgs) + list(reversed(cfgs))
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_fleet_experiment(cfgs[name], requests=reqs)
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
        print(f"{name}: {walls[name][-1]:.3f} s", flush=True)
    base = sum(walls["none"]) / len(walls["none"])
    for name, w in walls.items():
        mean = sum(w) / len(w)
        print(f"{name}: engine walls {', '.join(f'{x:.3f}' for x in w)} s "
              f"in turns ({order}), mean {mean:.3f} s, "
              f"{100 * (mean / base - 1):+.1f}% against none")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fault-model", default="none",
                    choices=("none", "guardband", "machine-crash"))
    ap.add_argument("--fleet", default="uniform",
                    help='a fleet spec, or "mixed" for the smoke\'s '
                         'FLEET_MIXED')
    ap.add_argument("--telemetry", action="store_true")
    ap.add_argument("--turns", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_fleet: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import FLEET, FLEET_CRASH, FLEET_GUARDBAND, FLEET_MIXED
    from repro_torch.sim import ExperimentConfig
    from repro_torch.sim.fleetsim import run_fleet_experiment
    from repro_torch.telemetry import TelemetryHub
    from repro_torch.workloads import get_scenario

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    cells = {"none": FLEET, "guardband": FLEET_GUARDBAND,
             "machine-crash": FLEET_CRASH}
    if args.turns:
        turns(torch, cells)
        return 0
    fleet = FLEET_MIXED["fleet"] if args.fleet == "mixed" else args.fleet
    cfg = ExperimentConfig(**dict(cells[args.fault_model],
                                  duration_s=SECONDS,
                                  fleet=fleet)).with_engine(
        "fleet", backend="torch")
    reqs = get_scenario(cfg.scenario).generate(
        rate_rps=cfg.rate_rps, duration_s=cfg.duration_s, seed=cfg.seed)

    def hub():
        return TelemetryHub() if args.telemetry else None
    run_fleet_experiment(cfg, telemetry=hub(), requests=reqs)   # warm-up
    torch.cuda.synchronize()
    tel = hub()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_fleet_experiment(cfg, telemetry=tel, requests=reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # the attribute's name before torch 2.4 was self_cuda_time_total
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    # device-side events only (kernels, copies), so that the time of a
    # kernel is not counted again under the operator that launched it
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(getattr(e, key) for e in kernels)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    periods = int(round(cfg.duration_s / cfg.idling_period_s))
    print(f"cell: {cfg.n_machines} machines x {cfg.duration_s:g} s, "
          f"fleet {cfg.fleet}, fault model {cfg.fault_model}, {periods} "
          f"periods, {len(reqs)} requests")
    if tel is not None:
        s = tel.summary()
        print(f"telemetry: events {s['event_kinds']}, gauges "
              f"{s['gauges']}, timelines {s['timelines']}")
    print(f"profiled wall: {wall:.3f} s (profiler on)")
    print(f"kernel launches: {launches} ({launches / periods:.1f} per "
          f"period)")
    if device_us <= 0:
        print("device time: not measured (no device events recorded)")
        return 0
    print(f"device time: {device_us / 1e6:.3f} s; idle share "
          f"{1.0 - device_us / 1e6 / wall:.4f}")
    for e in kernels:
        if "aging_update" in e.key:
            print(f"aging_update kernel: {e.count} launches, "
                  f"{getattr(e, key) / e.count:.3f} us each on the device")
    for e in sorted(kernels, key=lambda e: -getattr(e, key))[:TOP]:
        us = getattr(e, key)
        print(f"  {us / 1e3:10.2f} ms {100 * us / device_us:5.1f}% "
              f"{e.count:8d}x  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
