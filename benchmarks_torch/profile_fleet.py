#!/usr/bin/env python3
"""Where the time of the port's torch fleet engine goes, on one GPU.

    python3 benchmarks_torch/profile_fleet.py

Runs the fleet cell of `chip_smoke.py` (its `FLEET` config: 200
machines x 40 cores, conversation-poisson at 545.455 rps, policy
"proposed") cut to the first 60 simulated seconds, under
`torch.profiler`, after one untimed warm-up run of the same length.
Prints the wall time of the profiled run, the summed device time of its
kernels, the device's idle share
(1 - device time / wall), the count of kernel launches per simulated
period, and the kernels that take the most device time. Where the
profiler records no device time it prints "not measured" for the
device numbers. Needs CUDA; exits 1 without it.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SECONDS = 60.0      # simulated horizon: 60 of the cell's 3,600 periods
TOP = 12            # kernels listed by device time


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_fleet: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import FLEET
    from repro_torch.sim import ExperimentConfig
    from repro_torch.sim.fleetsim import run_fleet_experiment
    from repro_torch.workloads import get_scenario

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    cfg = ExperimentConfig(**dict(FLEET, duration_s=SECONDS)).with_engine(
        "fleet", backend="torch")
    reqs = get_scenario(cfg.scenario).generate(
        rate_rps=cfg.rate_rps, duration_s=cfg.duration_s, seed=cfg.seed)
    run_fleet_experiment(cfg, requests=reqs)          # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_fleet_experiment(cfg, requests=reqs)
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
          f"{periods} periods, {len(reqs)} requests")
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
