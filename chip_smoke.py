#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. Environment: Python, torch and CUDA versions, the card's name and
   power limit (nvidia-smi), and the build of every CUDA kernel of the
   port from the sources in this checkout (nvcc, sm_90a).
2. Each kernel against its plain PyTorch version on the card, at the
   shapes the fleet engine gives it and beyond. Its time (`ms`) is the
   device time per launch: 100 launches captured in one CUDA graph and
   replayed, timed with CUDA events; the plain version is timed the same
   way (`plain_ms`). Beside them stand the least time the card could
   take (bytes over 3.35 TB/s, operations over 67 TFLOP/s float32) and
   the rate of back-to-back eager calls from Python (`wrapper_ms`,
   `plain_eager_ms`), which the host's speed sets.
3. The fleet engine end to end on CUDA through `run_experiment`: the
   headline row of `benchmarks/bench_sim.py` `fleet_scale`, 200 machines
   x 40 cores x 1 h of conversation-poisson at 545.455 rps, with the
   launch count of every kernel of that path read right after it. The
   port's float64 numpy backend runs the same trace as the reference for
   the result, held at the bounds of `TestBackendAgreement` in
   `tests/test_fleetsim.py`.

The last two lines are one JSON object per kernel and the device line.
Without CUDA, or without `src/repro_torch` beside this file, it prints
no result and exits 1.
"""
from __future__ import annotations

import json
import math
import platform
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, float32 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

KERNEL_NS = (1, 7, 128, 1024, 5000, 8000, 1_280_000)
TIMED_NS = (8000, 1_280_000)          # the smoke fleet; 10k x 128 cores
RTOL, ATOL = 1e-6, 1e-9
# per element: 4 float32 loads + 1 store; 16 float ops (5 exp/pow)
AGING_BYTES, AGING_OPS = 20, 16

FLEET = dict(n_prompt=45, n_token=155, num_cores=40, rate_rps=545.455,
             duration_s=3600.0, policy="proposed")
# TestBackendAgreement bounds (reference tests/test_fleetsim.py)
BOUNDS = {"completed": 0.01, "mean_latency_s": 0.01,
          "p50_degradation": 0.02, "fleet_yearly_kgco2eq": 0.05}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _median_ms(run, calls: int, trials: int) -> float:
    """Median over `trials` of the CUDA-event time of `run()` divided by
    the `calls` it makes."""
    import torch
    per = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / calls)
    per.sort()
    return per[len(per) // 2]


def eager_ms(fn, calls: int = 100, trials: int = 11) -> float:
    """Time per call of `calls` back-to-back eager calls of `fn` from
    Python: host-bound wherever the device work is short."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            fn()
    return _median_ms(run, calls, trials)


def graph_ms(fn, calls: int = 100, trials: int = 11) -> float:
    """Device time per call of `fn`: `calls` calls captured in one CUDA
    graph and replayed, so no Python or launch cost of the host counts."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _median_ms(graph.replay, calls, trials)
    del graph
    torch.cuda.empty_cache()
    return ms


def phase_environment(torch, kernel) -> None:
    log(f"[env] python {platform.python_version()} torch {torch.__version__}"
        f" cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[env] card: {smi}")
    from repro_torch.kernels._build import nvcc_path
    t0 = time.perf_counter()
    kernel.function()
    log(f"[build] {kernel.name} with {nvcc_path()} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in kernel.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {kernel.name}: {line.strip()}")


def phase_aging_kernel(torch, np, params):
    """advance_fleet (kernel) vs aging_update_ref (plain) on the card."""
    from repro_torch.kernels.aging_update.ops import advance_fleet
    from repro_torch.kernels.aging_update.ref import aging_update_ref
    dev = torch.device("cuda")
    row = {}
    for n in KERNEL_NS:
        rng = np.random.default_rng(n)
        args = [torch.tensor(a, dtype=torch.float32, device=dev) for a in (
            rng.uniform(0, 0.05, n),
            rng.choice([48.0, 51.08, 54.0], n),
            rng.choice([0.0, 1.0], n),
            rng.uniform(0, 1e5, n))]
        out = advance_fleet(*args, params)
        ref = aging_update_ref(*args, params)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok = bool(torch.allclose(out, ref, rtol=RTOL, atol=ATOL))
        log(f"[aging_update] N={n}: max_abs_err {err:.3e} "
            f"(rtol {RTOL}, atol {ATOL}) {'ok' if ok else 'MISMATCH'}")
        if not ok or not torch.isfinite(out).all():
            raise AssertionError(f"aging_update disagrees at N={n}")
        if n in TIMED_NS:
            def kernel():
                return advance_fleet(*args, params)

            def plain():
                return aging_update_ref(*args, params)
            times = {"ms": graph_ms(kernel), "plain_ms": graph_ms(plain),
                     "wrapper_ms": eager_ms(kernel),
                     "plain_eager_ms": eager_ms(plain)}
            bytes_ms = AGING_BYTES * n / HBM_BYTES_PER_S * 1e3
            ops_ms = AGING_OPS * n / F32_FLOP_PER_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
            log(f"[aging_update] N={n}: per launch on the device (CUDA "
                f"graph) kernel {times['ms'] * 1e3:.3f} us, plain "
                f"{times['plain_ms'] * 1e3:.3f} us; eager from Python "
                f"wrapper {times['wrapper_ms'] * 1e3:.2f} us, plain "
                f"{times['plain_eager_ms'] * 1e3:.2f} us; bound "
                f"{bound_ms * 1e3:.3f} us ({bound_by})")
            if n == 8000:       # the shape the smoke fleet gives it
                row = dict(times, max_abs_err=err, bound_ms=bound_ms,
                           bound_by=bound_by)
    return row


def phase_fleet(torch, kernels):
    """`kernels`: the `CudaKernel` of every kernel the fleet path runs."""
    from repro_torch.sim import ExperimentConfig, run_experiment
    from repro_torch.sim.fleetsim import run_fleet_experiment
    from repro_torch.workloads import get_scenario

    cfg = ExperimentConfig(**FLEET).with_engine("fleet", backend="torch")
    machine_s = cfg.n_machines * cfg.duration_s
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res = run_experiment(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    log(f"[fleet] torch/cuda via run_experiment (trace generation "
        f"included): {wall:.2f} s wall, {machine_s / wall:.1f} "
        f"machine-s/wall-s, launches {launches}")
    periods = int(round(cfg.duration_s / cfg.idling_period_s))
    if launches.get("aging_update") != 2 * periods:
        raise AssertionError(f"aging_update launched "
                             f"{launches.get('aging_update')} times, "
                             f"expected {2 * periods}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path never ran: {launches}")

    t0 = time.perf_counter()
    reqs = get_scenario(cfg.scenario).generate(
        rate_rps=cfg.rate_rps, duration_s=cfg.duration_s, seed=cfg.seed)
    gen = time.perf_counter() - t0
    log(f"[fleet] trace: {len(reqs)} requests generated in {gen:.2f} s")
    t0 = time.perf_counter()
    again = run_fleet_experiment(cfg, requests=reqs)
    torch.cuda.synchronize()
    wall_t = time.perf_counter() - t0
    if again.scalars() != res.scalars():
        raise AssertionError("torch/cuda fleet run is not deterministic")
    t0 = time.perf_counter()
    ref = run_fleet_experiment(cfg.with_engine("fleet", backend="numpy"),
                               requests=reqs)
    wall_n = time.perf_counter() - t0
    for name, r, w in (("torch/cuda", res, wall_t), ("numpy", ref, wall_n)):
        log(f"[fleet] {name}: engine {w:.2f} s wall, "
            f"{machine_s / w:.1f} machine-s/wall-s, completed "
            f"{r.completed}, p99_latency_s {r.p99_latency_s!r}, "
            f"fleet_yearly_kgco2eq {r.fleet_yearly_kgco2eq!r}")
    deltas = {
        "completed": rel(res.completed, ref.completed),
        "mean_latency_s": rel(res.mean_latency_s, ref.mean_latency_s),
        "p50_degradation": rel(res.mean_degradation_percentiles[50],
                               ref.mean_degradation_percentiles[50]),
        "fleet_yearly_kgco2eq": rel(res.fleet_yearly_kgco2eq,
                                    ref.fleet_yearly_kgco2eq),
    }
    log(f"[fleet] torch/cuda vs numpy relative deltas: "
        + ", ".join(f"{k} {v:.3e} (bound {BOUNDS[k]})"
                    for k, v in deltas.items()))
    n = cfg.n_machines
    finite = all(math.isfinite(v) for v in (
        res.mean_latency_s, res.p99_latency_s, res.fleet_yearly_kgco2eq))
    if not finite or len(res.per_machine_degradation) != n \
            or len(res.per_machine_residency) != n or res.completed <= 0:
        raise AssertionError("fleet result is not finite or has the "
                             "wrong shape")
    bad = {k: v for k, v in deltas.items() if not v < BOUNDS[k]}
    if bad:
        raise AssertionError(f"torch/cuda disagrees with numpy: {bad}")
    return launches


def main() -> int:
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        return fail(f"no src/repro_torch beside {Path(__file__).name}")
    import torch
    if not torch.cuda.is_available():
        return fail("CUDA is not available; this smoke needs an NVIDIA GPU")
    sys.path.insert(0, str(src))
    import numpy as np

    from repro_torch.core.aging import DEFAULT_PARAMS
    from repro_torch.kernels.aging_update.ops import KERNEL

    phase_environment(torch, KERNEL)
    aging_row = phase_aging_kernel(torch, np, DEFAULT_PARAMS)
    launches = phase_fleet(torch, (KERNEL,))
    line = {"kernels": [dict({
        "name": "aging_update", "route": "cuda",
        "source": "src/repro_torch/kernels/aging_update/aging_update.cu",
        "replaces": "src/repro/kernels/aging_update/aging_update.py:41",
        "launches": launches["aging_update"], "library_ms": None},
        **aging_row)]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
