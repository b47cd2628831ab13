#!/usr/bin/env python3
"""The benchmark of the port (`src/repro_torch`): one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA GPU. A cell
is an entry of `workloads` in `BENCHMARK.json`; the run makes its
weights and traffic from the seed, warms the cell's shapes, drives the
serving engine for `--seconds`, compares what it served with the plain
float32 reference, and prints one JSON line: the cell's end-to-end
metrics (`--trace 0`) or its per-layer metrics from a traced run
(`--trace 1`), `correct` and the numbers compared, each beside its limit,
which also close its standard error. Without a card it prints no result
and exits 2. Build and kernel caches stay inside the checkout
(`build/`).
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Caches inside the checkout at fixed paths; few host threads."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    if not torch.cuda.is_available():
        print("bench: CUDA is not available; this benchmark runs only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    from bench.harness import load_cell, run_cell
    cell = load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} GPUs, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_process=T_PROCESS)
    result["card"] = _card()
    checks = result.pop("checks")
    result["checks"] = checks
    for name, v in checks.items():
        if "limit" in v:
            print(f"check {name} {v['value']!r} limit {v['limit']!r}",
                  file=sys.stderr)
    print(json.dumps(_finite(result), allow_nan=False))
    return 0


def _finite(obj):
    """`obj` with every infinite or NaN float as None (strict JSON); such
    a number arises only where a run finished no request to compare."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi failed: {err}"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


if __name__ == "__main__":
    sys.exit(main())
