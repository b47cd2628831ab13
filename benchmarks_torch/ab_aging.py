#!/usr/bin/env python3
"""The aging kernel of another checkout against this checkout's, on one GPU.

    python3 benchmarks_torch/ab_aging.py OTHER_CHECKOUT [--rounds 4]

Builds OTHER_CHECKOUT's `src/repro_torch/kernels/aging_update/aging_update.cu`
beside this checkout's (the same C entry point and flags), holds both
against the plain version on `chip_smoke.py`'s inputs, and times both at
the smoke's sizes (`TIMED_NS`: the smoke fleet's 8,000 cores and 1.28M)
in turns, other, this, this, other, for each round: the device time per
launch of 100 launches captured in one CUDA graph (`chip_smoke.graph_ms`),
on the same inputs and output. Prints every time and the medians. Needs
CUDA; exits 1 without it.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path("src/repro_torch/kernels/aging_update/aging_update.cu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ab_aging: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import ATOL, RTOL, TIMED_NS, graph_ms
    from repro_torch.core.aging import DEFAULT_PARAMS as P
    from repro_torch.kernels._build import CudaKernel, build_all
    from repro_torch.kernels.aging_update import ops
    from repro_torch.kernels.aging_update.ref import aging_update_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    other = CudaKernel("aging_update_other", args.other.resolve() / SOURCE,
                       ops.KERNEL.entry, ops.KERNEL.argtypes,
                       flags=ops.KERNEL.flags)
    kernels = {"other": other, "this": ops.KERNEL}
    build_all(list(kernels.values()))
    for n in TIMED_NS:
        rng = np.random.default_rng(n)
        inputs = [torch.tensor(a, dtype=torch.float32, device="cuda")
                  for a in (rng.uniform(0, 0.05, n),
                            rng.choice([48.0, 51.08, 54.0], n),
                            rng.choice([0.0, 1.0], n),
                            rng.uniform(0, 1e5, n))]
        out = torch.empty_like(inputs[0])
        ref = aging_update_ref(*inputs, P)

        def launcher(kernel):
            fn = kernel.function()

            def launch():
                err = fn(*(t.data_ptr() for t in inputs), out.data_ptr(), n,
                         P.n, 1.0 / P.n, P.K, -P.E0, P.kB,
                         P.c_field * P.vdd,
                         torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            return launch

        launches = {name: launcher(k) for name, k in kernels.items()}
        for name, launch in launches.items():
            out.zero_()
            launch()
            torch.cuda.synchronize()
            if not torch.allclose(out, ref, rtol=RTOL, atol=ATOL):
                raise AssertionError(f"{name} kernel disagrees at N={n}")
        times = {name: [] for name in kernels}
        for _ in range(args.rounds):
            for name in ("other", "this", "this", "other"):
                times[name].append(graph_ms(launches[name]) * 1e3)
        for name, ts in times.items():
            print(f"N={n} {name}: median {statistics.median(ts):.3f} us of "
                  + ", ".join(f"{t:.3f}" for t in ts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
