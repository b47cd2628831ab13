#!/usr/bin/env python3
"""The Mamba2 prefill with another checkout's SSD scan against this
checkout's, in turns in one process, on one GPU.

    python3 benchmarks_torch/ab_prefill.py OTHER_CHECKOUT [--rounds 6]

Loads OTHER_CHECKOUT's `src/repro_torch/kernels/ssd_scan/ops.py` (and so
its `ssd_scan.cu`) beside this checkout's, builds both kernels, and makes
Mamba2-2.7B at full width once, with `chip_smoke.py`'s `SERVE_MAMBA`
settings (bfloat16, random weights from seed 0), and the smoke's 8 prompts
(the same draw of lengths and tokens). The SSD scan is the only part of
that prefill that has a kernel, so the model's `ssd_ops` is pointed at one
checkout's wrapper or the other's in turns, other, this, this, other, for
each round; each turn is one pass of the 8 prefills (`Model.prefill`,
synchronised before and after each, as the smoke times them), after an
untimed pass of each. The two run in one process on one host, so the
host's drift falls on both alike. Then, in the same turns, eager
back-to-back `ssd()` calls at the serve shape (80 heads, P 64, N 128,
bfloat16) at the shortest and the longest prompt (host time per call,
`chip_smoke.eager_ms`), and the device time of each at 1,024 tokens
(`chip_smoke.graph_ms`). Prints every number and the medians. Needs CUDA;
exits 1 without it.
"""
from __future__ import annotations

import argparse
import importlib.util
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WRAPPER = Path("src/repro_torch/kernels/ssd_scan/ops.py")
ORDER = ("other", "this", "this", "other")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ab_prefill: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import SERVE_MAMBA, eager_ms, graph_ms
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.models import Model
    from repro_torch.models import model as model_module

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    spec = importlib.util.spec_from_file_location(
        "ssd_ops_other", args.other.resolve() / WRAPPER)
    other = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = other          # for its dataclasses
    spec.loader.exec_module(other)
    wrappers = {"other": other, "this": ops}
    build_all([other.KERNEL, ops.KERNEL])

    cfg = get_config(SERVE_MAMBA["arch"])
    model = Model(cfg, device="cuda", seed=SERVE_MAMBA["seed"])
    rng = np.random.default_rng(SERVE_MAMBA["seed"])
    lo, hi = SERVE_MAMBA["prompt_lens"]
    lens = rng.integers(lo, hi + 1, SERVE_MAMBA["requests"])
    prompts = [torch.tensor([rng.integers(0, cfg.vocab_size, n).tolist()],
                            device="cuda") for n in lens]

    def prefill_all(name) -> float:
        model_module.ssd_ops = wrappers[name]
        launches = wrappers[name].KERNEL.launches
        total = 0.0
        for toks in prompts:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(toks, max_len=SERVE_MAMBA["max_len"])
            torch.cuda.synchronize()
            total += time.perf_counter() - t0
        if wrappers[name].KERNEL.launches - launches != \
                cfg.num_layers * len(prompts):
            raise AssertionError(f"{name}: the prefill missed its kernel")
        return total

    for name in wrappers:                       # warm-up
        prefill_all(name)
    walls = {name: [] for name in wrappers}
    for _ in range(args.rounds):
        for name in ORDER:
            walls[name].append(prefill_all(name))
    model_module.ssd_ops = ops
    print(f"prefill of {int(lens.sum())} tokens in {len(prompts)} prompts "
          f"{sorted(int(n) for n in lens)}, s:")
    for name, ts in walls.items():
        print(f"  {name}: median {statistics.median(ts):.4f} of "
              + ", ".join(f"{t:.4f}" for t in ts))

    def inputs(n):
        g = torch.Generator(device="cuda").manual_seed(n)
        x = torch.randn((1, n, cfg.ssm_heads, cfg.ssm_head_dim),
                        device="cuda", generator=g).bfloat16()
        b, c = (torch.randn((1, n, cfg.ssm_state), device="cuda",
                            generator=g).bfloat16() for _ in range(2))
        dt = torch.rand((1, n, cfg.ssm_heads), device="cuda", generator=g)
        return x, dt, torch.zeros(cfg.ssm_heads, device="cuda"), b, c

    for n in (int(lens.min()), int(lens.max()), 1024):
        xs = inputs(n)
        timers = {"eager ssd() us": eager_ms} if n != 1024 else {
            "device us (CUDA graph)": graph_ms}
        for label, timer in timers.items():
            times = {name: [] for name in wrappers}
            for _ in range(args.rounds):
                for name in ORDER:
                    fn = wrappers[name].ssd
                    times[name].append(timer(
                        lambda: fn(*xs, return_state=True)) * 1e3)
            print(f"L={n} {label}:")
            for name, ts in times.items():
                print(f"  {name}: median {statistics.median(ts):.3f} of "
                      + ", ".join(f"{t:.3f}" for t in ts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
