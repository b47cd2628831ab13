#!/usr/bin/env python3
"""Where the time of the port's serving path goes, on one GPU.

    python3 benchmarks_torch/profile_serve.py [--arch mamba2-2.7b]

Builds a serving cell of `chip_smoke.py` (its `SERVE` settings: the model
of `--arch` at full width, Llama-3-8B by default, bfloat16, random
weights from seed 0, 4 batch slots, a 1,536-position cache, policy
"proposed" on 16 host cores) and profiles two windows under
`torch.profiler`, each after an untimed warm-up of the same work:

- decode: `ITERATIONS` engine steps with all 4 slots busy (prompts of
  `PROMPT` tokens), no admission in the window;
- prefill: one request of 1,024 prompt tokens.

For each it prints the wall time, the summed device time of its kernels,
the device's idle share (1 - device time / wall), the kernel launches,
the share of the device time in each of the port's own kernels (and, for
a kernel of several launches such as the SSD scan's three phases, each
part's), and the kernels that take the most device time. Where the profiler records no
device time it prints "not measured" for the device numbers. Needs CUDA;
exits 1 without it.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ITERATIONS = 16     # decode steps in the profiled window
PROMPT = 512        # prompt tokens of each of the 4 decoding requests
PREFILL = 1024      # prompt tokens of the profiled prefill
TOP = 10            # kernels listed by device time
# the port's hand-written kernels, each by parts of the names of its
# __global__ functions (flash_attention_kernel in float32,
# flash_attention_tc_kernel in bfloat16; the SSD scan's three phases)
OWN = {"flash_attention": ("flash_attention",),
       "decode_attention": ("decode_attention",),
       "ssd_scan": ("chunk_state", "state_pass", "chunk_scan")}


def report(prof, wall: float, label: str, per: int, unit: str) -> None:
    from torch.autograd import DeviceType
    events = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(getattr(e, key) for e in kernels)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    print(f"[{label}] wall {wall * 1e3:.2f} ms (profiler on), "
          f"{wall / per * 1e3:.2f} ms per {unit}; kernel launches "
          f"{launches} ({launches / per:.1f} per {unit})")
    if device_us <= 0:
        print(f"[{label}] device time: not measured (no device events "
              f"recorded)")
        return
    print(f"[{label}] device time {device_us / 1e3:.2f} ms; idle share "
          f"{1.0 - device_us / 1e6 / wall:.4f}")
    for name, parts in OWN.items():
        own = [e for e in kernels if any(part in e.key for part in parts)]
        if own:
            us = sum(getattr(e, key) for e in own)
            count = sum(e.count for e in own)
            print(f"[{label}] {name}: {us / 1e3:.3f} ms, "
                  f"{100 * us / device_us:.1f}% of the device time, "
                  f"{count} launches ({us / count:.1f} us each)")
            for part in parts if len(parts) > 1 else ():
                mine = [e for e in own if part in e.key]
                pus = sum(getattr(e, key) for e in mine)
                pcount = sum(e.count for e in mine)
                if pcount:
                    print(f"[{label}]   {part}: {pus / 1e3:.3f} ms, "
                          f"{pcount} launches ({pus / pcount:.1f} us "
                          f"each)")
    for e in sorted(kernels, key=lambda e: -getattr(e, key))[:TOP]:
        us = getattr(e, key)
        print(f"  {us / 1e3:9.3f} ms {100 * us / device_us:5.1f}% "
              f"{e.count:6d}x  {e.key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="the model to serve (default: chip_smoke's SERVE)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_serve: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import SERVE
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.decode_attention.ops import KERNEL as DECODE
    from repro_torch.kernels.flash_attention.ops import KERNEL as FLASH
    from repro_torch.kernels.ssd_scan.ops import KERNEL as SSD
    from repro_torch.models import Model
    from repro_torch.serving.engine import InferenceEngine

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    build_all((FLASH, DECODE, SSD))
    cfg = get_config(args.arch or SERVE["arch"])
    print(f"model: {cfg.name}")
    model = Model(cfg, device="cuda", seed=SERVE["seed"])
    rng = np.random.default_rng(SERVE["seed"])
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def busy_engine():
        eng = InferenceEngine(
            model, max_batch=SERVE["max_batch"], max_len=SERVE["max_len"],
            policy=SERVE["policy"], num_host_cores=SERVE["host_cores"])
        for _ in range(SERVE["max_batch"]):
            eng.submit(rng.integers(0, cfg.vocab_size, PROMPT).tolist(),
                       max_new_tokens=4 * ITERATIONS)
        eng.step()                      # admits all four, one decode
        return eng

    for profiled in (False, True):      # warm-up, then the profiled run
        eng = busy_engine()
        torch.cuda.synchronize()
        if profiled:
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                for _ in range(ITERATIONS):
                    eng.step()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            report(prof, wall, "decode", ITERATIONS, "iteration")
        else:
            for _ in range(ITERATIONS):
                eng.step()
        del eng

    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (1, PREFILL)),
                        device="cuda")
    model.prefill(toks, max_len=SERVE["max_len"])       # warm-up
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        model.prefill(toks, max_len=SERVE["max_len"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(prof, wall, "prefill", 1, f"prefill of {PREFILL} tokens")
    return 0


if __name__ == "__main__":
    sys.exit(main())
