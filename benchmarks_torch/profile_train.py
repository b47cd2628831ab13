#!/usr/bin/env python3
"""Where the time of a full-width training step goes, on one GPU.

    python3 benchmarks_torch/profile_train.py [--steps 3]

Builds `chip_smoke.py`'s train-llama3-8b cell (Llama-3-8B's published
widths with TRAIN_LAYERS of its 32 layers, bfloat16 params and grads,
float32 moments, random weights from seed 0; TRAIN_BATCH x TRAIN_SEQ
tokens of `SyntheticTokens`, seed 0; the trainer's defaults) and, after
two untimed steps, times `--steps` steps, each split by CUDA events into
the loss's forward pass, its backward pass (where remat recomputes each
layer's forward) and `apply_updates`. Then it profiles one step under
`torch.profiler` and prints its wall, summed kernel time, idle share
(from the union of the kernels' intervals), launches and the kernels
that take the most device time (`report`). Prints the card's name and
power limit. Needs CUDA; exits 1 without it.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOP = 10            # kernels listed by device time


def report(prof, wall: float, label: str, per: int, unit: str) -> None:
    """The profiled window's wall, launches, summed kernel time, idle
    share (1 - the union of the kernels' intervals over the wall) and
    the kernels that take the most device time."""
    from torch.autograd import DeviceType

    from bench.trace import merge
    events = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(getattr(e, key) for e in kernels)
    busy_ns = sum(b - a for a, b in merge(
        (e.start_ns(), e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA))
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
    print(f"[{label}] kernel time {device_us / 1e3:.2f} ms (summed); idle "
          f"share {1.0 - busy_ns / 1e9 / wall:.4f}")
    for e in sorted(kernels, key=lambda e: -getattr(e, key))[:TOP]:
        us = getattr(e, key)
        print(f"  {us / 1e3:9.3f} ms {100 * us / device_us:5.1f}% "
              f"{e.count:6d}x  {e.key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_train: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import TRAIN_BATCH, TRAIN_LAYERS, TRAIN_SEQ
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import Model
    from repro_torch.training import optimizer as opt

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[env] torch {torch.__version__}; card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              num_layers=TRAIN_LAYERS)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH, seed=0))
    model = Model(cfg, device="cuda", seed=0).requires_grad_(True)
    params = dict(model.named_parameters())
    state = opt.init_state(params)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=20)

    def step(state, marks=None):
        """One train step (`make_train_step`'s work), each of its parts
        followed by the record of the next of `marks` (4 CUDA events)."""
        batch = {"tokens": torch.as_tensor(next(data)["tokens"],
                                           device="cuda")}
        record = iter(marks) if marks else None

        def mark():
            if record:
                next(record).record()
        mark()
        loss = model.loss(batch)
        mark()
        loss.backward()
        mark()
        grads = {n: p.grad for n, p in params.items()}
        _, state, _ = opt.apply_updates(params, grads, state, ocfg)
        mark()
        for p in params.values():
            p.grad = None
        return state

    for _ in range(2):
        state = step(state)
    torch.cuda.synchronize()
    parts = {"forward": [], "backward": [], "apply_updates": [], "step": []}
    walls = []
    for _ in range(args.steps):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        state = step(state, marks)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        for name, (a, b) in zip(("forward", "backward", "apply_updates",
                                 "step"),
                                ((0, 1), (1, 2), (2, 3), (0, 3))):
            parts[name].append(marks[a].elapsed_time(marks[b]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    wall_ms = statistics.median(walls) * 1e3
    print(f"[train] {cfg.num_layers} layers, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}: step wall {wall_ms:.1f} ms (median of "
          f"{args.steps}), {tokens / wall_ms * 1e3:,.0f} tok/s; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    for name, ms in parts.items():
        print(f"[train] {name}: {statistics.median(ms):.1f} ms on the "
              f"device's clock (CUDA events, median)")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(prof, wall, "train step", 1, "step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
