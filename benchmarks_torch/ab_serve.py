#!/usr/bin/env python3
"""One serve cell of another checkout against this checkout's, in turns,
on one GPU.

    python3 benchmarks_torch/ab_serve.py OTHER_CHECKOUT [--arch llama3-8b]
        [--rounds 4]

Runs `python -m repro_torch.launch.serve` at full width (random weights
from seed 0) from each checkout in turn, other, this, this, other, for
each round, each in a process of its own with its own checkout's `src`
on the path, and with the same flags: 8 requests of 512 prompt tokens, 32
new tokens each, 4 batch slots, a 1,536-token cache, policy "proposed" on
16 host cores. An untimed turn of each checkout first builds the kernels
its sources name (the build directory is the checkout's own), so that no
timed turn includes a build. The processes share
one host and one card, so the host's drift between turns falls on both
checkouts alike; the spread of each checkout's turns says how far to
trust a difference. Prints each turn's tok/s (`launch.serve`'s first
line: wall of submitting and draining the requests) and each checkout's
median. Needs CUDA; exits 1 without it.
"""
from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ORDER = ("other", "this", "this", "other")
FLAGS = ("--requests", "8", "--prompt-len", "512", "--new-tokens", "32",
         "--max-batch", "4", "--max-len", "1536", "--policy", "proposed",
         "--host-cores", "16", "--seed", "0")


def turn(checkout: Path, arch: str) -> float:
    """tok/s of one `launch.serve` run from `checkout`."""
    env = dict(os.environ, PYTHONPATH=str(checkout / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         *FLAGS], cwd=checkout, env=env, capture_output=True, text=True,
        timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"serve failed in {checkout}:\n{out.stderr}")
    line = out.stdout.splitlines()[0]
    return float(re.search(r"\(([\d,.]+) tok/s\)", line).group(1)
                 .replace(",", ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ab_serve: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    roots = {"this": ROOT, "other": args.other.resolve()}
    got = {"this": [], "other": []}
    for name in ("other", "this"):      # builds the kernels, untimed
        turn(roots[name], args.arch)
    for r in range(args.rounds):
        for name in ORDER:
            rate = turn(roots[name], args.arch)
            got[name].append(rate)
            print(f"round {r} {name}: {args.arch} {rate:.1f} tok/s",
                  flush=True)
    for name, rates in got.items():
        print(f"{name} ({roots[name]}): median {statistics.median(rates):.1f}"
              f" tok/s over {len(rates)} turns, spread "
              f"{min(rates):.1f} to {max(rates):.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
