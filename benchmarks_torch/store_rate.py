#!/usr/bin/env python3
"""How fast the port's checkpoint store writes and reads a tree.

    python3 benchmarks_torch/store_rate.py [--gb 4]

Saves a tree of CPU tensors (a quarter of the bytes bfloat16, the rest
float32, as a training state's params and moments) through
`repro_torch.checkpoint.store.save` into a temporary directory, restores
it with `store.restore` (digest check included), and prints the bytes and
each direction's seconds and GB/s on this host's disk. The tree is made
from a seed; the directory is removed after.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gb", type=float, default=4.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.checkpoint import store

    gen = torch.Generator().manual_seed(0)
    n = int(args.gb * 1e9 / 4 / 2 ** 20) * 2 ** 20
    tree = {"params": torch.randn(n // 2, generator=gen).to(torch.bfloat16),
            "moments": torch.randn(3 * n // 4, generator=gen)}
    size = sum(t.numel() * t.element_size() for t in tree.values())
    directory = tempfile.mkdtemp(prefix="store_rate_")
    try:
        t0 = time.perf_counter()
        store.save(directory, 1, tree)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = store.restore(directory, tree)
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    if not all(torch.equal(back[k], tree[k]) for k in tree):
        print("store_rate: the restored tree differs", file=sys.stderr)
        return 1
    print(f"[store] {size / 1e9:.2f} GB saved in {save_s:.2f} s "
          f"({size / 1e9 / save_s:.2f} GB/s), restored in {restore_s:.2f} s "
          f"({size / 1e9 / restore_s:.2f} GB/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
