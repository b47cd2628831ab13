#!/usr/bin/env python3
"""Spreads of a cell's runs, for setting and checking the bounds.

    python3 bench/spread.py RESULTS.jsonl

Each line of RESULTS.jsonl is a run's result line with two added keys,
"set" and "seed". For every end-to-end metric it prints each set's
median and spread (the distance between the first and third quartile
over the median, Python's `statistics.quantiles(n=4)`), the wider
spread, five times it (the bound it suggests, at least 1%), and the
second set's median against the first's.
"""
from __future__ import annotations

import collections
import json
import statistics
import sys

from stats import spread


def main(path: str) -> None:
    runs = [json.loads(line) for line in open(path) if line.strip()]
    by = collections.defaultdict(lambda: collections.defaultdict(list))
    for r in runs:
        for name, m in r["metrics"].items():
            by[name][r["set"]].append(m["value"])
    for name, sets in sorted(by.items()):
        rows = {s: (statistics.median(v), spread(v), len(v))
                for s, v in sorted(sets.items()) if len(v) >= 2}
        if not rows:
            continue
        wide = max(r[1] for r in rows.values())
        meds = [r[0] for r in rows.values()]
        print(f"{name}: " + "; ".join(
            f"set {s} median {m:.6g} spread {sp:.4%} (n {n})"
            for s, (m, sp, n) in rows.items())
            + f"; widest {wide:.4%}, 5x {max(5 * wide, 0.01):.4%}"
            + (f", median B/A {meds[1] / meds[0]:.4f}"
               if len(meds) > 1 else ""))
    gaps = collections.defaultdict(list)
    for r in runs:
        for name, v in r["checks"].items():
            if "limit" in v:
                gaps[name].append(v["value"])
    for name, v in gaps.items():
        print(f"{name}: max {max(v):.6g} over {len(v)} runs, "
              f"all {sorted(round(x, 4) for x in v)}")


if __name__ == "__main__":
    main(sys.argv[1])
