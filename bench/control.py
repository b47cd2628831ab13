#!/usr/bin/env python3
"""The readings the comparison's limits are set from, several runs in
one process at the cell's own load and sizes (a short window). Needs a
card.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --seconds 51
    python3 bench/control.py --workload <cell> --seeds 4 --seconds 15 \
        --faults all

Without `--faults`, for each seed a sound run with its numbers compared
(`served_gap`, `state_gap`, `state_pos`) and the FP8 control's on the
same prompts and served tokens, the control's own `control_correct`
against the cell's limits beside them. With `--faults`, one run on the
first seed for each fault of `bench/faults.py` named (`all`: every one).
Prints one JSON line a run.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _row(res: dict, **head) -> dict:
    row = dict(head)
    row.update({k: v["value"] for k, v in res["checks"].items()})
    row["correct"] = res["correct"]
    if "control" in res:
        row["control"] = {k: v["value"] for k, v in res["control"].items()}
        row["control_correct"] = res["control_correct"]
    row["metrics"] = {k: v["value"] for k, v in res["metrics"].items()}
    row["memory_peak_bytes"] = res["device"]["memory_peak_bytes"]
    row["setup"] = res["setup"]
    return row


def readings(cell_name: str, seeds, seconds: float, device="cuda"):
    """Rows, one a seed: the program's numbers and the control's."""
    from bench.harness import load_cell, run_cell
    for seed in seeds:
        yield _row(run_cell(load_cell(cell_name), seed, seconds, False,
                            device=device, control=True), seed=seed)


def faults(cell_name: str, names, seed: int, seconds: float,
           device="cuda"):
    """Rows, one a fault: the numbers of a run with it planted."""
    from bench.faults import FAULTS
    from bench.harness import load_cell, run_cell
    for name in names:
        yield _row(run_cell(load_cell(cell_name), seed, seconds, False,
                            device=device, hook=FAULTS[name]),
                   seed=seed, fault=name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.faults:
        from bench.faults import FAULTS
        names = sorted(FAULTS) if args.faults == "all" else \
            args.faults.split(",")
        rows = faults(args.workload, names, seeds[0], args.seconds)
    else:
        rows = readings(args.workload, seeds, args.seconds)
    for row in rows:
        print(json.dumps(row, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
