"""Render an aging-timeline + carbon-window report from an exported
telemetry run.

Run an experiment with telemetry export first, then point this script
at the export directory it printed:

  PYTHONPATH=src python examples_torch/carbon_report.py --duration 30 \
      --telemetry /tmp/tel
  PYTHONPATH=src python examples_torch/telemetry_report.py \
      /tmp/tel/proposed-<fingerprint>

The report reads the JSONL event stream (`events.jsonl`) and the
series/timeline arrays (`series.npz`) and prints:

  * per-phase runner wall times and event-loop throughput,
  * the event-kind census with cause attribution (how many gates /
    wakes were plain policy decisions vs carbon-aware reshaping, how
    many wake-ups the dirty-hour guard deferred),
  * per-core gated-span statistics reconstructed from gate -> wake
    pairs (the Perfetto view, in text),
  * the fleet aging timeline (frequency spread over time), and
  * the per-window power / intensity / operational-carbon series.

Load `trace.json` in https://ui.perfetto.dev for the interactive
per-core span view of the same run.
"""
from __future__ import annotations

import argparse
import collections
import json
import os

import numpy as np

from repro_torch.telemetry import read_jsonl


def _phase_table(meta: dict) -> None:
    gauges = meta.get("gauges", {})
    phases = {k.removeprefix("phase/").removesuffix("_wall_s"): v
              for k, v in gauges.items()
              if k.startswith("phase/") and k.endswith("_wall_s")}
    if phases:
        print("runner phases:")
        for name, wall in sorted(phases.items(), key=lambda kv: -kv[1]):
            print(f"  {name:14s} {wall:8.3f} s")
    eps = gauges.get("events_per_sec")
    if eps is not None:
        print(f"event loop: {gauges.get('events_processed', 0):,.0f} "
              f"events at {eps:,.0f} ev/s")


def _event_census(events: list[dict]) -> None:
    kinds = collections.Counter(e["kind"] for e in events)
    print("\nevent census:")
    for kind, n in kinds.most_common():
        print(f"  {kind:16s} {n:7d}")
    causes = collections.Counter(
        (e["kind"], e.get("cause", "-")) for e in events
        if e["kind"] in ("gate", "wake", "carbon_deferral"))
    if causes:
        print("cause attribution:")
        for (kind, cause), n in sorted(causes.items()):
            print(f"  {kind:16s} {cause:24s} {n:7d}")
    deferred = sum(e.get("deferred", 0) for e in events
                   if e["kind"] == "carbon_deferral")
    if deferred:
        print(f"  wake-ups deferred by the dirty-hour guard: {deferred}")


def _gated_spans(events: list[dict], t_end: float) -> None:
    open_gate: dict[tuple[int, int], float] = {}
    spans: list[float] = []
    for e in events:
        key = (e.get("machine", 0), e.get("core", -1))
        if e["kind"] == "gate":
            open_gate[key] = e["t"]
        elif e["kind"] == "wake":
            t0 = open_gate.pop(key, None)
            if t0 is not None:
                spans.append(e["t"] - t0)
    still_open = len(open_gate)
    spans.extend(t_end - t0 for t0 in open_gate.values())
    if not spans:
        print("\nno gated spans recorded")
        return
    a = np.asarray(spans)
    print(f"\ngated spans: {len(spans)} "
          f"({still_open} still gated at horizon) — "
          f"mean {a.mean():.2f} s, p50 {np.percentile(a, 50):.2f} s, "
          f"max {a.max():.2f} s")


def _aging_timelines(npz) -> None:
    machines = sorted(
        {k.split("/")[1] for k in npz.files
         if k.startswith("timeline/m") and k.endswith("/freq/values")},
        key=lambda m: int(m[1:]))
    rows = []
    for m in machines:
        t = npz[f"timeline/{m}/freq/t"]
        v = npz[f"timeline/{m}/freq/values"]
        if len(t) == 0:
            continue
        last = v[-1]
        rows.append((m, float(t[-1]), float(last.mean()),
                     float(last.min()), float(last.max())))
    if not rows:
        print("\nno aging timelines recorded (timeline_every too large?)")
        return
    print("\nper-machine settled frequency at the last sample "
          "(nominal 1.0):")
    print(f"  {'machine':8s} {'t':>8s} {'mean':>8s} {'min':>8s} "
          f"{'max':>8s}")
    for m, t, mean, lo, hi in rows:
        print(f"  {m:8s} {t:8.1f} {mean:8.5f} {lo:8.5f} {hi:8.5f}")


def _carbon_windows(npz) -> None:
    key = "timeline/fleet/carbon_windows"
    if f"{key}/t" not in npz.files:
        print("\nno fleet carbon windows recorded")
        return
    t = npz[f"{key}/t"]
    v = npz[f"{key}/values"]     # (W, 5): window_s, W, kWh, g/kWh, g
    if len(t) == 0:
        return
    print(f"\nfleet carbon windows ({len(t)} windows of "
          f"{v[0, 0]:.1f} s):")
    print(f"  {'t_start':>8s} {'power_W':>9s} {'kWh':>10s} "
          f"{'gCO2/kWh':>9s} {'op_g':>9s}")
    idx = np.linspace(0, len(t) - 1, min(len(t), 8)).astype(int)
    for i in idx:
        print(f"  {t[i]:8.1f} {v[i, 1]:9.0f} {v[i, 2]:10.6f} "
              f"{v[i, 3]:9.1f} {v[i, 4]:9.3f}")
    print(f"  total operational over horizon: {v[:, 4].sum():.2f} gCO2eq")


def main() -> None:
    ap = argparse.ArgumentParser(
        description="render a text report from a telemetry export "
        "directory (events.jsonl + series.npz)")
    ap.add_argument("export_dir", help="directory written by "
                    "`export_run` / a --telemetry DIR run")
    args = ap.parse_args()

    events_path = os.path.join(args.export_dir, "events.jsonl")
    npz_path = os.path.join(args.export_dir, "series.npz")
    meta, events = read_jsonl(events_path)
    t_end = max((e["t"] for e in events), default=0.0)

    print(f"telemetry report: {args.export_dir}")
    print(f"{meta.get('events', len(events))} events retained "
          f"({meta.get('events_dropped', 0)} dropped), "
          f"{len(meta.get('series', {}))} series, "
          f"{len(meta.get('timelines', {}))} timelines\n")
    _phase_table(meta)
    _event_census(events)
    _gated_spans(events, t_end)
    with np.load(npz_path) as npz:
        _aging_timelines(npz)
        _carbon_windows(npz)
    trace = os.path.join(args.export_dir, "trace.json")
    if os.path.exists(trace):
        print(f"\ninteractive spans: load {trace} in "
              f"https://ui.perfetto.dev")


if __name__ == "__main__":
    main()
