"""Telemetry exporters: JSONL events, Chrome trace_event JSON,
CSV/npz time-series, and a Prometheus-style text snapshot.

Four surfaces for one hub:

  * `write_jsonl` / `read_jsonl` — the structured event stream, one
    JSON object per line with a metadata header line (schema, counters,
    drop counts). The round-trippable record of *why* things happened
    (gate/wake causes, carbon deferrals, routing justifications).
  * `chrome_trace` / `write_chrome_trace` — Chrome `trace_event` JSON:
    per-core busy / gated / oversubscription spans reconstructed from
    the event stream, loadable in Perfetto (`ui.perfetto.dev`) or
    `chrome://tracing`. pid = machine, tid = core (the per-machine
    oversubscription lane sits at tid = num_cores).
  * `series_to_csv` / `series_to_npz` — windowed series and timelines
    as flat tables / stacked arrays for pandas/matplotlib.
  * `prometheus_text` — text exposition format (counters, gauges, and
    per-series summaries) for the serving path's metrics endpoint;
    `start_metrics_server` serves it over HTTP.

`export_run(hub, directory)` writes all of them with canonical names —
what `run_experiment` calls when `telemetry_opts` carries an
`export_dir`, and what `examples/telemetry_report.py` reads back.
"""
from __future__ import annotations

import json
import math
import os
import threading
from typing import Any, Callable, Iterable

from repro_torch.telemetry.hub import TelemetryHub, hist_bin_upper

__all__ = [
    "EVENT_SCHEMA_VERSION", "write_jsonl", "read_jsonl", "chrome_trace",
    "write_chrome_trace", "series_to_csv", "series_to_npz",
    "prometheus_text", "export_run", "start_metrics_server",
]

#: bumped when the JSONL event layout changes incompatibly
EVENT_SCHEMA_VERSION = 1

# Canonical file names inside an export directory.
EVENTS_FILE = "events.jsonl"
TRACE_FILE = "trace.json"
SERIES_CSV_FILE = "series.csv"
SERIES_NPZ_FILE = "series.npz"
PROM_FILE = "metrics.prom"


# --------------------------------------------------------------------- #
# JSONL event stream
# --------------------------------------------------------------------- #
def write_jsonl(hub: TelemetryHub, path: str) -> None:
    """One JSON object per line: a metadata header, then every retained
    event in emission order."""
    meta = {"kind": "telemetry_meta", "schema": EVENT_SCHEMA_VERSION}
    meta.update(hub.summary())
    with open(path, "w") as f:
        f.write(json.dumps(meta) + "\n")
        for ev in hub.events:
            f.write(json.dumps(ev) + "\n")


def read_jsonl(path: str) -> tuple[dict[str, Any], list[dict[str, Any]]]:
    """Read back a `write_jsonl` stream -> `(meta, events)`."""
    meta: dict[str, Any] = {}
    events: list[dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if obj.get("kind") == "telemetry_meta":
                schema = obj.get("schema")
                if schema != EVENT_SCHEMA_VERSION:
                    raise ValueError(
                        f"unsupported telemetry schema {schema!r}; this "
                        f"version reads schema {EVENT_SCHEMA_VERSION}")
                meta = obj
            else:
                events.append(obj)
    return meta, events


# --------------------------------------------------------------------- #
# Chrome trace_event JSON (Perfetto / chrome://tracing)
# --------------------------------------------------------------------- #
_US = 1e6   # trace_event timestamps are microseconds


def _span(name: str, cat: str, pid: int, tid: int, t0: float, t1: float,
          args: dict | None = None) -> dict[str, Any]:
    ev = {"name": name, "cat": cat, "ph": "X", "pid": pid, "tid": tid,
          "ts": t0 * _US, "dur": max(t1 - t0, 0.0) * _US}
    if args:
        ev["args"] = args
    return ev


def chrome_trace(events: Iterable[dict[str, Any]],
                 t_end: float | None = None,
                 oversub_tid: int = 1000) -> dict[str, Any]:
    """Reconstruct per-core spans from the structured event stream.

    Pairs `assign`/`promote` -> `release` into *busy* spans, `gate` ->
    `wake` into *gated* spans, and `oversub` -> `promote`/`release`
    into per-task *oversub* spans on a dedicated per-machine lane
    (`tid = oversub_tid`). Spans still open at the end of the stream
    are closed at `t_end` (default: the last event time). Point events
    (`carbon_deferral`, `route`, `phase`) become instants so cause
    records stay visible next to the spans they explain.
    """
    events = list(events)
    if t_end is None:
        t_end = max((e["t"] for e in events), default=0.0)
    out: list[dict[str, Any]] = []
    busy_open: dict[tuple[int, int], tuple[float, int]] = {}
    gate_open: dict[tuple[int, int], tuple[float, str]] = {}
    over_open: dict[tuple[int, int], float] = {}

    for e in events:
        kind = e["kind"]
        t = e["t"]
        m = int(e.get("machine", 0))
        if kind in ("assign", "promote"):
            core = int(e["core"])
            task = int(e["task"])
            busy_open[(m, core)] = (t, task)
            if kind == "promote":
                tkey = (m, task)
                t0 = over_open.pop(tkey, None)
                if t0 is not None:
                    out.append(_span(f"oversub task {task}", "oversub",
                                     m, oversub_tid, t0, t,
                                     {"task": task,
                                      "cause": e.get("cause",
                                                     "promotion")}))
        elif kind == "oversub":
            over_open[(m, int(e["task"]))] = t
        elif kind == "release":
            core = int(e["core"])
            task = int(e["task"])
            if core < 0:
                t0 = over_open.pop((m, task), None)
                if t0 is not None:
                    out.append(_span(f"oversub task {task}", "oversub",
                                     m, oversub_tid, t0, t,
                                     {"task": task}))
                continue
            opened = busy_open.pop((m, core), None)
            if opened is not None:
                out.append(_span(f"task {task}", "busy", m, core,
                                 opened[0], t, {"task": task}))
        elif kind == "gate":
            core = int(e["core"])
            gate_open[(m, core)] = (t, e.get("cause", "policy"))
        elif kind == "wake":
            core = int(e["core"])
            opened = gate_open.pop((m, core), None)
            if opened is not None:
                out.append(_span("gated", "gated", m, core, opened[0], t,
                                 {"gate_cause": opened[1],
                                  "wake_cause": e.get("cause",
                                                      "policy")}))
        elif kind in ("carbon_deferral", "route", "phase"):
            args = {k: v for k, v in e.items()
                    if k not in ("kind", "t", "machine")}
            out.append({"name": kind, "cat": kind, "ph": "i", "s": "p",
                        "pid": m, "tid": 0, "ts": t * _US, "args": args})

    # close spans still open at the end of the horizon
    for (m, core), (t0, task) in busy_open.items():
        out.append(_span(f"task {task}", "busy", m, core, t0, t_end,
                         {"task": task, "open": True}))
    for (m, core), (t0, cause) in gate_open.items():
        out.append(_span("gated", "gated", m, core, t0, t_end,
                         {"gate_cause": cause, "open": True}))
    for (m, task), t0 in over_open.items():
        out.append(_span(f"oversub task {task}", "oversub", m,
                         oversub_tid, t0, t_end,
                         {"task": task, "open": True}))
    out.sort(key=lambda e: e["ts"])
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(hub: TelemetryHub, path: str,
                       t_end: float | None = None) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(hub.events, t_end=t_end), f)
        f.write("\n")


# --------------------------------------------------------------------- #
# time-series tables
# --------------------------------------------------------------------- #
def series_to_csv(hub: TelemetryHub, path: str) -> None:
    """Every windowed series flattened into one long-format CSV:
    `series,t_start,window_s,count,total,mean,min,max`."""
    with open(path, "w") as f:
        f.write("series,t_start,window_s,count,total,mean,min,max\n")
        for name in sorted(hub.series):
            for w in hub.series[name].windows():
                f.write(f"{name},{w['t_start']:.9g},{w['window_s']:.9g},"
                        f"{w['count']},{w['total']:.12g},"
                        f"{w['mean']:.12g},{w['min']:.12g},"
                        f"{w['max']:.12g}\n")


def series_to_npz(hub: TelemetryHub, path: str) -> None:
    """Windowed series and timelines as stacked arrays.

    Per series `<name>`: `series/<name>/t_start|count|total|min|max`.
    Per timeline `<name>`: `timeline/<name>/t` (T,) and
    `timeline/<name>/values` (T, D). Names are sanitized into npz keys
    verbatim (they already avoid '/' ambiguity by convention).
    """
    import numpy as np

    arrays: dict[str, Any] = {}
    for name, s in hub.series.items():
        ws = s.windows()
        arrays[f"series/{name}/t_start"] = np.asarray(
            [w["t_start"] for w in ws])
        arrays[f"series/{name}/count"] = np.asarray(
            [w["count"] for w in ws])
        arrays[f"series/{name}/total"] = np.asarray(
            [w["total"] for w in ws])
        arrays[f"series/{name}/min"] = np.asarray([w["min"] for w in ws])
        arrays[f"series/{name}/max"] = np.asarray([w["max"] for w in ws])
    for name, tl in hub.timelines.items():
        samples = tl.samples()
        arrays[f"timeline/{name}/t"] = np.asarray(
            [t for t, _ in samples])
        arrays[f"timeline/{name}/values"] = np.asarray(
            [v for _, v in samples])
    with open(path, "wb") as f:
        np.savez(f, **arrays)


# --------------------------------------------------------------------- #
# Prometheus-style text snapshot
# --------------------------------------------------------------------- #
def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return f"repro_{out}"


def prometheus_text(hub: TelemetryHub,
                    extra_gauges: dict[str, float] | None = None) -> str:
    """Text exposition snapshot: counters as `_total`, gauges verbatim,
    series as count/sum plus cumulative histogram buckets over the
    retained windows — one metrics surface shared by live serving and
    simulation exports."""
    lines: list[str] = []
    for name, c in sorted(hub.counters.items()):
        n = _prom_name(name)
        lines.append(f"# TYPE {n}_total counter")
        lines.append(f"{n}_total {c.value}")
    gauges = {n: g.value for n, g in hub.gauges.items()}
    if extra_gauges:
        gauges.update(extra_gauges)
    for name in sorted(gauges):
        v = gauges[name]
        if isinstance(v, float) and math.isnan(v):
            continue
        n = _prom_name(name)
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {v:.10g}")
    for name, s in sorted(hub.series.items()):
        n = _prom_name(name)
        lines.append(f"# TYPE {n} histogram")
        cum = 0
        inf_emitted = False
        for i, c in enumerate(s.merged_bins()):
            if not c:
                continue
            cum += c
            le = hist_bin_upper(i)
            inf_emitted = math.isinf(le)
            le_s = "+Inf" if inf_emitted else f"{le:.6g}"
            lines.append(f'{n}_bucket{{le="{le_s}"}} {cum}')
        if not inf_emitted:   # exposition format requires an +Inf bucket
            lines.append(f'{n}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{n}_sum {s.total:.10g}")
        lines.append(f"{n}_count {s.count}")
    return "\n".join(lines) + "\n"


def start_metrics_server(snapshot: Callable[[], str], port: int = 0):
    """Serve `snapshot()` at `/metrics` on a daemon thread; returns the
    `HTTPServer` (its `server_port` is the bound port — pass `port=0`
    for an ephemeral one, `shutdown()` to stop)."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):          # noqa: N802 (http.server API)
            if self.path not in ("/metrics", "/"):
                self.send_response(404)
                self.end_headers()
                return
            body = snapshot().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

    server = HTTPServer(("127.0.0.1", port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


# --------------------------------------------------------------------- #
# one-call export
# --------------------------------------------------------------------- #
def export_run(hub: TelemetryHub, directory: str,
               t_end: float | None = None) -> dict[str, str]:
    """Write every surface into `directory` (created if missing) with
    canonical names; returns `{surface: path}`."""
    os.makedirs(directory, exist_ok=True)
    paths = {
        "events_jsonl": os.path.join(directory, EVENTS_FILE),
        "chrome_trace": os.path.join(directory, TRACE_FILE),
        "series_csv": os.path.join(directory, SERIES_CSV_FILE),
        "series_npz": os.path.join(directory, SERIES_NPZ_FILE),
        "prometheus": os.path.join(directory, PROM_FILE),
    }
    write_jsonl(hub, paths["events_jsonl"])
    write_chrome_trace(hub, paths["chrome_trace"], t_end=t_end)
    series_to_csv(hub, paths["series_csv"])
    series_to_npz(hub, paths["series_npz"])
    with open(paths["prometheus"], "w") as f:
        f.write(prometheus_text(hub))
    return paths
