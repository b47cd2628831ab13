"""Trace ingestion, replay and export (Azure LLM inference CSV schema).

The public AzurePublicDataset LLM inference traces ship as CSV with one
row per request: a timestamp plus context (input) and generated (output)
token counts. This module reads that schema into `Request` lists, turns
any request list into a replayable `WorkloadScenario` with the paper's
replay transformations (time-scaling, window splicing, rate-rescaling),
and writes any synthetic stream back out in the same schema, so every
scenario in the registry can be exported and re-ingested losslessly.

    reqs = load_csv("AzureLLMInferenceTrace_conv.csv")
    sc = ReplayScenario.from_requests(reqs, start_s=600, stop_s=1200)
    trace = sc.generate(rate_rps=60, duration_s=120)   # rate-rescaled
    export_csv(trace, "spliced.csv")
"""
from __future__ import annotations

import csv
import dataclasses
import datetime as _dt
import io
import os
import re

# Python 3.10's fromisoformat only accepts 3 or 6 fractional digits; the
# real Azure traces carry 7 (e.g. "2023-11-16 18:15:46.6805900").
_FRACTION = re.compile(r"^(?P<head>[^.]*\.)(?P<frac>\d+)(?P<tail>.*)$")

from repro_torch.workloads.base import Request, WorkloadScenario

# Header of the public Azure LLM inference trace release.
AZURE_COLUMNS = ("TIMESTAMP", "ContextTokens", "GeneratedTokens")


def _parse_timestamp(raw: str) -> tuple[float, bool]:
    """Accept float seconds or an ISO-8601 datetime; the second element
    flags an absolute (datetime) timestamp."""
    try:
        return float(raw), False
    except ValueError:
        s = raw.strip().replace("Z", "+00:00")
        m = _FRACTION.match(s)
        if m:
            frac = m.group("frac")[:6].ljust(6, "0")
            s = m.group("head") + frac + m.group("tail")
        ts = _dt.datetime.fromisoformat(s)
        if ts.tzinfo is None:
            # Treat naive trace timestamps as UTC: local-time rules
            # would distort gaps across DST transitions and make the
            # replayed trace depend on the machine's timezone.
            ts = ts.replace(tzinfo=_dt.timezone.utc)
        return ts.timestamp(), True


def load_csv(path_or_file, rebase: bool | None = None) -> list[Request]:
    """Ingest an Azure-schema trace CSV into a `Request` list.

    Rows are returned sorted by arrival and re-numbered 0..n-1. With
    `rebase=None` (default), absolute datetime timestamps — what the
    public Azure traces use — are shifted so the earliest request
    arrives at t=0, while already-relative float-second timestamps pass
    through untouched (so an `export_csv` round-trip is the identity).
    Pass True/False to force either behaviour.
    """
    if isinstance(path_or_file, (str, os.PathLike)):
        with open(path_or_file, newline="") as f:
            return load_csv(f, rebase=rebase)
    reader = csv.DictReader(path_or_file)
    missing = set(AZURE_COLUMNS) - set(reader.fieldnames or ())
    if missing:
        raise ValueError(f"trace CSV is missing Azure-schema columns "
                         f"{sorted(missing)}; expected header "
                         f"{','.join(AZURE_COLUMNS)}")
    rows, n_absolute = [], 0
    for r in reader:
        t, is_abs = _parse_timestamp(r["TIMESTAMP"])
        n_absolute += is_abs
        rows.append((t, int(r["ContextTokens"]), int(r["GeneratedTokens"])))
    if not rows:
        return []
    if 0 < n_absolute < len(rows):
        raise ValueError(
            f"trace CSV mixes {n_absolute} absolute datetime timestamps "
            f"with {len(rows) - n_absolute} relative float ones; rebasing "
            "such a file would silently corrupt arrivals")
    absolute = n_absolute == len(rows)
    rows.sort(key=lambda x: x[0])
    t0 = rows[0][0] if (absolute if rebase is None else rebase) else 0.0
    return [Request(i, t - t0, n_in, n_out)
            for i, (t, n_in, n_out) in enumerate(rows)]


def export_csv(requests: list[Request], path_or_file) -> None:
    """Write a request stream in the Azure trace schema.

    Arrival seconds are written with `repr` so a load_csv round-trip
    reconstructs bit-identical floats.
    """
    if isinstance(path_or_file, (str, os.PathLike)):
        with open(path_or_file, "w", newline="") as f:
            export_csv(requests, f)
        return
    w = csv.writer(path_or_file)
    w.writerow(AZURE_COLUMNS)
    for r in requests:
        w.writerow([repr(float(r.arrival_s)),
                    r.input_tokens, r.output_tokens])


def export_csv_str(requests: list[Request]) -> str:
    """`export_csv` into a string (handy for tests and piping)."""
    buf = io.StringIO()
    export_csv(requests, buf)
    return buf.getvalue()


def splice(requests: list[Request], start_s: float = 0.0,
           stop_s: float | None = None) -> list[Request]:
    """Cut the [start_s, stop_s) window and shift it to start at t=0."""
    kept = [r for r in requests
            if r.arrival_s >= start_s
            and (stop_s is None or r.arrival_s < stop_s)]
    return [dataclasses.replace(r, req_id=i, arrival_s=r.arrival_s - start_s)
            for i, r in enumerate(kept)]


def time_scale(requests: list[Request], factor: float) -> list[Request]:
    """Stretch (factor > 1) or compress (factor < 1) arrival times.

    Compressing raises the delivered request rate — the replay knob the
    paper uses to sweep throughput levels over one recorded trace.
    """
    if factor <= 0:
        raise ValueError(f"time-scale factor must be positive, got {factor}")
    return [dataclasses.replace(r, arrival_s=r.arrival_s * factor)
            for r in requests]


def rescale_rate(requests: list[Request], rate_rps: float,
                 duration_s: float | None = None) -> list[Request]:
    """Time-scale so the stream's mean rate over its span is `rate_rps`,
    optionally also truncating to `duration_s` after rescaling."""
    if not requests:
        return []
    span = max(r.arrival_s for r in requests)
    if span <= 0:
        raise ValueError("cannot rescale a zero-span trace")
    current = len(requests) / span
    out = time_scale(requests, current / rate_rps)
    if duration_s is not None:
        out = [r for r in out if r.arrival_s < duration_s]
    return out


@dataclasses.dataclass(frozen=True)
class ReplayScenario:
    """A recorded trace as a first-class `WorkloadScenario`.

    `generate` splices the configured window, rescales so the mean rate
    matches the requested `rate_rps`, and — because the rescaled
    recording may hold less volume than `rate_rps * duration_s` — loops
    it end-to-end until `duration_s` is covered (so replay honors the
    same duration contract as the synthetic scenarios; set `loop=False`
    to emit the recording at most once). Replay is deterministic by
    construction; `seed` is accepted (for protocol compatibility) and
    ignored.
    """

    requests: tuple
    name: str = "replay"
    start_s: float = 0.0
    stop_s: float | None = None
    loop: bool = True

    @classmethod
    def from_requests(cls, requests, name: str = "replay",
                      start_s: float = 0.0, stop_s: float | None = None,
                      loop: bool = True) -> "ReplayScenario":
        return cls(tuple(requests), name=name, start_s=start_s,
                   stop_s=stop_s, loop=loop)

    @classmethod
    def from_csv(cls, path, name: str | None = None, start_s: float = 0.0,
                 stop_s: float | None = None,
                 loop: bool = True) -> "ReplayScenario":
        base = os.path.splitext(os.path.basename(os.fspath(path)))[0]
        return cls.from_requests(load_csv(path), name=name or base,
                                 start_s=start_s, stop_s=stop_s, loop=loop)

    def generate(self, rate_rps: float = 60.0, duration_s: float = 120.0,
                 seed: int = 0) -> list[Request]:
        window = splice(list(self.requests), self.start_s, self.stop_s)
        if not window:
            return []
        if max(r.arrival_s for r in window) <= 0:
            # Degenerate window (one request, or identical timestamps):
            # nothing to rescale — replay the burst at t=0 as-is.
            return window
        scaled = rescale_rate(window, rate_rps)
        # Rescaling to mean rate r makes the span exactly len/r — also
        # the tiling period, so recorded gaps survive across the seam.
        period = len(scaled) / rate_rps
        out: list[Request] = []
        offset = 0.0
        while offset < duration_s:
            for r in scaled:
                t = r.arrival_s + offset
                if t >= duration_s:
                    break
                out.append(dataclasses.replace(r, req_id=len(out),
                                               arrival_s=t))
            if not self.loop:
                break
            offset += period
        return out
