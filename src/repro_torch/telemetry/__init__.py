"""Streaming telemetry: typed probes, structured event tracing, and
exporters (JSONL / Chrome trace / CSV / npz / Prometheus text).

See `repro_torch.telemetry.hub` for the probe taxonomy and
`repro_torch.telemetry.export` for the export surfaces.

A copy of `repro.telemetry` (numpy and the standard library only) with
its imports rewritten. Every wording, `EVENT_SCHEMA_VERSION` and the
Prometheus prefix `repro_` are the reference's, so the port's exports of
a run equal the reference's exports of the same run.
"""
from repro_torch.telemetry.hub import (
    NULL_HUB,
    Counter,
    Gauge,
    NullHub,
    TelemetryHub,
    Timeline,
    WindowedSeries,
    hist_bin_index,
    hist_bin_upper,
)
from repro_torch.telemetry.export import (
    EVENT_SCHEMA_VERSION,
    chrome_trace,
    export_run,
    prometheus_text,
    read_jsonl,
    series_to_csv,
    series_to_npz,
    start_metrics_server,
    write_chrome_trace,
    write_jsonl,
)

__all__ = [
    "TelemetryHub", "NullHub", "NULL_HUB", "Counter", "Gauge",
    "WindowedSeries", "Timeline", "hist_bin_index", "hist_bin_upper",
    "EVENT_SCHEMA_VERSION", "write_jsonl", "read_jsonl", "chrome_trace",
    "write_chrome_trace", "series_to_csv", "series_to_npz",
    "prometheus_text", "export_run", "start_metrics_server",
]
