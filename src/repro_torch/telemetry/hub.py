"""TelemetryHub — typed streaming probes + structured event tracing.

The simulator's headline claims are *temporal* (p99-managed aging
evolution, windowed carbon, wake-deferral causality), but results used
to surface only end-of-run scalars. The hub is the one sink every layer
publishes into:

  * `Counter` / `Gauge`     — monotonic totals and last-value samples.
  * `WindowedSeries`        — ring-buffered fixed-width time windows,
                              each aggregating count/sum/min/max plus a
                              log-bucketed histogram, so quantiles of a
                              signal survive a simulated month in
                              bounded memory (ROADMAP streaming-metrics
                              groundwork).
  * `Timeline`              — ring of `(t, vector)` samples (per-core
                              frequency/dVth snapshots, carbon windows).
  * structured event log    — ring-buffered dicts with cause
                              attribution (`gate` / `wake` / `assign` /
                              `promote` / `oversub` / `carbon_deferral`
                              / `route` / `phase`), the raw stream the
                              JSONL and Chrome-trace exporters replay.
  * span ring               — `Span`s of a live program (the serving
                              engine's steps, admissions, model calls
                              and host tasks): name, start and end in
                              `time.perf_counter_ns`, own and parent
                              id, request id and one count, and an
                              optional pair of device events.

Everything is bounded: events, spans and timelines are
`deque(maxlen=...)` rings, series retain the last `max_windows`
windows; overflow counts are kept (`events_dropped`, `spans_dropped`,
per-series `dropped_windows`) so truncation is visible, never silent.

Zero-cost when disabled: producers hold `None` (or the `NULL_HUB`
no-op) and guard every emission with one attribute test, so the
bit-exact fast-path suites and `BENCH_sim.json` are untouched when
telemetry is off. Recording is pure observation — it never mutates
aging state or draws from simulation RNG streams — so telemetry-ON
runs produce bit-identical `ExperimentResult`s too (pinned in
tests/test_telemetry.py).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import math
import time
from typing import Any, Iterable

__all__ = [
    "Counter", "Gauge", "WindowedSeries", "Timeline", "Span",
    "TelemetryHub", "NullHub", "NULL_HUB", "DEFAULT_MAX_EVENTS",
    "DEFAULT_MAX_SPANS", "DEFAULT_MAX_WINDOWS", "DEFAULT_TIMELINE_MAXLEN",
    "HIST_BINS", "hist_bin_index", "hist_bin_upper",
]

DEFAULT_MAX_EVENTS = 200_000
DEFAULT_MAX_SPANS = 200_000
DEFAULT_MAX_WINDOWS = 4096
DEFAULT_TIMELINE_MAXLEN = 4096

# Log-bucketed histogram layout shared by every series: 8 buckets per
# decade across [1e-6, 1e6), plus an underflow bucket (index 0, values
# <= 0 or < 1e-6) and an overflow bucket (last index). 98 buckets total.
_HIST_LO_EXP = -6
_HIST_HI_EXP = 6
_HIST_PER_DECADE = 8
HIST_BINS = (_HIST_HI_EXP - _HIST_LO_EXP) * _HIST_PER_DECADE + 2


def hist_bin_index(v: float) -> int:
    """Bucket index for value `v` under the shared log layout."""
    if v <= 0.0 or v < 10.0 ** _HIST_LO_EXP:
        return 0
    if v >= 10.0 ** _HIST_HI_EXP:
        return HIST_BINS - 1
    return 1 + int((math.log10(v) - _HIST_LO_EXP) * _HIST_PER_DECADE)


def hist_bin_upper(i: int) -> float:
    """Upper edge of bucket `i` (inf for the overflow bucket)."""
    if i <= 0:
        return 10.0 ** _HIST_LO_EXP
    if i >= HIST_BINS - 1:
        return math.inf
    return 10.0 ** (_HIST_LO_EXP + i / _HIST_PER_DECADE)


class Counter:
    """Monotonically increasing probe (`assigns`, `gates`, ...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def __repr__(self) -> str:
        return f"Counter({self.name!r}, {self.value})"


class Gauge:
    """Last-value probe (`events_per_sec`, phase wall times, ...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = float("nan")

    def set(self, v: float) -> None:
        self.value = float(v)

    def __repr__(self) -> str:
        return f"Gauge({self.name!r}, {self.value})"


@dataclasses.dataclass
class _Window:
    """One live aggregation window of a `WindowedSeries`."""

    index: int                      # window number = floor(t / window_s)
    count: int = 0
    total: float = 0.0
    vmin: float = math.inf
    vmax: float = -math.inf
    bins: list[int] = dataclasses.field(
        default_factory=lambda: [0] * HIST_BINS)

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        self.bins[hist_bin_index(v)] += 1


class WindowedSeries:
    """Ring-buffered windowed aggregates + quantile sketch of one signal.

    `observe(t, v)` lands `v` in the window `floor(t / window_s)`;
    windows are materialized only when they receive data (a sparse
    signal over a week does not allocate a week of windows), and only
    the most recent `max_windows` are retained — older ones fall off
    the ring, counted in `dropped_windows`. Observation times are
    expected (sim event loops guarantee it) to be non-decreasing; a
    stale `t` still lands correctly if its window is retained and is
    dropped (counted) otherwise.
    """

    __slots__ = ("name", "window_s", "max_windows", "_ring",
                 "dropped_windows", "dropped_observations")

    def __init__(self, name: str, window_s: float = 1.0,
                 max_windows: int = DEFAULT_MAX_WINDOWS):
        if window_s <= 0.0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if max_windows < 1:
            raise ValueError(f"max_windows must be >= 1, got {max_windows}")
        self.name = name
        self.window_s = window_s
        self.max_windows = max_windows
        self._ring: collections.deque[_Window] = collections.deque()
        self.dropped_windows = 0
        self.dropped_observations = 0

    def observe(self, t: float, v: float) -> None:
        idx = int(t / self.window_s)
        ring = self._ring
        if ring:
            last = ring[-1].index
            if idx < last:
                # Rare out-of-order observation: fold into its window if
                # still retained, else count the drop (never silently).
                for w in reversed(ring):
                    if w.index == idx:
                        w.observe(v)
                        return
                    if w.index < idx:
                        break
                self.dropped_observations += 1
                return
            if idx == last:
                ring[-1].observe(v)
                return
        w = _Window(idx)
        w.observe(v)
        ring.append(w)
        if len(ring) > self.max_windows:
            ring.popleft()
            self.dropped_windows += 1

    # -- read side ----------------------------------------------------- #
    @property
    def count(self) -> int:
        """Observations in the retained windows."""
        return sum(w.count for w in self._ring)

    @property
    def total(self) -> float:
        return sum(w.total for w in self._ring)

    def windows(self) -> list[dict[str, Any]]:
        """Frozen per-window aggregates, oldest retained first."""
        return [{"t_start": w.index * self.window_s,
                 "window_s": self.window_s,
                 "count": w.count, "total": w.total,
                 "mean": w.total / w.count,
                 "min": w.vmin, "max": w.vmax}
                for w in self._ring]

    def merged_bins(self) -> list[int]:
        """Histogram buckets summed over the retained windows."""
        out = [0] * HIST_BINS
        for w in self._ring:
            for i, c in enumerate(w.bins):
                if c:
                    out[i] += c
        return out

    def quantile(self, q: float) -> float:
        """Approximate q-quantile over the retained windows (upper edge
        of the bucket holding the q-th observation; NaN when empty)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        bins = self.merged_bins()
        n = sum(bins)
        if n == 0:
            return float("nan")
        rank = q * (n - 1)
        seen = 0
        for i, c in enumerate(bins):
            seen += c
            if seen > rank:
                return hist_bin_upper(i)
        return hist_bin_upper(HIST_BINS - 1)

    def __repr__(self) -> str:
        return (f"WindowedSeries({self.name!r}, window_s={self.window_s}, "
                f"windows={len(self._ring)})")


class Timeline:
    """Ring of `(t, vector)` samples — per-core frequency/dVth
    snapshots, carbon-window rows. Values are stored as plain tuples so
    exports and round-trips never alias live simulator arrays."""

    __slots__ = ("name", "_ring", "dropped")

    def __init__(self, name: str, maxlen: int = DEFAULT_TIMELINE_MAXLEN):
        if maxlen < 1:
            raise ValueError(f"maxlen must be >= 1, got {maxlen}")
        self.name = name
        self._ring: collections.deque[tuple[float, tuple[float, ...]]] = \
            collections.deque(maxlen=maxlen)
        self.dropped = 0

    def record(self, t: float, values: Iterable[float]) -> None:
        if len(self._ring) == self._ring.maxlen:
            self.dropped += 1
        # Float ndarrays convert through C (`tolist` yields Python
        # floats), skipping the per-element genexpr — same tuples, just
        # cheaper; everything else takes the generic coercion.
        dtype = getattr(values, "dtype", None)
        if dtype is not None and dtype.kind == "f":
            vals = tuple(values.tolist())
        else:
            vals = tuple(float(v) for v in values)
        self._ring.append((float(t), vals))

    def samples(self) -> list[tuple[float, tuple[float, ...]]]:
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def __repr__(self) -> str:
        return f"Timeline({self.name!r}, points={len(self._ring)})"


class Span:
    """One timed stretch of a live program, on `time.perf_counter_ns`.

    `parent` is the id of the span that was open when this one began (-1
    for none), `req` the request it serves (-1 for none) and `n` one
    count of its work (0 for none). `dev`, where set, is a pair of
    device events (`torch.cuda.Event` or anything with `elapsed_time`)
    recorded around the span's device work; `device_ms()` reads it,
    which waits for the second event, so call it only once the work is
    done."""

    __slots__ = ("name", "start", "end", "id", "parent", "req", "n", "dev")

    def __init__(self, name: str, start: int, span_id: int, parent: int,
                 req: int = -1, n: int = 0):
        self.name = name
        self.start = start
        self.end = start
        self.id = span_id
        self.parent = parent
        self.req = req
        self.n = n
        self.dev = None

    @property
    def ns(self) -> int:
        return self.end - self.start

    def device_ms(self) -> float | None:
        return None if self.dev is None else \
            self.dev[0].elapsed_time(self.dev[1])

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"req={self.req}, n={self.n}, ns={self.ns})")


class TelemetryHub:
    """The one sink all layers publish probes and events into.

    One hub serves one experiment (cluster + managers + routers +
    runner self-profiling) or one serving engine. Producers cache the
    probe objects they emit into (`hub.counter(...)` at construction),
    so the hot-path cost with telemetry ON is one method call per
    emission and with telemetry OFF exactly one `is not None` test.
    """

    enabled = True

    def __init__(self, window_s: float = 1.0,
                 max_events: int = DEFAULT_MAX_EVENTS,
                 max_windows: int = DEFAULT_MAX_WINDOWS,
                 timeline_every: int = 1,
                 timeline_maxlen: int = DEFAULT_TIMELINE_MAXLEN):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        if timeline_every < 1:
            raise ValueError(f"timeline_every must be >= 1, got "
                             f"{timeline_every}")
        self.window_s = float(window_s)
        self.max_windows = int(max_windows)
        self.timeline_every = int(timeline_every)
        self.timeline_maxlen = int(timeline_maxlen)
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.series: dict[str, WindowedSeries] = {}
        self.timelines: dict[str, Timeline] = {}
        self.events: collections.deque[dict[str, Any]] = \
            collections.deque(maxlen=int(max_events))
        self.events_dropped = 0
        self.spans: collections.deque[Span] = \
            collections.deque(maxlen=DEFAULT_MAX_SPANS)
        self.spans_dropped = 0
        self._open: list[Span] = []     # spans begun and not yet ended
        self._span_ids = itertools.count()

    # -- probe access (producers cache the returned objects) ----------- #
    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def get_series(self, name: str,
                   window_s: float | None = None) -> WindowedSeries:
        s = self.series.get(name)
        if s is None:
            s = self.series[name] = WindowedSeries(
                name, window_s=window_s or self.window_s,
                max_windows=self.max_windows)
        return s

    def timeline(self, name: str,
                 maxlen: int | None = None) -> Timeline:
        tl = self.timelines.get(name)
        if tl is None:
            tl = self.timelines[name] = Timeline(
                name, maxlen=maxlen or self.timeline_maxlen)
        return tl

    # -- convenience emitters ------------------------------------------ #
    def inc(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    def set_gauge(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, t: float, v: float) -> None:
        self.get_series(name).observe(t, v)

    def event(self, kind: str, t: float, **fields) -> None:
        """Append one structured event to the ring-buffered log."""
        ev = self.events
        if len(ev) == ev.maxlen:
            self.events_dropped += 1
        fields["kind"] = kind
        fields["t"] = t
        ev.append(fields)

    def push(self, ev: dict[str, Any]) -> None:
        """Hot-path `event()`: append a caller-built event dict (which
        must already carry `"kind"` and `"t"`) without the kwargs
        repack. Same ring, same drop accounting."""
        evq = self.events
        if len(evq) == evq.maxlen:
            self.events_dropped += 1
        evq.append(ev)

    # -- spans -------------------------------------------------------- #
    def begin(self, name: str, req: int = -1, n: int = 0) -> Span:
        """Open a span now, as a child of the innermost open one."""
        stack = self._open
        sp = Span(name, time.perf_counter_ns(), next(self._span_ids),
                  stack[-1].id if stack else -1, req, n)
        stack.append(sp)
        return sp

    def end(self, sp: Span) -> None:
        """Close `sp` now (and any span left open inside it) and keep
        it in the ring."""
        sp.end = time.perf_counter_ns()
        stack = self._open
        while stack and stack.pop() is not sp:
            pass
        self._keep(sp)

    def switch(self, sp: Span, name: str, req: int = -1,
               n: int = 0) -> Span:
        """End `sp` and begin its next sibling `name`."""
        self.end(sp)
        return self.begin(name, req, n)

    def record(self, name: str, start: int, end: int, req: int = -1,
               n: int = 0) -> Span:
        """Keep a span timed by the caller, with no parent."""
        sp = Span(name, start, next(self._span_ids), -1, req, n)
        sp.end = end
        self._keep(sp)
        return sp

    def _keep(self, sp: Span) -> None:
        ring = self.spans
        if len(ring) == ring.maxlen:
            self.spans_dropped += 1
        ring.append(sp)

    # -- read side ------------------------------------------------------ #
    def summary(self) -> dict[str, Any]:
        """JSON-safe digest of everything the hub holds — the optional
        `ExperimentResult.telemetry_summary` payload. Scalar metrics of
        the run itself never live here (they are result fields); this
        is the map of what was *emitted*."""
        kinds: dict[str, int] = {}
        for e in self.events:
            kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
        return {
            "events": len(self.events),
            "events_dropped": self.events_dropped,
            "event_kinds": dict(sorted(kinds.items())),
            "counters": {n: c.value
                         for n, c in sorted(self.counters.items())},
            "gauges": {n: g.value for n, g in sorted(self.gauges.items())},
            "series": {
                n: {"windows": len(s._ring), "count": s.count,
                    "window_s": s.window_s,
                    "dropped_windows": s.dropped_windows}
                for n, s in sorted(self.series.items())},
            "timelines": {n: {"points": len(tl), "dropped": tl.dropped}
                          for n, tl in sorted(self.timelines.items())},
        }

    @classmethod
    def from_opts(cls, opts: dict[str, Any]) -> "TelemetryHub":
        """Build a hub from `ExperimentConfig.telemetry_options`
        (ignoring runner-level keys like `export_dir`)."""
        kw = {k: v for k, v in opts.items()
              if k in ("window_s", "max_events", "max_windows",
                       "timeline_every", "timeline_maxlen")}
        return cls(**kw)

    def __repr__(self) -> str:
        return (f"TelemetryHub(events={len(self.events)}, "
                f"series={len(self.series)}, "
                f"counters={len(self.counters)})")


class _NullProbe:
    """No-op Counter/Gauge/Series/Timeline stand-in."""

    __slots__ = ()
    name = "null"
    value = 0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, *a, **kw) -> None:
        pass

    def record(self, *a, **kw) -> None:
        pass


_NULL_PROBE = _NullProbe()


class NullHub:
    """No-op hub: every probe accessor returns a shared no-op object and
    every emitter does nothing. Lets API users write unconditional
    `hub.event(...)` code; the simulator's own hot paths use `None` +
    one `is not None` test instead, which is cheaper still."""

    enabled = False

    def counter(self, name: str) -> _NullProbe:
        return _NULL_PROBE

    def gauge(self, name: str) -> _NullProbe:
        return _NULL_PROBE

    def get_series(self, name: str, window_s=None) -> _NullProbe:
        return _NULL_PROBE

    def timeline(self, name: str, maxlen=None) -> _NullProbe:
        return _NULL_PROBE

    def inc(self, name: str, n: int = 1) -> None:
        pass

    def set_gauge(self, name: str, v: float) -> None:
        pass

    def observe(self, name: str, t: float, v: float) -> None:
        pass

    def event(self, kind: str, t: float, **fields) -> None:
        pass

    def push(self, ev: dict[str, Any]) -> None:
        pass

    def summary(self) -> dict[str, Any]:
        return {}

    def __repr__(self) -> str:
        return "NullHub()"


NULL_HUB = NullHub()
