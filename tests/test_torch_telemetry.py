"""Telemetry of the port (`repro_torch.telemetry` and its hooks in the
core manager, both engines, the runner and the serving engine) against
the reference, on the CPU.

- The probe layer runs side by side with `repro.telemetry`, which
  imports in this process (numpy and the standard library only), on the
  same seeded inputs.
- The reference simulator and serving engine run in one child
  interpreter (`torch_harness`, ROADMAP R1), which exports its hubs
  into a temporary directory and answers with their summaries.
- Purity: a run with a hub equals the run without, in `to_dict()` less
  `provenance`, `telemetry_summary` and `config_hash` (the telemetry
  field is part of the fingerprint), on the event engine and on both
  fleet backends.
- Exports equal the reference's on the same run, with one mask
  (`_mask`): the wall-clock fields, i.e. the `phase/*_wall_s` and
  `events_per_sec` gauges and the `wall_s` of the `phase` events.
- The fleet engine's hub equals the reference's on numpy and is within
  `AGREE_RTOL` of the reference's jax hub on torch (CPU); as in the
  reference, the fleet path returns no summary (ROADMAP R7).
- The port's span ring (no counterpart in the reference): nesting, drop
  counts, device times; the spans leave a hub's summary as the
  reference's, and the serving engine's spans (`trace`) leave its core
  manager's hub equal to the reference engine's.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import urllib.request

import jax
import numpy as np
import pytest
from torch_harness import run_reference

import repro.telemetry as ref_tel
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro_torch import telemetry as tel
from repro_torch.configs import get_smoke_config
from repro_torch.core import CoreManager
from repro_torch.models import Model, params_from_jax
from repro_torch.serving.engine import InferenceEngine
from repro_torch.sim import ExperimentConfig, run_experiment
from repro_torch.telemetry.hub import DEFAULT_MAX_SPANS

# tests/test_telemetry.py's config: a permanently dirty grid and full
# deferral, so carbon-aware cause records appear on a short run
CARBON_DEFER_OPTS = {
    "carbon_aware": True,
    "intensity_opts": (("phase", math.pi / 2),),
    "dirty_frac": 1.0,
    "defer_frac": 1.0,
}
# (ExperimentConfig kwargs) of tests/test_telemetry.py::_telemetry_cfg
TELEMETRY_KW = {"duration_s": 12.0, "rate_rps": 60.0, "seed": 0,
                "policy_opts": CARBON_DEFER_OPTS}
# the default dims without the carbon gate, whose event counts are known
SUMMARY_KW = {"duration_s": 12.0, "rate_rps": 60.0, "seed": 0}
SUMMARY_KINDS = {"assign": 5686, "engine": 1, "gate": 885, "oversub": 2612,
                 "phase": 4, "promote": 2266, "release": 8291, "route": 1008,
                 "wake": 33}
FLEET_KW = {"duration_s": 60.0}
# torch (CPU) against jax, as tests/test_torch_fleetsim.py holds results
AGREE_RTOL = 1e-6
# the engine case: llama3-8b's float32 smoke config, 3 requests, 2 slots
ENGINE_CASE = {"batch": 2, "max_len": 32, "policy": "proposed", "cores": 4,
               "prompts": [[5, 9, 2, 7, 1, 3], [4, 4, 8], [11, 6, 2, 9, 3]],
               "news": [4, 3, 5]}

_CHILD = r'''
import math
import os
import dataclasses
import jax
from repro.configs import get_smoke_config
from repro.models import Model
from repro.serving.engine import InferenceEngine
from repro.sim import ExperimentConfig, run_experiment
from repro.telemetry import TelemetryHub, export_run, prometheus_text

d = job["dir"]
out = {}
cfg = ExperimentConfig(**job["telemetry_kw"]).with_telemetry()
hub = TelemetryHub.from_opts(cfg.telemetry_options)
res = run_experiment(cfg, telemetry=hub)
paths = export_run(hub, os.path.join(d, "export"), t_end=cfg.duration_s)
out["export_paths"] = {k: os.path.relpath(v, d) for k, v in paths.items()}
runner = os.path.join(d, "runner")
res2 = run_experiment(cfg.with_telemetry(export_dir=runner))
out["runner_paths"] = {k: os.path.relpath(v, runner)
                       for k, v in res2.telemetry_summary["export"].items()}
# the fingerprint of the port's export_dir, where the port writes
out["port_fingerprint"] = cfg.with_telemetry(
    export_dir=job["port_runner"]).fingerprint()
out["ref_fingerprint"] = cfg.with_telemetry(export_dir=runner).fingerprint()
out["summary"] = run_experiment(
    ExperimentConfig(**job["summary_kw"]).with_telemetry()).telemetry_summary

out["fleet"] = {}
for backend in ("numpy", "jax"):
    fcfg = ExperimentConfig(**job["fleet_kw"]).with_engine(
        "fleet", backend=backend)
    hub = TelemetryHub()
    r = run_experiment(fcfg, telemetry=hub)
    out["fleet"][backend] = {
        "hub": hub.summary(), "events": list(hub.events),
        "timelines": {n: [[t, [float(x) for x in v]]
                          for t, v in tl.samples()]
                      for n, tl in hub.timelines.items()},
        "result_summary": r.telemetry_summary,
        "cfg_summary": run_experiment(
            fcfg.with_telemetry()).telemetry_summary}

case = job["engine"]
mcfg = dataclasses.replace(get_smoke_config("llama3-8b"), dtype="float32")
model = Model(mcfg)
params = model.init(jax.random.key(0))
fake = [0.0]
hub = TelemetryHub()
eng = InferenceEngine(model, params, max_batch=case["batch"],
                      max_len=case["max_len"], policy=case["policy"],
                      num_host_cores=case["cores"], clock=lambda: fake[0],
                      telemetry=hub)
for p, n in zip(case["prompts"], case["news"]):
    eng.submit(p, n)
for _ in range(100):
    if not eng.pending and not eng.active_mask.any():
        break
    eng.step()
    fake[0] += 0.1
out["engine"] = {"prometheus": eng.prometheus_text(),
                 "summary": hub.summary()}
json.dump(out, sys.stdout)
'''


def _wall(key: str) -> bool:
    return key in ("wall_s", "events_per_sec") or (
        key.startswith("phase/") and key.endswith("_wall_s"))


def _mask(obj):
    """`obj` with the wall-clock fields set to None (see the module
    docstring); everything else is compared as it is."""
    if isinstance(obj, dict):
        return {k: None if _wall(k) else _mask(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _mask_prometheus(text: str) -> list[str]:
    out = []
    for line in text.splitlines():
        name = line.rpartition(" ")[0]
        if name.startswith("repro_phase_") and name.endswith("_wall_s") \
                or name == "repro_events_per_sec":
            line = name + " <wall>"
        out.append(line)
    return out


def _jsonl(path):
    with open(path) as f:
        return [_mask(json.loads(line)) for line in f]


def _scalars(result) -> dict:
    d = result.to_dict()
    for key in ("provenance", "telemetry_summary", "config_hash"):
        d.pop(key, None)
    return d


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_telemetry")
    port_runner = tmp_path_factory.mktemp("port_runner")
    job = {"dir": str(d), "port_runner": str(port_runner),
           "telemetry_kw": TELEMETRY_KW,
           "summary_kw": SUMMARY_KW, "fleet_kw": FLEET_KW,
           "engine": ENGINE_CASE}
    out = run_reference(_CHILD, job)
    out["dir"] = str(d)
    out["port_runner"] = str(port_runner)
    return out


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's run of `TELEMETRY_KW`, exported as the child exports."""
    d = tmp_path_factory.mktemp("port_telemetry")
    cfg = ExperimentConfig(**TELEMETRY_KW).with_telemetry()
    hub = tel.TelemetryHub.from_opts(cfg.telemetry_options)
    result = run_experiment(cfg, telemetry=hub)
    paths = tel.export_run(hub, str(d / "export"), t_end=cfg.duration_s)
    return {"cfg": cfg, "hub": hub, "result": result, "dir": str(d),
            "paths": paths}


# ---------------------------------------------------------------------- #
# probe layer, side by side with repro.telemetry
# ---------------------------------------------------------------------- #
class TestProbes:
    def test_histogram_edges(self):
        rng = np.random.default_rng(0)
        values = np.concatenate([10.0 ** rng.uniform(-8, 8, 500),
                                 [0.0, -1.0, 1e-6, 1e6, 1.0, 10.0]])
        for v in values.tolist():
            assert tel.hist_bin_index(v) == ref_tel.hist_bin_index(v)
        assert tel.hub.HIST_BINS == ref_tel.hub.HIST_BINS
        for i in range(-1, tel.hub.HIST_BINS + 1):
            assert tel.hist_bin_upper(i) == ref_tel.hist_bin_upper(i)

    @pytest.mark.parametrize("trial", range(8))
    def test_windowed_ring(self, trial):
        """The ring equals the reference's ring and a full-history
        recompute on the same seeded observations."""
        rng = np.random.default_rng(trial)
        n = int(rng.integers(1, 300))
        obs = list(zip(np.sort(rng.uniform(0.0, 500.0, n)).tolist(),
                       (10.0 ** rng.uniform(-6, 5, n)).tolist()))
        window_s = float(rng.choice([0.5, 1.0, 7.3]))
        max_windows = int(rng.choice([4, 64, 4096]))
        port = tel.WindowedSeries("x", window_s, max_windows)
        ref = ref_tel.WindowedSeries("x", window_s, max_windows)
        for t, v in obs:
            port.observe(t, v)
            ref.observe(t, v)
        assert port.windows() == ref.windows()
        assert port.merged_bins() == ref.merged_bins()
        for q in (0.5, 0.9, 0.99):
            assert port.quantile(q) == ref.quantile(q)
        full: dict[int, list[float]] = {}
        for t, v in obs:
            full.setdefault(int(t / window_s), []).append(v)
        keep = sorted(full)[-max_windows:]
        got = {int(round(w["t_start"] / window_s)): w
               for w in port.windows()}
        assert sorted(got) == keep
        for idx in keep:
            assert got[idx]["count"] == len(full[idx])
            assert got[idx]["total"] == pytest.approx(math.fsum(full[idx]),
                                                      rel=1e-9)
            assert (got[idx]["min"], got[idx]["max"]) == \
                (min(full[idx]), max(full[idx]))

    def test_out_of_order_policy(self):
        seen = []
        for mod in (tel, ref_tel):
            s = mod.WindowedSeries("x", window_s=1.0, max_windows=2)
            for t, v in ((0.5, 1.0), (1.5, 1.0), (2.5, 1.0), (1.7, 5.0),
                         (0.1, 9.0)):
                s.observe(t, v)
            seen.append((s.windows(), s.dropped_observations,
                         s.dropped_windows))
        assert seen[0] == seen[1]
        assert seen[0][1] == 1

    def test_timeline_ring(self):
        seen = []
        for mod in (tel, ref_tel):
            hub = mod.TelemetryHub(timeline_maxlen=3)
            tl = hub.timeline("t")
            for i in range(5):
                tl.record(float(i), (float(i),))
            seen.append((tl.samples(), tl.dropped, hub.summary()))
        assert seen[0] == seen[1]
        assert [t for t, _ in seen[0][0]] == [2.0, 3.0, 4.0]

    def test_timeline_stride_of_the_core_manager(self):
        """`timeline_every=3`: the per-core timelines take every third
        periodic tick, the series every tick."""
        hub = tel.TelemetryHub(timeline_every=3)
        mgr = CoreManager(8, policy="proposed", telemetry=hub,
                          telemetry_id=2, rng=np.random.default_rng(0))
        for k in range(1, 11):
            mgr.periodic(k * mgr.idling_period_s)
        for name in ("freq", "dvth", "cstate"):
            tl = hub.timelines[f"m2/{name}"]
            assert [t for t, _ in tl.samples()] == \
                [k * mgr.idling_period_s for k in (3, 6, 9)]
            assert len(tl.samples()[0][1]) == 8
        assert hub.series["m2/active_cores"].count == 10

    def test_event_ring(self):
        seen = []
        for mod in (tel, ref_tel):
            hub = mod.TelemetryHub(max_events=10)
            for i in range(25):
                hub.event("k", float(i), n=i)
            seen.append((list(hub.events), hub.summary()))
        assert seen[0] == seen[1]
        assert seen[0][1]["events_dropped"] == 15

    def test_span_ring(self):
        """Spans nest by what was open when they began, a full ring
        counts what it drops, and the spans leave the summary as the
        reference's."""
        hub = tel.TelemetryHub()
        assert hub.spans.maxlen == DEFAULT_MAX_SPANS
        hub.spans = collections.deque(maxlen=4)
        ref = ref_tel.TelemetryHub()
        assert hub.summary() == ref.summary()
        outer = hub.begin("outer", req=3)
        first = hub.begin("a", n=2)
        second = hub.switch(first, "b")
        hub.end(outer)                       # closes `b` too
        queued = hub.record("queued", 5, 9, req=3, n=7)
        hub.end(hub.begin("root"))
        assert [s.name for s in hub.spans] == ["a", "outer", "queued",
                                               "root"]
        assert (first.parent, second.parent) == (outer.id, outer.id)
        assert outer.parent == queued.parent == hub.spans[-1].parent == -1
        assert (outer.req, first.n, queued.end - queued.start) == (3, 2, 4)
        assert outer.start <= first.start <= first.end <= second.start \
            <= outer.end
        assert hub.spans_dropped == 0 and not hub._open
        hub.record("x", 0, 1)
        hub.record("y", 0, 1)
        assert len(hub.spans) == 4 and hub.spans_dropped == 2
        assert [s.name for s in hub.spans] == ["queued", "root", "x", "y"]
        assert hub.summary() == ref.summary()

    def test_span_device_ms(self):
        class Ev:
            def __init__(self, t):
                self.t = t

            def elapsed_time(self, other):
                return other.t - self.t
        hub = tel.TelemetryHub()
        sp = hub.begin("prefill")
        assert sp.device_ms() is None
        sp.dev = (Ev(1.5), Ev(4.0))
        hub.end(sp)
        assert sp.device_ms() == 2.5

    def test_null_hub_and_from_opts(self):
        for mod in (tel, ref_tel):
            assert mod.NULL_HUB.enabled is False
            mod.NULL_HUB.inc("x")
            mod.NULL_HUB.event("k", 0.0)
            mod.NULL_HUB.timeline("t").record(0.0, (1.0,))
            assert mod.NULL_HUB.summary() == {}
        opts = {"window_s": 2.0, "max_events": 9, "export_dir": "/x",
                "unknown_key": 1, "timeline_every": 4}
        port, ref = (mod.TelemetryHub.from_opts(opts)
                     for mod in (tel, ref_tel))
        assert (port.window_s, port.events.maxlen, port.timeline_every) \
            == (ref.window_s, ref.events.maxlen, ref.timeline_every) \
            == (2.0, 9, 4)

    def test_schema_and_prefix(self):
        assert tel.EVENT_SCHEMA_VERSION == ref_tel.EVENT_SCHEMA_VERSION
        hub = tel.TelemetryHub()
        hub.inc("a", 3)
        assert "repro_a_total 3" in tel.prometheus_text(hub).splitlines()


# ---------------------------------------------------------------------- #
# purity: a hub changes no result
# ---------------------------------------------------------------------- #
class TestPurity:
    def test_event_engine(self):
        """tests/test_telemetry.py::TestPurity's config."""
        base = ExperimentConfig(duration_s=10.0, rate_rps=60.0, seed=3,
                                policy_opts=CARBON_DEFER_OPTS)
        off = run_experiment(base)
        on = run_experiment(base.with_telemetry())
        assert off.telemetry_summary is None
        assert on.telemetry_summary["events"] > 0
        assert _scalars(on) == _scalars(off)
        assert "telemetry_summary" not in on.scalars()

    @pytest.mark.parametrize("opts", [{"backend": "numpy"},
                                      {"backend": "torch", "device": "cpu"}],
                             ids=["numpy", "torch"])
    def test_fleet_engine(self, opts):
        base = ExperimentConfig(**FLEET_KW).with_engine("fleet", **opts)
        off = run_experiment(base)
        hub = tel.TelemetryHub()
        on = run_experiment(base.with_telemetry(), telemetry=hub)
        assert hub.summary()["timelines"]["fleet/windows"]["points"] > 0
        assert _scalars(on) == _scalars(off)


# ---------------------------------------------------------------------- #
# exports against the live reference (wall-clock fields masked)
# ---------------------------------------------------------------------- #
class TestExports:
    def _ref(self, reference, surface):
        return os.path.join(reference["dir"],
                            reference["export_paths"][surface])

    def test_jsonl_events(self, reference, port_run):
        port = _jsonl(port_run["paths"]["events_jsonl"])
        assert port == _jsonl(self._ref(reference, "events_jsonl"))
        meta, events = tel.read_jsonl(port_run["paths"]["events_jsonl"])
        assert meta["schema"] == tel.EVENT_SCHEMA_VERSION
        kinds = {e["kind"] for e in events}
        assert {"gate", "wake", "carbon_deferral", "route"} <= kinds

    def test_chrome_trace(self, reference, port_run):
        docs = []
        for path in (port_run["paths"]["chrome_trace"],
                     self._ref(reference, "chrome_trace")):
            with open(path) as f:
                docs.append(_mask(json.load(f)))
        assert docs[0] == docs[1]
        assert any(e["name"] == "gated" for e in docs[0]["traceEvents"])

    def test_series_csv(self, reference, port_run):
        with open(port_run["paths"]["series_csv"]) as f:
            port = f.read()
        with open(self._ref(reference, "series_csv")) as f:
            assert port == f.read()
        assert port.count("\n") > 1

    def test_series_npz(self, reference, port_run):
        with np.load(port_run["paths"]["series_npz"]) as port, \
                np.load(self._ref(reference, "series_npz")) as ref:
            assert sorted(port.files) == sorted(ref.files)
            assert any(k.endswith("/freq/values") for k in port.files)
            for key in ref.files:
                np.testing.assert_array_equal(port[key], ref[key],
                                              err_msg=key)

    def test_prometheus_text(self, reference, port_run):
        with open(port_run["paths"]["prometheus"]) as f:
            port = f.read()
        with open(self._ref(reference, "prometheus")) as f:
            assert _mask_prometheus(port) == _mask_prometheus(f.read())
        assert port == tel.prometheus_text(port_run["hub"])

    def test_export_file_lists(self, reference, port_run):
        """`export_run`'s files, and the runner's `export_dir/<policy>-
        <fingerprint>` (the fingerprint holds `export_dir`, so each
        package's is its own directory's)."""
        assert {k: os.path.relpath(v, port_run["dir"])
                for k, v in port_run["paths"].items()} == \
            reference["export_paths"]
        runner = reference["port_runner"]
        cfg = port_run["cfg"].with_telemetry(export_dir=runner)
        assert cfg.fingerprint() == reference["port_fingerprint"]
        res = run_experiment(cfg)
        paths = res.telemetry_summary["export"]
        got = {k: os.path.relpath(v, runner) for k, v in paths.items()}
        want = {k: v.replace(reference["ref_fingerprint"],
                             reference["port_fingerprint"])
                for k, v in reference["runner_paths"].items()}
        assert got == want
        for p in paths.values():
            assert os.path.getsize(p) > 0

    def test_summary_in_result(self, port_run):
        s = port_run["result"].telemetry_summary
        assert "carbon_deferral" in s["event_kinds"]
        back = type(port_run["result"]).from_dict(
            port_run["result"].to_dict())
        assert back.telemetry_summary == s

    def test_metrics_server_serves_a_snapshot(self, port_run):
        hub = port_run["hub"]
        server = tel.start_metrics_server(lambda: tel.prometheus_text(hub),
                                          port=0)
        try:
            assert server.server_address[0] == "127.0.0.1"
            url = f"http://127.0.0.1:{server.server_port}/metrics"
            with urllib.request.urlopen(url, timeout=5) as resp:
                body = resp.read().decode()
            assert body == tel.prometheus_text(hub)
        finally:
            server.shutdown()
            server.server_close()


def test_event_summary_equals_reference(reference):
    res = run_experiment(ExperimentConfig(**SUMMARY_KW).with_telemetry())
    s = res.telemetry_summary
    assert _mask(s) == _mask(reference["summary"])
    assert s["events"] == 20786 and s["event_kinds"] == SUMMARY_KINDS
    assert sorted(s["gauges"]) == [
        "engine/aging_backend_is_jax", "events_per_sec", "events_processed",
        "phase/cluster_build_wall_s", "phase/collect_wall_s",
        "phase/sim_run_wall_s", "phase/trace_gen_wall_s"]
    assert s["gauges"]["engine/aging_backend_is_jax"] == 0.0


# ---------------------------------------------------------------------- #
# the fleet engine's hub
# ---------------------------------------------------------------------- #
class TestFleetHub:
    def _port(self, **opts):
        hub = tel.TelemetryHub()
        res = run_experiment(ExperimentConfig(**FLEET_KW).with_engine(
            "fleet", **opts), telemetry=hub)
        return hub, res

    def test_numpy_equals_reference(self, reference):
        hub, res = self._port(backend="numpy")
        ref = reference["fleet"]["numpy"]
        assert hub.summary() == ref["hub"]
        assert list(hub.events) == ref["events"]
        for name, samples in ref["timelines"].items():
            got = [[t, [float(x) for x in v]]
                   for t, v in hub.timelines[name].samples()]
            assert got == samples, name
        assert hub.summary()["gauges"] == {
            "fleet/completions": 1218.0480119793938,
            "fleet/gated_cores_final": 856.0}
        assert hub.summary()["timelines"]["fleet/windows"]["points"] == 240
        assert res.telemetry_summary is None

    def test_torch_agrees_with_jax(self, reference):
        hub, _ = self._port(backend="torch", device="cpu")
        ref = reference["fleet"]["jax"]
        s = hub.summary()
        assert s["events"] == ref["hub"]["events"] == 1
        assert hub.events[0] == {"kind": "engine", "t": 0.0,
                                 "engine": "fleet", "backend": "torch"}
        assert ref["events"][0]["backend"] == "jax"
        assert s["timelines"] == ref["hub"]["timelines"]
        assert s["gauges"]["fleet/gated_cores_final"] == \
            ref["hub"]["gauges"]["fleet/gated_cores_final"]
        assert s["gauges"]["fleet/completions"] == pytest.approx(
            ref["hub"]["gauges"]["fleet/completions"], rel=AGREE_RTOL)
        # Each column within AGREE_RTOL of its own value or of the
        # column's largest: the CPU-wait column of `fleet/windows` is a
        # float32 cancellation residue (`todo - done`, as in ROADMAP R5)
        # near zero in some windows, where jax and torch round apart
        # (largest delta seen: 6.5e-9 s against a column maximum of
        # 0.0129 s; every other entry within 5e-7 relative).
        for name, samples in ref["timelines"].items():
            got = hub.timelines[name].samples()
            assert [t for t, _ in got] == [t for t, _ in samples], name
            got = np.array([v for _, v in got], dtype=np.float64)
            want = np.array([v for _, v in samples])
            bound = AGREE_RTOL * np.maximum(np.abs(want),
                                            np.abs(want).max(axis=0))
            assert (np.abs(got - want) <= bound).all(), name

    @pytest.mark.parametrize("opts", [{"backend": "numpy"},
                                      {"backend": "torch", "device": "cpu"}],
                             ids=["numpy", "torch"])
    def test_summary_is_dropped_as_in_the_reference(self, reference, opts):
        """ROADMAP R7: `cfg.with_telemetry()` on the fleet engine builds
        a hub that fills but never reaches the result."""
        res = run_experiment(ExperimentConfig(**FLEET_KW).with_engine(
            "fleet", **opts).with_telemetry())
        assert res.telemetry_summary is None
        assert reference["fleet"]["numpy"]["cfg_summary"] is None
        assert reference["fleet"]["jax"]["cfg_summary"] is None


# ---------------------------------------------------------------------- #
# the serving engine
# ---------------------------------------------------------------------- #
def _engine_case_model():
    cfg = dataclasses.replace(ref_smoke_config("llama3-8b"), dtype="float32")
    params = RefModel(cfg).init(jax.random.key(0))
    port_cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                                   dtype="float32")
    model = Model(port_cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        port_cfg, jax.tree.map(np.asarray, params)))
    return model


def _serve_engine_case(model, hub, trace=None):
    c = ENGINE_CASE
    fake = [0.0]
    eng = InferenceEngine(model, max_batch=c["batch"],
                          max_len=c["max_len"], policy=c["policy"],
                          num_host_cores=c["cores"],
                          clock=lambda: fake[0], telemetry=hub)
    eng.trace = trace
    reqs = []
    for p, n in zip(c["prompts"], c["news"]):
        eng.submit(p, n)
        reqs.append(eng.pending[-1])
    for _ in range(100):
        if not eng.pending and not eng.active_mask.any():
            break
        eng.step()
        fake[0] += 0.1
    return eng, [r.output for r in reqs]


def test_engine_with_a_hub(reference):
    """Tokens as without a hub; `prometheus_text()` equal to the
    reference engine's on the same requests under the same fake clock."""
    model = _engine_case_model()
    hub = tel.TelemetryHub()
    eng, tokens = _serve_engine_case(model, hub)
    _, plain = _serve_engine_case(model, None)
    assert tokens == plain
    assert hub.counter("assigns").value == eng.core_manager.metrics.assigns
    assert hub.summary() == reference["engine"]["summary"]
    text = eng.prometheus_text()
    assert text == reference["engine"]["prometheus"]
    assert "repro_host_assigns" in text


def test_engine_with_a_hub_and_a_trace(reference):
    """The engine's spans go to its own hub (`trace`): the core
    manager's hub still sums up as the reference engine's, and
    `prometheus_text()` is the reference's with the trace's serving
    totals after it."""
    model = _engine_case_model()
    hub, trace = tel.TelemetryHub(), tel.TelemetryHub()
    eng, tokens = _serve_engine_case(model, hub, trace)
    assert tokens == _serve_engine_case(model, None)[1]
    assert hub.summary() == reference["engine"]["summary"]
    assert not hub.spans and trace.spans
    text = eng.prometheus_text()
    ref = reference["engine"]["prometheus"]
    assert text.startswith(ref)
    c = ENGINE_CASE
    assert f"repro_admissions_total {len(c['prompts'])}" in \
        text[len(ref):].splitlines()
    assert trace.summary()["counters"]["prefill_tokens"] == \
        sum(map(len, c["prompts"]))
