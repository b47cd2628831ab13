"""Event engine of the port (`repro_torch.sim.cluster`, `routing`,
`fleetstate`, `metrics.collect`, `runner`) against the reference's
(`repro.sim`), on the CPU.

The reference simulator does not import on Python 3.12 (ROADMAP R1), so
it runs in one child interpreter for this module (`torch_harness`),
which returns `ExperimentResult.scalars()` and `to_dict()` as JSON.

- `run_experiment` on the event engine equals the live reference
  exactly (`scalars()` with `config_hash`, and every `to_dict()` field
  but `provenance.package_version`) on the drift gate's mini grid
  (`benchmarks/drift_gate.py`), the golden config of
  `tests/test_policies.py`, each of the seven routers, one mixed fleet
  and the full-width default config.
- The numpy settler equals the reference's bit for bit on the fleets of
  `tests/test_fleetstate.py`; the torch settler on the CPU is within that
  file's `TestJaxBackend` bound (rtol 2e-6, atol 1e-8) of the
  reference's jax settler.
- The event engine agrees with the port's fleet engine within
  `tests/test_fleetsim.py::TestEventParity`'s bounds, and a cluster
  settled by the torch backend with the numpy one within
  `TestBackendAgreement`'s.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch_harness import run_reference

from repro_torch.core import CoreManager
from repro_torch.sim import (Cluster, ExperimentConfig, FleetAgingSettler,
                             GroupedAgingSettler, available_routers, collect,
                             fleetstate, run_experiment, run_policy_sweep,
                             settle_fleet)
from repro_torch.sim import runner
from repro_torch.telemetry import NULL_HUB, TelemetryHub
from repro_torch.workloads import get_scenario

#: `benchmarks/drift_gate.py::mini_grid_config`
MINI = {"duration_s": 8.0, "rate_rps": 40.0, "seed": 0}
#: `tests/test_policies.py::TestEquivalenceWithPreRefactor`
GOLDEN = {"num_cores": 40, "rate_rps": 50, "duration_s": 15, "seed": 7}
MIXED_FLEET = "xeon-28c:5+epyc-64c:rest"
ROUTERS = ("carbon-greedy", "footprint-greedy", "generation-aware", "jsq",
           "least-aged-cpu", "power-of-two", "round-robin")

# (name, ExperimentConfig kwargs), each run on both sides
CONFIGS = {
    **{f"mini-{p}-{r}": dict(MINI, policy=p, router=r)
       for p in ("linux", "proposed") for r in ("jsq", "round-robin")},
    **{f"golden-{p}": dict(GOLDEN, policy=p)
       for p in ("linux", "least-aged", "proposed")},
    **{f"router-{r}": dict(MINI, router=r) for r in ROUTERS
       if r not in ("jsq", "round-robin")},
    "mixed-fleet": dict(MINI, fleet=MIXED_FLEET),
    "default": {},
}
# TestJaxBackend (reference tests/test_fleetstate.py)
SETTLE_TOL = dict(rtol=2e-6, atol=1e-8)
# TestEventParity and TestBackendAgreement (reference tests/test_fleetsim.py)
EVENT_FLEET_BOUNDS = {"completed": 0.10, "mean_latency_s": 0.10,
                      "p99_latency_s": 0.10, "p50_degradation": 0.15,
                      "p50_freq_cv": 0.10, "fleet_yearly_kgco2eq": 0.15,
                      "fleet_energy_kwh": 0.05}
BACKEND_BOUNDS = {"completed": 0.01, "mean_latency_s": 0.01,
                  "p50_degradation": 0.02, "fleet_yearly_kgco2eq": 0.05}

_CHILD = r'''
from repro.core import CoreManager
from repro.sim import ExperimentConfig, run_experiment
from repro.sim.fleetstate import FleetAgingSettler

out = {"results": {}}
for name, kw in job["configs"].items():
    res = run_experiment(ExperimentConfig(**kw))
    out["results"][name] = {"scalars": res.scalars(), "dict": res.to_dict()}

def build_fleet(n_machines=6, num_cores=8, policy="proposed"):
    ms = [CoreManager(num_cores, policy=policy,
                      rng=np.random.default_rng(100 + i))
          for i in range(n_machines)]
    tid = 0
    for i, m in enumerate(ms):
        for _ in range(i % (num_cores // 2 + 1)):
            m.assign(tid, 0.1 * i)
            tid += 1
        if i % 2:
            m.periodic(0.5)
    return ms

fleet = build_fleet()
settler = FleetAgingSettler(fleet)
steps = []
for k in range(1, 6):
    settler.settle(7.3 * k)
    steps.append([[m.dvth.tolist(), m.last_update.tolist(), m.now]
                  for m in fleet])
out["settle_numpy"] = steps
fleet = build_fleet(n_machines=3, num_cores=8)
FleetAgingSettler(fleet, backend="jax").settle(11.0)
out["settle_jax"] = [m.dvth.tolist() for m in fleet]
json.dump(out, sys.stdout)
'''


def build_fleet(n_machines=6, num_cores=8, policy="proposed"):
    """`tests/test_fleetstate.py::build_fleet` on the port's managers:
    heterogeneous per-core regimes (busy / idle / gated)."""
    ms = [CoreManager(num_cores, policy=policy,
                      rng=np.random.default_rng(100 + i))
          for i in range(n_machines)]
    tid = 0
    for i, m in enumerate(ms):
        for _ in range(i % (num_cores // 2 + 1)):
            m.assign(tid, 0.1 * i)
            tid += 1
        if i % 2:
            m.periodic(0.5)
    return ms


@pytest.fixture(scope="module")
def reference():
    """One child interpreter runs every reference case of this module."""
    return run_reference(_CHILD, {"configs": CONFIGS})


@pytest.fixture(scope="module")
def port():
    """The port's result for each config, run once."""
    return {name: run_experiment(ExperimentConfig(**kw))
            for name, kw in CONFIGS.items()}


def _canonical(d: dict) -> str:
    """JSON with the package version dropped: string equality is then
    bit equality of every float (repr round-trips), NaN included."""
    d = json.loads(json.dumps(d))
    d.get("provenance", {}).pop("package_version", None)
    return json.dumps(d, sort_keys=True)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _deltas(res, ref, bounds) -> dict:
    values = {
        "completed": lambda r: r.completed,
        "mean_latency_s": lambda r: r.mean_latency_s,
        "p99_latency_s": lambda r: r.p99_latency_s,
        "p50_degradation": lambda r: r.mean_degradation_percentiles[50],
        "p50_freq_cv": lambda r: r.freq_cv_percentiles[50],
        "fleet_yearly_kgco2eq": lambda r: r.fleet_yearly_kgco2eq,
        "fleet_energy_kwh": lambda r: r.fleet_energy_kwh,
    }
    return {k: _rel(values[k](res), values[k](ref)) for k in bounds}


class TestEventEngineExact:
    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_result_equals_reference(self, reference, port, name):
        want = reference["results"][name]
        got = port[name]
        assert _canonical(got.scalars()) == _canonical(want["scalars"])
        assert got.scalars()["config_hash"] == \
            want["scalars"]["config_hash"]
        assert _canonical(got.to_dict()) == _canonical(want["dict"])

    def test_default_config_is_full_width(self, port):
        res = port["default"]
        assert res.engine == "event"
        assert res.completed == 2550
        assert len(res.per_machine_degradation) == 22

    def test_every_router_is_covered(self):
        assert tuple(available_routers()) == ROUTERS

    def test_mixed_fleet_groups_its_settlers(self):
        cluster = Cluster(ExperimentConfig(**CONFIGS["mixed-fleet"]))
        settler = cluster.fleet_settler
        assert isinstance(settler, GroupedAgingSettler)
        assert sorted(s.num_cores for s in settler.settlers) == [28, 64]
        assert settler.backend == "numpy"


class TestSettler:
    def test_numpy_equals_reference_bit_for_bit(self, reference):
        fleet = build_fleet()
        settler = FleetAgingSettler(fleet)
        for k, want in enumerate(reference["settle_numpy"], start=1):
            settler.settle(7.3 * k)
            for m, (dvth, last, now) in zip(fleet, want):
                np.testing.assert_array_equal(m.dvth, dvth)
                np.testing.assert_array_equal(m.last_update, last)
                assert m.now == now

    def test_numpy_equals_sequential_settle_all(self):
        a, b = build_fleet(), build_fleet()
        for k in range(1, 6):
            for m in a:
                m.settle_all(7.3 * k)
            FleetAgingSettler(b).settle(7.3 * k)
            for ma, mb in zip(a, b):
                np.testing.assert_array_equal(ma.dvth, mb.dvth)
                assert ma.now == mb.now

    def test_torch_on_cpu_agrees_with_reference_jax(self, reference):
        fleet = build_fleet(n_machines=3, num_cores=8)
        FleetAgingSettler(fleet, backend="torch", device="cpu").settle(11.0)
        for m, want in zip(fleet, reference["settle_jax"]):
            np.testing.assert_allclose(m.dvth, want, **SETTLE_TOL)

    def test_torch_settles_through_the_aging_wrapper(self, monkeypatch):
        """One `advance_fleet` call per settle, over the flat (M * N)
        batch; nothing when no time has passed."""
        calls = []
        real = fleetstate.advance_fleet

        def counting(*args):
            calls.append((args[0].numel(), args[0].dtype))
            return real(*args)

        monkeypatch.setattr(fleetstate, "advance_fleet", counting)
        fleet = build_fleet(n_machines=4, num_cores=8)
        settler = FleetAgingSettler(fleet, backend="torch", device="cpu")
        settler.settle(3.0)
        settler.settle(3.0)
        assert calls == [(32, torch.float32)]

    def test_validation_wordings(self):
        with pytest.raises(ValueError, match="at least one"):
            FleetAgingSettler([])
        with pytest.raises(ValueError, match="unknown fleetstate backend "
                                             "'jax'"):
            FleetAgingSettler([CoreManager(4)], backend="jax")
        with pytest.raises(ValueError, match="homogeneous"):
            FleetAgingSettler([CoreManager(4), CoreManager(8)])
        with pytest.raises(ValueError, match="torch backend only"):
            FleetAgingSettler([CoreManager(4)], device="cpu")

    def test_torch_without_a_card_raises(self, monkeypatch):
        """The torch settler defaults to CUDA and never settles on the
        CPU in its place."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for backend in ("torch", "auto"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                FleetAgingSettler([CoreManager(4)], backend=backend)

    def test_auto_resolves_to_torch(self):
        s = FleetAgingSettler([CoreManager(4)], backend="auto", device="cpu")
        assert s.backend == "torch"

    def test_settle_fleet_and_grouped(self):
        ms = build_fleet(n_machines=2)
        settle_fleet(ms, 3.0)
        assert all(m.now == 3.0 for m in ms)
        mixed = [CoreManager(4, rng=np.random.default_rng(0)),
                 CoreManager(8, rng=np.random.default_rng(1))]
        single = [CoreManager(4, rng=np.random.default_rng(0)),
                  CoreManager(8, rng=np.random.default_rng(1))]
        GroupedAgingSettler(mixed).settle(5.0)
        for m in single:
            m.settle_all(5.0)
        for a, b in zip(mixed, single):
            np.testing.assert_array_equal(a.dvth, b.dvth)


class TestAgainstOtherPaths:
    def test_event_engine_agrees_with_fleet_engine(self, port):
        fleet = run_experiment(ExperimentConfig().with_engine(
            "fleet", backend="numpy"))
        deltas = _deltas(fleet, port["default"], EVENT_FLEET_BOUNDS)
        bad = {k: v for k, v in deltas.items()
               if not v < EVENT_FLEET_BOUNDS[k]}
        assert not bad, deltas

    def test_torch_settled_cluster_agrees_with_numpy(self, port,
                                                     monkeypatch):
        """The cluster of the mini config with a torch settler (CPU) put
        in place of its numpy one: one settle per idling period."""
        calls = []
        real = fleetstate.advance_fleet

        def counting(*args):
            calls.append(args[0].numel())
            return real(*args)

        monkeypatch.setattr(fleetstate, "advance_fleet", counting)
        cfg = ExperimentConfig(**CONFIGS["mini-proposed-jsq"])
        cluster = Cluster(cfg)
        cluster.fleet_settler = FleetAgingSettler(
            [m.manager for m in cluster.machines], backend="torch",
            device="cpu")
        trace = get_scenario(cfg.scenario).generate(
            rate_rps=cfg.rate_rps, duration_s=cfg.duration_s, seed=cfg.seed)
        cluster.run(trace, cfg.duration_s,
                    sample_period_s=cfg.sample_period_s)
        res = collect(cluster, cfg)
        assert calls == [cfg.n_machines * cfg.num_cores] * 8
        deltas = _deltas(res, port["mini-proposed-jsq"], BACKEND_BOUNDS)
        bad = {k: v for k, v in deltas.items() if not v < BACKEND_BOUNDS[k]}
        assert not bad, deltas


class TestRunner:
    def test_default_sweep_config_runs_the_event_engine(self, port,
                                                        monkeypatch):
        seen = []

        def recording(cfg):
            seen.append(cfg)
            return port["default"]

        monkeypatch.setattr("repro_torch.sim.runner.run_experiment",
                            recording)
        run_policy_sweep(policies=("proposed",))
        assert seen == [ExperimentConfig()]
        assert seen[0].engine == "event"

    def test_parallel_sweep_equals_serial(self, monkeypatch):
        """The pool spawns its workers, never forks them: a forked child
        cannot use CUDA once its parent has, and forking a threaded
        process may deadlock."""
        methods = []
        real = runner.multiprocessing.get_context

        def recording(method=None):
            methods.append(method)
            return real(method)

        monkeypatch.setattr(runner.multiprocessing, "get_context",
                            recording)
        cfg = ExperimentConfig(duration_s=4.0, rate_rps=40.0)
        kw = dict(policies=("linux", "proposed"), routers=("jsq",))
        serial = run_policy_sweep(cfg, **kw)
        parallel = run_policy_sweep(cfg, parallel=2, **kw)
        assert methods == ["spawn"]
        assert list(parallel) == list(serial)
        for key in serial:
            assert parallel[key].scalars() == serial[key].scalars()

    def test_cluster_and_collect_take_a_hub(self):
        """`Cluster` routes into the hub and samples its three fleet
        series; `collect` adds the carbon windows; the result is the one
        without a hub."""
        cfg = ExperimentConfig(duration_s=6.0, rate_rps=20.0)
        trace = get_scenario(cfg.scenario).generate(
            rate_rps=cfg.rate_rps, duration_s=cfg.duration_s, seed=cfg.seed)
        results = []
        hub = TelemetryHub()
        for tel in (None, hub):
            cluster = Cluster(cfg, telemetry=tel)
            cluster.run(trace, cfg.duration_s)
            results.append(collect(cluster, cfg, telemetry=tel).to_dict())
        assert results[0] == results[1]
        s = hub.summary()
        assert s["counters"]["routes_prompt"] == len(trace)
        assert {"fleet/prompt_queue_depth", "fleet/decode_load",
                "fleet/cpu_tasks", "m0/active_cores"} <= set(s["series"])
        assert s["timelines"]["fleet/carbon_windows"]["points"] > 0
        assert Cluster(cfg, telemetry=NULL_HUB).telemetry is None
