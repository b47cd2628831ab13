"""Fault injection in the port (`repro_torch.faults`, the event engine's
`FaultCoordinator`, the fleet engine's `_FleetFaults` on both backends)
against the reference (`repro.faults`, `repro.sim`), on the CPU.

`repro.faults` imports on Python 3.12 (numpy and `repro.registry` only),
so the registry and the four models are held in-process. The reference
simulator does not (ROADMAP R1): it runs in one child interpreter for
this module (`torch_harness`), which returns `scalars()` and `to_dict()`
as JSON and fleet states as `.npz`.

- The event engine under each fault model equals the live reference
  exactly (`scalars()` with `config_hash`, and every `to_dict()` field
  but `provenance.package_version`): the configs of the reference's
  `TestEventEngineFaults`, its `TestGuardbandAcceptance` pair, guardband
  on a mixed fleet, and a fault-axis policy sweep.
- The fleet engine's numpy backend equals the reference's numpy backend
  exactly under the three models it vectorizes, on `TestFleetEngineFaults`'
  config and on a mixed fleet.
- Its torch backend on the CPU agrees with the reference's jax backend:
  crash and stall counts equal, retries within 1 and availability within
  1e-3 relative (`TestFleetEngineFaults::test_backends_agree_on_counts`);
  under guardband within what the reference's own numpy and jax backends
  show against each other on that config (`GUARD_BOUNDS`). Against the
  port's numpy backend it holds `TestBackendAgreement`'s bounds.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
from torch_harness import run_reference

import repro.faults as ref_faults
from repro_torch import faults
from repro_torch.faults.registry import _REGISTRY
from repro_torch.kernels.aging_update import ops as aging_ops
from repro_torch.sim import (Cluster, ExperimentConfig, FleetAgingSettler,
                             FleetEngine, collect, run_experiment,
                             run_policy_sweep, state_from_numpy,
                             state_to_numpy)
from repro_torch.sim import runner
from repro_torch.sim.cluster import MAX_RETRIES, FaultCoordinator
from repro_torch.telemetry import TelemetryHub
from repro_torch.workloads import get_scenario

MIXED_FLEET = "xeon-28c:5+epyc-64c:rest"
#: `tests/test_faults.py::_SMALL` of the reference
SMALL = dict(duration_s=30.0, n_prompt=1, n_token=2, rate_rps=8.0, seed=3)
#: `tests/test_faults.py::TestGuardbandAcceptance` of the reference
ACCEPT = dict(seed=3, duration_s=60.0, fault_model="guardband",
              fault_opts={"margin": 0.012})
#: `tests/test_faults.py::TestFaultlessContract` (robustness keys)
ROBUST = dict(duration_s=20.0, n_prompt=1, n_token=2, rate_rps=8.0)
#: `tests/test_faults.py::TestSweepAxis`
SWEEP = dict(duration_s=10.0, n_prompt=1, n_token=1, rate_rps=4.0)

# (name, ExperimentConfig kwargs) on the event engine, each run on both
# sides
EVENT = {
    "small-crash": dict(SMALL, fault_model="machine-crash",
                        fault_opts={"mttf_s": 20.0, "reboot_s": 5.0}),
    "small-stall": dict(SMALL, fault_model="transient-stall",
                        fault_opts={"rate_per_s": 0.2}),
    "small-guardband": dict(SMALL, fault_model="guardband",
                            fault_opts={"margin": 0.010}),
    "small-crash-retries": dict(SMALL, fault_model="machine-crash",
                                fault_opts={"mttf_s": 15.0,
                                            "reboot_s": 5.0}),
    "acceptance-linux": dict(ACCEPT, policy="linux"),
    "acceptance-proposed": dict(ACCEPT, policy="proposed"),
    "mixed-guardband": dict(seed=3, duration_s=30.0, fleet=MIXED_FLEET,
                            fault_model="guardband",
                            fault_opts={"margin": 0.012}),
    "robust-stall": dict(ROBUST, fault_model="transient-stall"),
}

# event cases also run with a telemetry hub, and the kinds of the
# fault layer's four events (`FaultCoordinator`)
TELEMETRY_CASES = ("small-crash-retries", "small-guardband")
FAULT_KINDS = ["machine_crash", "machine_reboot", "fault_retry",
               "core_failure"]

#: `tests/test_faults.py::TestFleetEngineFaults` of the reference
FLEET = dict(policy="proposed", duration_s=60.0, seed=7)
FLEET_MODELS = {"guardband": {"margin": 0.012},
                "machine-crash": {"mttf_s": 120.0},
                "transient-stall": {"rate_per_s": 0.1}}
FLEET_CONFIGS = {
    **{name: dict(FLEET, fault_model=name, fault_opts=opts)
       for name, opts in FLEET_MODELS.items()},
    "mixed-guardband": dict(FLEET, fleet=MIXED_FLEET,
                            fault_model="guardband",
                            fault_opts={"margin": 0.012}),
}
# Torch (CPU) against jax under guardband: what the reference's numpy and
# jax backends show against each other on `FLEET_CONFIGS["guardband"]`,
# measured through this harness (numpy / jax: completed 1163 / 1164,
# mean_latency_s 28.252636 / 28.169298, p99_latency_s 48.039672 /
# 48.089651, fleet_yearly_kgco2eq 1174.49433 / 1173.24109, availability
# 0.57320076 / 0.57306818, core_failures 440 / 440), rounded up at the
# second significant digit; relative, core_failures exact.
GUARD_BOUNDS = {"completed": 8.6e-4, "mean_latency_s": 3.0e-3,
                "p99_latency_s": 1.1e-3, "fleet_yearly_kgco2eq": 1.1e-3,
                "availability": 2.4e-4, "core_failures": 0.0}
# TestBackendAgreement bounds (reference tests/test_fleetsim.py)
BACKEND_BOUNDS = {"completed": 0.01, "mean_latency_s": 0.01,
                  "p50_degradation": 0.02, "fleet_yearly_kgco2eq": 0.05}
# mid-run guardband state: the reference runs this many idling periods
# on numpy, then numpy, jax and the port's torch backend advance one more
# period from it (151 cores have failed after 8 periods, 209 after 9)
STATE_MACRO = 8

_CHILD = r'''
from repro.faults import FaultModel, register_fault_model
from repro.sim import ExperimentConfig, run_experiment, run_policy_sweep
from repro.sim.fleetsim import FleetEngine
from repro.workloads import get_scenario

def pack(res):
    return {"scalars": res.scalars(), "dict": res.to_dict()}

out = {"event": {}, "numpy": {}, "jax": {}}
for name, kw in job["event"].items():
    out["event"][name] = pack(run_experiment(ExperimentConfig(**kw)))
out["robust_off"] = run_experiment(
    ExperimentConfig(**job["robust"])).scalars()
sweep = run_policy_sweep(ExperimentConfig(**job["sweep"]),
                         policies=("linux", "proposed"),
                         fault_models=("none", "transient-stall"))
out["sweep"] = [[list(k), pack(v)] for k, v in sweep.items()]
for name, kw in job["fleet"].items():
    cfg = ExperimentConfig(**kw)
    out["numpy"][name] = pack(run_experiment(
        cfg.with_engine("fleet", backend="numpy")))
    if name in job["jax"]:
        out["jax"][name] = pack(run_experiment(
            cfg.with_engine("fleet", backend="jax")))

from repro.telemetry import TelemetryHub
out["telemetry"] = {}
for name in job["telemetry"]:
    hub = TelemetryHub()
    run_experiment(ExperimentConfig(**job["event"][name]), telemetry=hub)
    out["telemetry"][name] = {
        "counters": hub.summary()["counters"],
        "faults": [e for e in hub.events if e["kind"] in job["fault_kinds"]]}

@register_fault_model("test-meteor")
class MeteorFaults(FaultModel):
    pass
try:
    FleetEngine(ExperimentConfig(fault_model="test-meteor", engine="fleet"))
except ValueError as e:
    out["refusal"] = str(e)

k = job["state_macro"]
cfg = ExperimentConfig(**job["fleet"]["guardband"])
reqs = get_scenario(cfg.scenario).generate(
    rate_rps=cfg.rate_rps, duration_s=cfg.duration_s, seed=cfg.seed)

def engine(backend):
    eng = FleetEngine(cfg.with_engine("fleet", backend=backend))
    eng.shape.mean_out_tokens = float(np.mean([r.output_tokens
                                               for r in reqs]))
    eng._requests = reqs
    return eng, eng._bin_trace(reqs)

eng, arr = engine("numpy")
eng.shape.n_macro = k
eng._run_numpy(arr, 0)
np.savez(job["state_path"] + "_start.npz", **eng.state)
start = {key: np.array(v) for key, v in eng.state.items()}
eng.shape.n_macro = k + 1
eng._run_numpy(arr, k)
np.savez(job["state_path"] + "_numpy.npz", **eng.state)
jx, arr = engine("jax")
jx.state = start
jx.shape.n_macro = k + 1
jx._run_jax(arr[:(k + 1) * jx.shape.steps_per_period], k)
np.savez(job["state_path"] + "_jax.npz", **jx.state)
json.dump(out, sys.stdout)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One child interpreter runs every reference case of this module."""
    state_path = str(tmp_path_factory.mktemp("ref") / "state")
    job = {"event": EVENT, "robust": ROBUST, "sweep": SWEEP,
           "fleet": FLEET_CONFIGS, "jax": list(FLEET_MODELS),
           "state_macro": STATE_MACRO, "state_path": state_path,
           "telemetry": list(TELEMETRY_CASES), "fault_kinds": FAULT_KINDS}
    out = run_reference(_CHILD, job)
    out["states"] = {tag: dict(np.load(f"{state_path}_{tag}.npz"))
                     for tag in ("start", "numpy", "jax")}
    return out


def _canonical(d: dict) -> str:
    """JSON with the package version dropped: string equality is then
    bit equality of every float (repr round-trips), NaN included."""
    d = json.loads(json.dumps(d))
    d.get("provenance", {}).pop("package_version", None)
    return json.dumps(d, sort_keys=True)


def _same(res, ref: dict) -> None:
    assert _canonical(res.scalars()) == _canonical(ref["scalars"])
    assert res.scalars()["config_hash"] == ref["scalars"]["config_hash"]
    assert _canonical(res.to_dict()) == _canonical(ref["dict"])


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _conserved(r) -> bool:
    return (r.completed + r.failed_requests + r.rejected_requests
            + r.pending_requests) == r.submitted


def _fleet_cfg(kw: dict, **engine_opts) -> ExperimentConfig:
    return ExperimentConfig(**kw).with_engine("fleet", **engine_opts)


# ---------------------------------------------------------------------- #
# the registry axis and the four models, in-process against the reference
# ---------------------------------------------------------------------- #
class _View:
    """What a `FaultView` gives a model, built from plain arrays, so one
    view drives the port's model and the reference's alike."""

    def __init__(self, seed, num_cores=16, period_s=1.0):
        self.rng = np.random.default_rng([seed, 0xFA, 0])
        self.num_cores = num_cores
        self.period_s = period_s
        self.now = 0.0
        self.up = True
        self.failed_mask = np.zeros(num_cores, dtype=bool)
        self._deg = np.zeros(num_cores)

    def degradation(self):
        return self._deg


class TestRegistryParity:
    def test_builtins(self):
        assert faults.available_fault_models() == \
            ref_faults.available_fault_models()
        assert set(faults.available_fault_models()) >= {
            "none", "guardband", "machine-crash", "transient-stall"}

    @pytest.mark.parametrize("name", ["Machine_Crash", "GUARDBAND",
                                      " transient_stall ", "none"])
    def test_canonical_names(self, name):
        assert faults.canonical_fault_model_name(name) == \
            ref_faults.canonical_fault_model_name(name)
        assert faults.get_fault_model(name).name == \
            ref_faults.get_fault_model(name).name

    @pytest.mark.parametrize("name,opts", [
        ("guardband", {}), ("guardband", {"margin": 0.05,
                                          "hazard_per_s": 0.5,
                                          "max_failed_frac": 0.25}),
        ("machine-crash", {}), ("machine-crash", {"mttf_s": 20.0,
                                                  "reboot_s": 5.0}),
        ("transient-stall", {}), ("transient-stall", {"rate_per_s": 0.2,
                                                      "slowdown": 0.3,
                                                      "stall_s": 2.0}),
    ])
    def test_options_reach_model(self, name, opts):
        port = faults.get_fault_model(name, **opts)
        ref = ref_faults.get_fault_model(name, **opts)
        assert vars(port) == vars(ref)
        assert repr(port) == repr(ref)

    def test_unknown_name_wording(self):
        with pytest.raises(KeyError) as port:
            faults.get_fault_model("cosmic-rays")
        with pytest.raises(KeyError) as ref:
            ref_faults.get_fault_model("cosmic-rays")
        assert "unknown fault model" in str(port.value)
        assert str(port.value) == str(ref.value)

    @pytest.mark.parametrize("name,opts", [
        ("guardband", {"margin": 0.0}), ("guardband", {"hazard_per_s": -1}),
        ("guardband", {"max_failed_frac": 1.5}),
        ("machine-crash", {"mttf_s": 0.0}),
        ("machine-crash", {"reboot_s": -2.0}),
        ("transient-stall", {"rate_per_s": 0.0}),
        ("transient-stall", {"slowdown": 1.0}),
        ("transient-stall", {"stall_s": 0.0}),
    ])
    def test_invalid_option_wording(self, name, opts):
        with pytest.raises(ValueError) as port:
            faults.get_fault_model(name, **opts)
        with pytest.raises(ValueError) as ref:
            ref_faults.get_fault_model(name, **opts)
        assert str(port.value) == str(ref.value)

    def test_registration_wordings(self):
        class Other(faults.FaultModel):
            pass

        class RefOther(ref_faults.FaultModel):
            pass
        with pytest.raises(ValueError) as port:
            faults.register_fault_model("guardband")(Other)
        with pytest.raises(ValueError) as ref:
            ref_faults.register_fault_model("guardband")(RefOther)
        assert str(port.value) == str(ref.value)
        with pytest.raises(TypeError) as port:
            faults.register_fault_model("plain")(object)
        with pytest.raises(TypeError) as ref:
            ref_faults.register_fault_model("plain")(object)
        assert str(port.value) == str(ref.value)

    def test_fresh_instance_per_get(self):
        assert faults.get_fault_model("machine-crash") is not \
            faults.get_fault_model("machine-crash")

    def test_none_decides_nothing(self):
        assert faults.get_fault_model("none").periodic(None) is None

    def test_decision_truthiness(self):
        assert not faults.FaultDecision()
        assert faults.FaultDecision(fail_cores=(3,))
        assert faults.FaultDecision(crash=True)
        assert faults.FaultDecision(stall_cores=(1,))

    @pytest.mark.parametrize("name,opts", [
        ("guardband", {"margin": 0.012}),
        ("machine-crash", {"mttf_s": 5.0, "reboot_s": 2.0}),
        ("transient-stall", {"rate_per_s": 0.3}),
    ])
    def test_models_decide_alike(self, name, opts):
        """One drifting view drives both models for 200 periods: the same
        draws and the same decisions, period by period."""
        port_m = faults.get_fault_model(name, **opts)
        ref_m = ref_faults.get_fault_model(name, **opts)
        views = (_View(11), _View(11))
        seen = 0
        for k in range(200):
            for v in views:
                v.now = float(k)
                v.up = k % 37 < 33
                v._deg = np.linspace(0.0, 0.03, v.num_cores) * k / 100.0
            got = port_m.periodic(views[0])
            want = ref_m.periodic(views[1])
            assert (got is None) == (want is None)
            if got is not None:
                seen += 1
                assert vars(got) == vars(want)
                for v in views:
                    v.failed_mask[list(got.fail_cores)] = True
        assert seen > 0


# ---------------------------------------------------------------------- #
# faultless contract: "none" is free and invisible
# ---------------------------------------------------------------------- #
class TestFaultlessContract:
    def test_fingerprint_unchanged_by_default_axis(self):
        assert ExperimentConfig().fingerprint() == \
            ExperimentConfig(fault_model="none").fingerprint()

    def test_fault_fingerprint_differs(self):
        base = ExperimentConfig()
        assert base.with_fault_model("guardband").fingerprint() != \
            base.fingerprint()
        assert base.with_fault_model(
            "guardband", margin=0.02).fingerprint() != \
            base.with_fault_model("guardband").fingerprint()

    def test_no_fault_machinery_when_off(self):
        cluster = Cluster(ExperimentConfig(duration_s=1.0))
        assert cluster.faults is None
        assert not any(m._track_all for m in cluster.machines)
        eng = FleetEngine(_fleet_cfg({"duration_s": 1.0}, backend="numpy"))
        assert eng._faults is None
        assert not {"failed", "cum_haz", "lost_core_s", "retried"} \
            & set(eng.state)

    def test_fault_machinery_when_on(self):
        cfg = ExperimentConfig(duration_s=1.0, fault_model="guardband")
        cluster = Cluster(cfg)
        assert isinstance(cluster.faults, FaultCoordinator)
        assert len(cluster.faults.models) == cfg.n_machines
        assert all(m._track_all for m in cluster.machines)

    def test_robustness_scalars_only_when_on(self, reference):
        off = run_experiment(ExperimentConfig(**ROBUST)).scalars()
        assert _canonical(off) == _canonical(reference["robust_off"])
        on = run_experiment(ExperimentConfig(
            **EVENT["robust-stall"])).scalars()
        assert "availability" not in off
        assert "core_failures" not in off
        assert on["availability"] <= 1.0
        assert set(off) < set(on)

    @pytest.mark.parametrize("engine", ["event", "fleet"])
    def test_unknown_fault_model_fails_before_the_run(self, monkeypatch,
                                                      engine):
        """The reference's KeyError, raised before a trace is generated
        or an engine is built."""
        def never(*args, **kw):
            raise AssertionError("the simulation started")
        monkeypatch.setattr(runner, "Cluster", never)
        monkeypatch.setattr(runner, "run_fleet_experiment", never)
        with pytest.raises(KeyError) as ref:
            ref_faults.get_fault_model("solar-flare")
        with pytest.raises(KeyError) as port:
            run_experiment(ExperimentConfig(fault_model="solar-flare",
                                            engine=engine))
        assert str(port.value) == str(ref.value)


class TestFleetViewHealth:
    def test_health_fields(self):
        cluster = Cluster(ExperimentConfig(duration_s=1.0))
        view = cluster.fleet
        assert view.prompt_up().all()
        assert view.token_up().all()
        assert view.machine_up().all()
        assert (view.offline_cores() == 0).all()
        cluster.machines[0].manager.fail_core(3, 0.5)
        assert view.offline_cores()[0] == 1
        assert (view.offline_cores()[1:] == 0).all()

    def test_crashed_machine_is_down(self):
        cluster = Cluster(ExperimentConfig(duration_s=1.0))
        cluster.machines[0].crash(0.5)
        assert not cluster.fleet.prompt_up()[0]
        assert not cluster.fleet.machine_up()[0]
        cluster.machines[0].reboot(1.0)
        assert cluster.fleet.machine_up().all()


# ---------------------------------------------------------------------- #
# the event engine against the live reference
# ---------------------------------------------------------------------- #
class TestEventEngine:
    @pytest.mark.parametrize("name", sorted(EVENT))
    def test_result_equals_reference(self, reference, name):
        res = run_experiment(ExperimentConfig(**EVENT[name]))
        _same(res, reference["event"][name])
        assert _conserved(res)
        assert res.retries <= MAX_RETRIES * res.submitted

    def test_each_model_acts(self, reference):
        """The reference's `TestEventEngineFaults` smokes, on the
        reference's own numbers (which the port equals above)."""
        r = {k: v["scalars"] for k, v in reference["event"].items()}
        crash = r["small-crash"]
        assert crash["machine_crashes"] > 0 and crash["retries"] > 0
        assert crash["availability"] < 1.0
        assert crash["p99_degraded_window_s"] > 0.0
        stall = r["small-stall"]
        assert stall["stalls"] > 0 and stall["availability"] == 1.0
        assert stall["core_failures"] == stall["machine_crashes"] == 0
        guard = r["small-guardband"]
        assert guard["core_failures"] > 0 and guard["availability"] < 1.0
        assert r["mixed-guardband"]["core_failures"] > 0

    def test_guardband_acceptance(self, reference):
        """`TestGuardbandAcceptance`: proposed fails fewer cores and keeps
        higher availability than linux (ROADMAP A4 records 304 against
        536 cores, 0.80 against 0.43)."""
        linux = reference["event"]["acceptance-linux"]["scalars"]
        proposed = reference["event"]["acceptance-proposed"]["scalars"]
        assert proposed["core_failures"] < linux["core_failures"]
        assert proposed["availability"] > linux["availability"]
        assert (linux["core_failures"], proposed["core_failures"]) == \
            (536, 304)

    def test_mixed_fleet_availability_counts_its_cores(self):
        cfg = ExperimentConfig(**EVENT["mixed-guardband"])
        cluster = Cluster(cfg)
        total = cluster.inventory.total_cores
        assert total != cfg.n_machines * cfg.num_cores
        trace = get_scenario(cfg.scenario).generate(
            rate_rps=cfg.rate_rps, duration_s=cfg.duration_s, seed=cfg.seed)
        cluster.run(trace, cfg.duration_s,
                    sample_period_s=cfg.sample_period_s)
        rob = cluster.faults.robustness(cfg.duration_s)
        want = 1.0 - min(cluster.faults.lost_core_s
                         / (total * cfg.duration_s), 1.0)
        assert rob["availability"] == want

    def test_determinism(self):
        cfg = ExperimentConfig(**EVENT["small-crash"])
        assert run_experiment(cfg).scalars() == run_experiment(cfg).scalars()

    def test_sweep_axis(self, reference):
        sweep = run_policy_sweep(ExperimentConfig(**SWEEP),
                                 policies=("linux", "proposed"),
                                 fault_models=("none", "transient_stall"))
        assert sweep.axes == ("policy", "fault_model")
        keys = [tuple(k) for k, _ in reference["sweep"]]
        assert list(sweep) == keys
        for key, ref in reference["sweep"]:
            _same(sweep[tuple(key)], ref)
        assert sweep[("linux", "none")].fault_model == "none"
        assert sweep[("linux", "transient-stall")].stalls >= 0

    @pytest.mark.parametrize("policy", ["linux", "proposed"])
    def test_torch_settler_under_guardband(self, monkeypatch, reference,
                                           policy):
        """The acceptance pair with the torch settler (CPU): one aging
        settle a period through the kernel's wrapper, the failure, retry
        and request counts equal to the numpy settler's, the rest within
        `TestBackendAgreement`'s bounds."""
        calls = []
        real = aging_ops.advance_fleet

        def counting(*args):
            calls.append(args[0].numel())
            return real(*args)

        monkeypatch.setattr("repro_torch.sim.fleetstate.advance_fleet",
                            counting)
        cfg = ExperimentConfig(**dict(ACCEPT, policy=policy))
        cluster = Cluster(cfg)
        cluster.fleet_settler = FleetAgingSettler(
            [m.manager for m in cluster.machines], backend="torch",
            device="cpu")
        trace = get_scenario(cfg.scenario).generate(
            rate_rps=cfg.rate_rps, duration_s=cfg.duration_s, seed=cfg.seed)
        cluster.run(trace, cfg.duration_s,
                    sample_period_s=cfg.sample_period_s)
        res = collect(cluster, cfg)
        assert calls == [cfg.n_machines * cfg.num_cores] * 60
        want = reference["event"][f"acceptance-{policy}"]["scalars"]
        for key in ("core_failures", "retries", "submitted", "completed",
                    "pending_requests", "failed_requests",
                    "rejected_requests", "availability"):
            assert res.scalars()[key] == want[key], key
        assert _conserved(res)
        assert _rel(res.mean_latency_s, want["mean_latency_s"]) < \
            BACKEND_BOUNDS["mean_latency_s"]
        assert _rel(res.mean_degradation_percentiles[50],
                    want["mean_degradation_p50"]) < \
            BACKEND_BOUNDS["p50_degradation"]
        assert _rel(res.fleet_yearly_kgco2eq,
                    want["fleet_yearly_kgco2eq"]) < \
            BACKEND_BOUNDS["fleet_yearly_kgco2eq"]


# ---------------------------------------------------------------------- #
# the fleet engine
# ---------------------------------------------------------------------- #
class TestFleetNumpyExact:
    @pytest.mark.parametrize("name", sorted(FLEET_CONFIGS))
    def test_result_equals_reference(self, reference, name):
        res = run_experiment(_fleet_cfg(FLEET_CONFIGS[name],
                                        backend="numpy"))
        _same(res, reference["numpy"][name])
        assert _conserved(res)

    def test_each_model_acts(self, reference):
        r = {k: v["scalars"] for k, v in reference["numpy"].items()}
        assert r["guardband"]["core_failures"] > 0
        assert r["guardband"]["availability"] < 1.0
        assert r["machine-crash"]["machine_crashes"] > 0
        assert r["machine-crash"]["retries"] > 0
        assert r["machine-crash"]["availability"] < 1.0
        assert r["transient-stall"]["stalls"] > 0
        assert r["transient-stall"]["availability"] == 1.0
        assert r["mixed-guardband"]["core_failures"] > 0


def _torch_cpu(name):
    return run_experiment(_fleet_cfg(FLEET_CONFIGS[name], backend="torch",
                                     device="cpu"))


class TestFleetTorchAgreement:
    @pytest.mark.parametrize("name", ["machine-crash", "transient-stall"])
    def test_counts_agree_with_jax(self, reference, name):
        res = _torch_cpu(name)
        ref = reference["jax"][name]["scalars"]
        assert res.machine_crashes == ref["machine_crashes"]
        assert res.stalls == ref["stalls"]
        assert abs(res.retries - ref["retries"]) <= 1
        assert _rel(res.availability, ref["availability"]) < 1e-3
        assert _conserved(res)

    def test_guardband_agrees_with_jax(self, reference):
        res = _torch_cpu("guardband").scalars()
        ref = reference["jax"]["guardband"]["scalars"]
        for key, bound in GUARD_BOUNDS.items():
            assert _rel(res[key], ref[key]) <= bound, key

    def test_guard_bounds_are_the_references_own(self, reference):
        """`GUARD_BOUNDS` covers what the reference's numpy and jax
        backends show against each other, and no more than 10% beyond."""
        a = reference["numpy"]["guardband"]["scalars"]
        b = reference["jax"]["guardband"]["scalars"]
        for key, bound in GUARD_BOUNDS.items():
            delta = _rel(b[key], a[key])
            assert delta <= bound <= max(1.1 * delta, 0.0), key

    @pytest.mark.parametrize("name", sorted(FLEET_MODELS))
    def test_agrees_with_numpy(self, name):
        res = _torch_cpu(name)
        ref = run_experiment(_fleet_cfg(FLEET_CONFIGS[name],
                                        backend="numpy"))
        assert _rel(res.completed, ref.completed) < \
            BACKEND_BOUNDS["completed"]
        assert _rel(res.mean_latency_s, ref.mean_latency_s) < \
            BACKEND_BOUNDS["mean_latency_s"]
        assert _rel(res.mean_degradation_percentiles[50],
                    ref.mean_degradation_percentiles[50]) < \
            BACKEND_BOUNDS["p50_degradation"]
        assert _rel(res.fleet_yearly_kgco2eq, ref.fleet_yearly_kgco2eq) < \
            BACKEND_BOUNDS["fleet_yearly_kgco2eq"]
        assert (res.core_failures, res.machine_crashes, res.stalls) == \
            (ref.core_failures, ref.machine_crashes, ref.stalls)
        assert abs(res.retries - ref.retries) <= 1
        assert _rel(res.availability, ref.availability) < 1e-3

    @pytest.mark.parametrize("name", sorted(FLEET_MODELS))
    def test_run_goes_through_the_aging_wrapper(self, monkeypatch, name):
        """Two settles a period, each one `advance_fleet` call, whatever
        the fault model."""
        calls = []
        real = aging_ops.advance_fleet

        def counting(*args):
            calls.append(args[0].numel())
            return real(*args)

        monkeypatch.setattr("repro_torch.sim.fleetsim.advance_fleet",
                            counting)
        cfg = _fleet_cfg(FLEET_CONFIGS[name], backend="torch", device="cpu")
        run_experiment(cfg)
        assert calls == [cfg.n_machines * cfg.num_cores] * 120

    def test_custom_model_refused(self, reference):
        @faults.register_fault_model("test-meteor")
        class MeteorFaults(faults.FaultModel):
            pass
        try:
            for opts in ({"backend": "numpy"},
                         {"backend": "torch", "device": "cpu"}):
                cfg = _fleet_cfg({"fault_model": "test-meteor"}, **opts)
                with pytest.raises(ValueError,
                                   match="cannot vectorize") as port:
                    FleetEngine(cfg)
                assert str(port.value) == reference["refusal"]
        finally:
            _REGISTRY.pop("test-meteor", None)


class TestStateTransfer:
    def test_roundtrip_with_fault_columns(self, reference):
        start = reference["states"]["start"]
        assert start["failed"].any()
        back = state_to_numpy(state_from_numpy(start, "cpu"))
        assert back.keys() == start.keys()
        for key, v in start.items():
            assert back[key].dtype == v.dtype, key
            want = v.astype(np.float32) if v.dtype == np.float64 else v
            np.testing.assert_array_equal(back[key], want, err_msg=key)

    def _engine(self, backend, **opts):
        cfg = ExperimentConfig(**FLEET_CONFIGS["guardband"])
        eng = FleetEngine(cfg.with_engine("fleet", backend=backend, **opts))
        reqs = get_scenario(cfg.scenario).generate(
            rate_rps=cfg.rate_rps, duration_s=cfg.duration_s, seed=cfg.seed)
        eng.shape.mean_out_tokens = float(np.mean([r.output_tokens
                                                   for r in reqs]))
        eng._requests = reqs
        return eng, eng._bin_trace(reqs)

    def test_one_period_numpy_exact(self, reference):
        eng, arr = self._engine("numpy")
        eng.state = {k: np.array(v)
                     for k, v in reference["states"]["start"].items()}
        eng.shape.n_macro = STATE_MACRO + 1
        eng._run_numpy(arr, STATE_MACRO)
        for key, want in reference["states"]["numpy"].items():
            np.testing.assert_array_equal(eng.state[key], want,
                                          err_msg=key)

    def test_failed_cores_reach_the_kernel_unstressed(self, monkeypatch,
                                                      reference):
        """Under guardband the torch backend settles with `gated | failed`
        as its zero-stress mask, as the jax backend does."""
        stresses = []
        real = aging_ops.advance_fleet

        def recording(dvth, temp, stress, tau, params):
            stresses.append(stress.clone())
            return real(dvth, temp, stress, tau, params)

        monkeypatch.setattr("repro_torch.sim.fleetsim.advance_fleet",
                            recording)
        start = reference["states"]["start"]
        eng, arr = self._engine("torch", device="cpu")
        eng.state = start
        eng.shape.n_macro = STATE_MACRO + 1
        eng._run_torch(arr, STATE_MACRO)
        want = np.where(start["gated"] | start["failed"], 0.0, 1.0).ravel()
        assert start["failed"].any() and not start["gated"].all()
        assert len(stresses) == 2
        for stress in stresses:
            np.testing.assert_array_equal(stress.numpy(), want)

    def test_one_period_torch_matches_jax(self, reference):
        """From the reference's numpy state after 8 guardband periods, one
        more period on torch (CPU) and on jax, in which 58 cores cross
        their thresholds: the same failed cores and gating, the hazard
        and the rest at the bounds of
        `tests/test_torch_fleetsim.py::TestStateTransfer`."""
        eng, arr = self._engine("torch", device="cpu")
        eng.state = reference["states"]["start"]
        eng.shape.n_macro = STATE_MACRO + 1
        eng._run_torch(arr, STATE_MACRO)
        jx = reference["states"]["jax"]
        assert jx["failed"].sum() > reference["states"]["start"]["failed"].sum()
        for key in ("failed", "gated", "idle_hist"):
            np.testing.assert_array_equal(eng.state[key], jx[key],
                                          err_msg=key)
        # `d_pend_tok - adm * tok_per_pend` leaves a float32 cancellation
        # residue (ROADMAP R5) where jax and torch round alike or not: it
        # is held at two float32 ulps of one admitted request's tokens
        # (the trace's mean output tokens, 212.4: 3.05e-5).
        residue = 2 * float(np.spacing(np.float32(eng.shape.mean_out_tokens)))
        for key, want in jx.items():
            if want.dtype == np.float64:
                atol = residue if key == "d_pend_tok" else 1e-6
                np.testing.assert_allclose(eng.state[key], want, rtol=1e-6,
                                           atol=atol, err_msg=key)


@pytest.mark.parametrize("name", TELEMETRY_CASES)
def test_fault_events_reach_the_hub(reference, name):
    """The coordinator's four pushes fire into a hub: its fault events
    and every counter equal the reference's, and the result equals the
    run without a hub."""
    hub = TelemetryHub()
    res = run_experiment(ExperimentConfig(**EVENT[name]), telemetry=hub)
    ref = reference["telemetry"][name]
    assert hub.summary()["counters"] == ref["counters"]
    faults = [e for e in hub.events if e["kind"] in FAULT_KINDS]
    assert json.loads(json.dumps(faults)) == ref["faults"]
    assert faults
    assert res.telemetry_summary["counters"] == ref["counters"]
    _same(dataclasses.replace(res, telemetry_summary=None),
          reference["event"][name])
