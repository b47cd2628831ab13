"""Fleet engine of the port (`repro_torch.sim.fleetsim`) against the
reference (`repro.sim.fleetsim`), on the CPU.

The reference simulator does not import on Python 3.12 (ROADMAP R1:
`IdleCorrection` has ndarray dataclass defaults), so it runs in one
child interpreter per module, under a shim that the child installs only
in itself before it imports `repro`. The child returns
`ExperimentResult.to_dict()` as JSON and fleet states as `.npz`. Nothing
of `repro.core` or `repro.sim` is imported into the pytest process.

- The port's numpy backend equals the reference's numpy backend
  exactly: every `to_dict()` field, `config_hash` included; only
  `provenance.package_version` may differ.
- The port's torch backend on the CPU agrees with the reference's jax
  backend (both float32). The bounds are the reference's own
  `tests/test_fleetsim.py::TestBackendAgreement` ones (1% on `completed`
  and `mean_latency_s`, 2% on p50 degradation, 5% on
  `fleet_yearly_kgco2eq`), tightened to equal `completed` and 1e-6
  relative on the rest: the largest deltas observed over the four
  configs were 6.7e-8 on `mean_latency_s`, 0 on p50 degradation and
  3.5e-8 on `fleet_yearly_kgco2eq`.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels.aging_update import ops as aging_ops
from repro_torch.sim import (ExperimentConfig, FleetEngine, run_experiment,
                             run_policy_sweep, state_from_numpy,
                             state_to_numpy)
from repro_torch.workloads import get_scenario

REPO = Path(__file__).resolve().parents[1]

# (name, ExperimentConfig kwargs) — 22 machines x 60 s at 60 rps
CONFIGS = {
    "proposed": {"duration_s": 60.0},
    "linux": {"duration_s": 60.0, "policy": "linux"},
    "proposed-carbon-aware": {"duration_s": 60.0, "policy": "proposed",
                              "policy_opts": {"carbon_aware": True}},
    # a grid dirty in every period, so the carbon gate reshapes gating
    "proposed-carbon-dirty": {"duration_s": 60.0, "policy": "proposed",
                              "policy_opts": {"carbon_aware": True,
                                              "dirty_frac": 0.5}},
}
# the copied hardware registry on the numpy backend (mixed SKUs)
MIXED = {"duration_s": 60.0, "fleet": "xeon-28c:5+epyc-64c:rest"}
# relative bound, torch (CPU) vs jax: see the module docstring
AGREE_RTOL = 1e-6
# mid-run state: the reference runs this many idling periods on numpy,
# then both engines advance one more period from that state
STATE_MACRO = 20

_CHILD = r'''
import dataclasses, json, sys
import numpy as np

# R1 shim: turn ndarray dataclass defaults into default factories.
_orig = dataclasses._get_field
def _get_field(cls, a_name, a_type, default_kw_only):
    default = cls.__dict__.get(a_name, dataclasses.MISSING)
    if isinstance(default, np.ndarray):
        setattr(cls, a_name, dataclasses.field(default_factory=default.copy))
    return _orig(cls, a_name, a_type, default_kw_only)
dataclasses._get_field = _get_field

from repro.sim import ExperimentConfig, run_experiment
from repro.sim.fleetsim import FleetEngine
from repro.workloads import get_scenario

job = json.load(sys.stdin)
out = {"results": []}
for cfg_kw, eng_kw in job["runs"]:
    cfg = ExperimentConfig(**cfg_kw).with_engine("fleet", **eng_kw)
    out["results"].append(run_experiment(cfg).to_dict())

k = job["state_macro"]
cfg = ExperimentConfig(duration_s=60.0)
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
    runs = ([(kw, {"backend": "numpy"}) for kw in CONFIGS.values()]
            + [(kw, {"backend": "jax"}) for kw in CONFIGS.values()]
            + [(MIXED, {"backend": "numpy"})])
    job = {"runs": runs, "state_macro": STATE_MACRO,
           "state_path": state_path}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _CHILD],
                          input=json.dumps(job), capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    results = json.loads(proc.stdout)["results"]
    n = len(CONFIGS)
    names = list(CONFIGS)
    states = {tag: dict(np.load(f"{state_path}_{tag}.npz"))
              for tag in ("start", "numpy", "jax")}
    return {"numpy": dict(zip(names, results[:n])),
            "jax": dict(zip(names, results[n:2 * n])),
            "mixed": results[2 * n], "states": states}


def _canonical(d: dict) -> str:
    """JSON with the package version dropped: string equality is then
    bit equality of every float (repr round-trips), NaN included."""
    d = json.loads(json.dumps(d))
    d["provenance"].pop("package_version")
    return json.dumps(d, sort_keys=True)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _cfg(kw: dict, **engine_opts) -> ExperimentConfig:
    return ExperimentConfig(**kw).with_engine("fleet", **engine_opts)


class TestNumpyBackendExact:
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_result_equals_reference(self, reference, name):
        port = run_experiment(_cfg(CONFIGS[name], backend="numpy"))
        assert _canonical(port.to_dict()) == \
            _canonical(reference["numpy"][name])

    def test_mixed_fleet_equals_reference(self, reference):
        port = run_experiment(_cfg(MIXED, backend="numpy"))
        assert _canonical(port.to_dict()) == _canonical(reference["mixed"])


class TestTorchBackendAgreement:
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_agrees_with_jax(self, reference, name):
        res = run_experiment(_cfg(CONFIGS[name], backend="torch",
                                  device="cpu"))
        ref = reference["jax"][name]
        assert res.completed == ref["completed"]
        assert _rel(res.mean_latency_s, ref["mean_latency_s"]) < AGREE_RTOL
        assert _rel(res.mean_degradation_percentiles[50],
                    ref["mean_degradation_percentiles"]["50"]) < AGREE_RTOL
        assert _rel(res.fleet_yearly_kgco2eq,
                    ref["fleet_yearly_kgco2eq"]) < AGREE_RTOL

    def test_torch_run_goes_through_the_aging_wrapper(self, monkeypatch):
        """Two settles per idling period, each one `advance_fleet` call."""
        calls = []
        real = aging_ops.advance_fleet

        def counting(*args):
            calls.append(args[0].numel())
            return real(*args)

        monkeypatch.setattr("repro_torch.sim.fleetsim.advance_fleet",
                            counting)
        cfg = ExperimentConfig(duration_s=10.0)
        run_experiment(cfg.with_engine("fleet", backend="torch",
                                       device="cpu"))
        assert calls == [cfg.n_machines * cfg.num_cores] * 20


class TestStateTransfer:
    def test_roundtrip(self, reference):
        start = reference["states"]["start"]
        back = state_to_numpy(state_from_numpy(start, "cpu"))
        assert back.keys() == start.keys()
        for key, v in start.items():
            assert back[key].dtype == v.dtype, key
            want = v.astype(np.float32) if v.dtype == np.float64 else v
            np.testing.assert_array_equal(back[key], want, err_msg=key)

    def _engine(self, backend, **opts):
        cfg = ExperimentConfig(duration_s=60.0)
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

    def test_one_period_torch_matches_jax(self, reference):
        """Both engines start from the reference's numpy state after 20
        periods (rounded to float32 alike) and advance one period."""
        eng, arr = self._engine("torch", device="cpu")
        eng.state = reference["states"]["start"]
        eng.shape.n_macro = STATE_MACRO + 1
        eng._run_torch(arr, STATE_MACRO)
        jx = reference["states"]["jax"]
        assert int(eng.state["macro"]) == int(jx["macro"]) == STATE_MACRO + 1
        np.testing.assert_array_equal(eng.state["gated"], jx["gated"])
        np.testing.assert_array_equal(eng.state["idle_hist"],
                                      jx["idle_hist"])
        np.testing.assert_allclose(eng.state["dvth"], jx["dvth"],
                                   rtol=1e-6, atol=0.0)
        # The absolute slack covers cancellation residues near zero:
        # `d_pend_tok - adm * tok_per_pend` leaves -6.3e-7 tokens on jax
        # and 0 on torch. Largest relative delta elsewhere: 1.9e-7.
        for key, want in jx.items():
            if want.dtype == np.float64:
                np.testing.assert_allclose(eng.state[key], want, rtol=1e-6,
                                           atol=1e-6, err_msg=key)


class TestOutOfSlice:
    """What the port does not run yet raises, and never falls back."""

    @pytest.mark.parametrize("cfg,item", [
        (ExperimentConfig(duration_s=1.0), "A3/A5"),
        (ExperimentConfig(duration_s=1.0).with_engine(
            "fleet", backend="numpy").with_fault_model("machine-crash"),
         "A4"),
        (ExperimentConfig(duration_s=1.0).with_engine(
            "fleet", backend="numpy", checkpoint_dir="ckpt"), "A6"),
        (ExperimentConfig(duration_s=1.0).with_engine(
            "fleet", backend="numpy").with_telemetry(), "A5"),
        (ExperimentConfig(duration_s=1.0, fleet="xeon-28c:5+epyc-64c:rest")
         .with_engine("fleet", backend="torch", device="cpu"), "A6"),
    ], ids=["event-engine", "faults", "checkpoint", "telemetry",
            "mixed-fleet-torch"])
    def test_raises_not_implemented(self, cfg, item):
        with pytest.raises(NotImplementedError, match=item):
            run_experiment(cfg)

    def test_jax_backend_is_unknown(self):
        with pytest.raises(ValueError, match="'numpy', 'torch' or 'auto'"):
            run_experiment(_cfg({"duration_s": 1.0}, backend="jax"))

    def test_auto_resolves_to_torch(self):
        eng = FleetEngine(_cfg({"duration_s": 1.0}, device="cpu"))
        assert eng.backend == "torch"


def test_policy_sweep_matches_single_runs():
    cfg = _cfg({"duration_s": 10.0}, backend="torch", device="cpu")
    sweep = run_policy_sweep(cfg, policies=("linux", "proposed"))
    assert list(sweep) == ["linux", "proposed"]
    for policy in ("linux", "proposed"):
        single = run_experiment(cfg.with_policy(policy))
        assert sweep[policy].scalars() == single.scalars()
