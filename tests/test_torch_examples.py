"""The port's user-facing examples (`examples_torch/`) against the
reference's (`examples/`), on the CPU.

The reference's scripts run in a child interpreter (`torch_harness`, the
R1 shim: `repro.core` does not import here); the port's each run in a
subprocess, as a user runs them, on the CPU (`--device cpu` where the
script touches a device). Horizons are cut so that the file stays short:
`--duration 20` for the carbon report, one hour for the quickstart and
20 simulated seconds for the two cluster sweeps of `serve_cluster`
(`HOURS` and `ExperimentConfig` set on the imported module, in both
processes alike). The defaults are held on the card by `chip_smoke.py`
against `tests/data/examples_expected.json`
(`tests/test_torch_examples_data.py`).

- The report lines of `quickstart`, `carbon_report` and the two sweeps
  equal the reference's letter for letter; a `--save` file loads in
  `repro_torch.sim.SweepResult.load`.
- Each package's `telemetry_report` prints the same report from the
  other's export.
- `serve_cluster`'s serving demo, given the reference's parameters
  (float32, `params_from_jax`) and a fake clock in both engines, emits the
  reference's tokens and host-CPU line.
- `train_small --steps 50` writes the checkpoint of step 50 (the
  trainer's default interval) that the reference's `repro.launch.train`
  restores and trains on from.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
from test_torch_examples_data import report_lines
from torch_harness import run_reference

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model, params_from_jax
from repro_torch.sim import SweepResult

REPO = Path(__file__).resolve().parents[1]
HOURS = 1
DURATION = "20"
SWEEP_S = 20.0

#: run a script's functions after setting the cut horizons on its module:
#: argv, then the functions to call (none: the script as `__main__`)
_MODULE = r'''
import importlib.util, sys


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cut(mod, hours, sweep_s):
    if hasattr(mod, "HOURS"):
        mod.HOURS = hours
    if hasattr(mod, "ExperimentConfig"):
        real = mod.ExperimentConfig
        mod.ExperimentConfig = lambda **kw: real(**dict(kw,
                                                        duration_s=sweep_s))
'''

_PORT = _MODULE + r'''
path, name, hours, sweep_s, *calls = sys.argv[1:]
mod = load(path, name)
cut(mod, int(hours), float(sweep_s))
for fn in calls:
    getattr(mod, fn)()
'''

_REF = _MODULE + r'''
import contextlib, io, runpy


def run(path, argv):
    sys.argv = [path, *argv]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(path, run_name="__main__")
    return buf.getvalue()


def call(path, name, fns):
    mod = load(path, name)
    cut(mod, job["hours"], job["sweep_s"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        for fn in fns:
            getattr(mod, fn)()
    return buf.getvalue()


out = {"quickstart": call("examples/quickstart.py", "quickstart", ["main"]),
       "sweeps": call("examples/serve_cluster.py", "serve_cluster",
                      ["cluster_demo", "routing_demo"]),
       "carbon_report": run("examples/carbon_report.py",
                            ["--duration", job["duration"], "--telemetry",
                             job["tel"]])}
import glob, os
exports = dict(job["exports"],
               ref=glob.glob(os.path.join(job["tel"], "proposed-*"))[0])
out["reports"] = {name: run("examples/telemetry_report.py", [path])
                  for name, path in exports.items()}
json.dump(out, sys.stdout)
'''


def _start(*args) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO,
                            env=dict(os.environ,
                                     PYTHONPATH=str(REPO / "src")))


def _done(proc: subprocess.Popen, timeout=600) -> str:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return out


def _port(*args, timeout=600) -> str:
    return _done(_start(*args), timeout)


def _port_module(name, *calls) -> subprocess.Popen:
    return _start("-c", _PORT, str(REPO / "examples_torch" / f"{name}.py"),
                  name, str(HOURS), str(SWEEP_S), *calls)


def _export(directory: Path) -> str:
    (found,) = directory.glob("proposed-*")
    return str(found)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' outputs: the port's scripts first (their telemetry
    export goes to the reference's report), then the reference's."""
    tmp = tmp_path_factory.mktemp("examples")
    tel_port, tel_ref = tmp / "tel_port", tmp / "tel_ref"
    started = {  # all three at once
        "quickstart": _port_module("quickstart", "main"),
        "sweeps": _port_module("serve_cluster", "cluster_demo",
                               "routing_demo"),
        "carbon_report": _start(
            "examples_torch/carbon_report.py", "--duration", DURATION,
            "--telemetry", str(tel_port), "--save", str(tmp / "sweep.json"))}
    port = {name: _done(proc) for name, proc in started.items()}
    port.update(save=tmp / "sweep.json", tel=str(tel_port))
    ref = run_reference(_REF, {
        "hours": HOURS, "sweep_s": SWEEP_S, "duration": DURATION,
        "tel": str(tel_ref),
        "exports": {"port": _export(tel_port)}}, timeout=900)
    ref["tel"] = str(tel_ref)
    port["reports"] = {
        name: _port("examples_torch/telemetry_report.py", _export(tel))
        for name, tel in (("port", tel_port), ("ref", tel_ref))}
    return port, ref


def test_quickstart_lines_equal_reference(runs):
    port, ref = runs
    assert port["quickstart"] == ref["quickstart"]
    assert "CPU lifetime extension" in port["quickstart"]


def test_carbon_report_lines_equal_reference(runs):
    """Every line, the telemetry census and its export paths included
    (the directory and the fingerprints, which cover it, written apart),
    then the port's line of the saved sweep."""
    port, ref = runs
    mine = report_lines(port["carbon_report"], port["tel"], drop=())
    assert mine[:-2] == report_lines(ref["carbon_report"], ref["tel"],
                                     drop=())
    assert mine[-1].startswith("sweep saved to")
    assert "yearly embodied carbon reduction (p99)" in port["carbon_report"]


def test_carbon_report_save_loads(runs):
    port, _ = runs
    res = SweepResult.load(port["save"])
    assert set(res) == {"linux", "least-aged", "proposed"}
    assert res["proposed"].provenance.config_hash
    cv = res["proposed"].fleet_degradation_cv
    assert f"fleet degradation CV {cv:.4f}" in port["carbon_report"]


def test_cluster_sweeps_equal_reference(runs):
    port, ref = runs
    assert port["sweeps"] == ref["sweeps"]
    assert "=== cluster-level routing" in port["sweeps"]


@pytest.mark.parametrize("export", ["port", "ref"])
def test_telemetry_report_of_either_export(runs, export):
    """Each package's report of one export: the same lines, the wall
    times included (both read them from the export)."""
    port, ref = runs
    assert port["reports"][export] == ref["reports"][export]
    assert "event census:" in port["reports"][export]


_SERVE_REF = r'''
import contextlib, dataclasses, importlib.util, io
spec = importlib.util.spec_from_file_location("serve_cluster",
                                              "examples/serve_cluster.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
real_config, real_engine = mod.get_smoke_config, mod.InferenceEngine
engines = []


class Engine(real_engine):
    def __init__(self, *args, **kwargs):
        ticks = iter(range(10 ** 9))
        super().__init__(*args, clock=lambda: 0.01 * next(ticks), **kwargs)
        engines.append(self)
        self.requests = []

    def submit(self, prompt, max_new_tokens=32):
        rid = super().submit(prompt, max_new_tokens)
        self.requests.append(self.pending[-1])
        return rid


mod.get_smoke_config = lambda arch: dataclasses.replace(real_config(arch),
                                                        dtype="float32")
mod.InferenceEngine = Engine
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    mod.serve_demo()
json.dump({"stdout": buf.getvalue(),
           "tokens": [r.output for r in engines[0].requests]}, sys.stdout)
'''


def _load_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", REPO / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_demo_tokens_equal_reference(capsys):
    """The serving demo of each package on float32 weights (the
    reference's seeded init, `params_from_jax` into the port's model),
    each engine on a clock that advances 10 ms a reading: the same tokens
    for all 12 requests and the same host-CPU line."""
    ref = run_reference(_SERVE_REF, {})
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                              dtype="float32")
    ref_cfg = dataclasses.replace(ref_smoke_config("llama3-8b"),
                                  dtype="float32")
    params = RefModel(ref_cfg).init(jax.random.key(0))
    model = Model(cfg, device="cpu", seed=0)
    model.load_state_dict(params_from_jax(cfg, params))
    mod = _load_example("serve_cluster")
    real, engines = mod.InferenceEngine, []

    class Engine(real):
        def __init__(self, *args, **kwargs):
            ticks = iter(range(10 ** 9))
            super().__init__(*args, clock=lambda: 0.01 * next(ticks),
                             **kwargs)
            engines.append(self)
            self.requests = []

        def submit(self, prompt, max_new_tokens=32):
            rid = super().submit(prompt, max_new_tokens)
            self.requests.append(self.pending[-1])
            return rid
    mod.InferenceEngine = Engine
    mod.serve_demo(model=model)
    out = capsys.readouterr().out
    tokens = [r.output for r in engines[0].requests]
    assert len(tokens) == 12 and all(len(t) == 12 for t in tokens)
    assert tokens == ref["tokens"]

    def host_line(text):
        return [ln for ln in text.splitlines() if ln.startswith("host CPU")]
    assert host_line(out) == host_line(ref["stdout"])
    assert len(host_line(out)) == 1


_RESUME_REF = r'''
import contextlib, io
from repro.launch import train
sys.argv = ["train", "--arch", "llama3-8b", "--smoke", "--steps", "52",
            "--batch", "8", "--seq", "128", "--log-every", "1",
            "--ckpt-dir", job["ckpt"], "--ckpt-every", "100"]
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    train.main()
json.dump(buf.getvalue(), sys.stdout)
'''


def test_train_small_checkpoint_resumed_by_reference(tmp_path):
    """`train_small --steps 50` on the CPU writes the checkpoint of step 50
    in the reference's layout; the reference's trainer restores it and
    trains steps 51 and 52 from it, to finite losses."""
    ckpt = tmp_path / "ckpt"
    out = _port("examples_torch/train_small.py", "--steps", "50",
                "--device", "cpu", "--ckpt-dir", str(ckpt))
    assert "arch=" in out and "params=" in out
    assert [p.name for p in ckpt.iterdir()] == ["step_00000050"]
    ref = run_reference(_RESUME_REF, {"ckpt": str(ckpt)})
    assert f"restored step 50 from {ckpt}" in ref
    losses = [float(ln.split()[3]) for ln in ref.splitlines()
              if ln.startswith("step ")]
    assert len(losses) == 2 and all(0 < x < 20 for x in losses), ref
