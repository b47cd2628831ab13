"""Core manager and policies of the port (`repro_torch.core`) against the
reference (`repro.core`), exactly.

One fixed script of `assign` / `release` / `periodic` calls at given
times, with the fault hooks (`fail_core`, slowdowns, `crash`, `reboot`)
mixed in, drives a 16-core `CoreManager` under each of the five policies
(and the carbon-aware variant of `proposed`): once on the reference, in a
child interpreter (`torch_harness`: `repro.core` does not import on
Python 3.12), and once on the port. Both are float64 numpy code on the
host, so every number must be equal: the speeds `assign` returns, the
settled frequencies, C-states, `frequency_cv`,
`mean_frequency_degradation`, the metrics and the residency record. With
a telemetry hub attached, the hub's counters, series, timelines and
events equal the reference's too, and the manager's numbers stay those
of the run without a hub.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
from torch_harness import run_reference

from repro_torch.core import (CoreManager, IdleCorrection,
                              available_policies, get_policy,
                              register_policy)
from repro_torch.core.policies import CorePolicy
from repro_torch.telemetry import TelemetryHub

N_CORES = 16
# the policy driven with a hub: it gates and wakes cores
TELEMETRY_POLICY = "proposed-carbon-aware"
POLICIES = {
    "proposed": ("proposed", {}),
    "linux": ("linux", {}),
    "least-aged": ("least-aged", {}),
    "round-robin": ("round-robin", {}),
    "aging-greedy": ("aging-greedy", {}),
    "proposed-carbon-aware": ("proposed", {"carbon_aware": True,
                                           "dirty_frac": 0.5}),
}


def _script() -> list:
    """Bursts of tasks (so some are oversubscribed), releases in random
    order, a periodic call every idling period, and the fault hooks."""
    rng = np.random.default_rng(2024)
    ops, live, t, next_tick, tid = [], [], 0.0, 1.0, 0
    for step in range(600):
        t += float(rng.uniform(0.001, 0.04))
        burst = (step // 60) % 2 == 0
        if not live or rng.random() < (0.7 if burst else 0.35):
            ops.append(["assign", tid, t])
            live.append(tid)
            tid += 1
        else:
            ops.append(["release", live.pop(int(rng.integers(len(live)))),
                        t])
        if t >= next_tick:
            ops.append(["periodic", t])
            next_tick += 1.0
        if step == 200:
            ops.append(["fail_core", 3, t])
        if step == 260:
            ops.append(["set_core_slowdown", 5, t, 0.5])
        if step == 320:
            ops.append(["clear_core_slowdown", 5, t])
        if step == 400:
            ops.append(["crash", t])
            live.clear()
        if step == 410:
            ops.append(["reboot", t])
    ops.append(["periodic", t + 1.0])
    return ops


_CHILD = r'''
import dataclasses
from repro.core import CoreManager, get_policy, register_policy
from repro.core.policies import CorePolicy

def drive(policy, opts, ops, n, hub=None):
    m = CoreManager(n, policy=policy, policy_opts=opts,
                    rng=np.random.default_rng(0), telemetry=hub,
                    telemetry_id=3)
    speeds = []
    for op in ops:
        name, args = op[0], op[1:]
        if name == "assign":
            speeds.append(m.assign(*args))
        elif name == "periodic":
            m.periodic(*args)
        else:
            getattr(m, name)(*args)
    return {"speeds": speeds,
            "frequencies": m.frequencies(m.now).tolist(),
            "c_state": m.c_state.tolist(), "dvth": m.dvth.tolist(),
            "frequency_cv": m.frequency_cv(),
            "mean_frequency_degradation": m.mean_frequency_degradation(),
            "metrics": dataclasses.asdict(m.metrics),
            "residency": m.residency().to_dict()}

out = {name: drive(policy, opts, job["ops"], job["n"])
       for name, (policy, opts) in job["policies"].items()}

from repro.telemetry import TelemetryHub
hub = TelemetryHub(timeline_every=2)
policy, opts = job["policies"][job["telemetry_policy"]]
res = drive(policy, opts, job["ops"], job["n"], hub)
out["telemetry"] = {
    "drive": res, "summary": hub.summary(), "events": list(hub.events),
    "timelines": {k: [[t, np.asarray(v).tolist()] for t, v in tl.samples()]
                  for k, tl in hub.timelines.items()}}

def error(fn):
    try:
        fn()
    except Exception as err:
        return f"{type(err).__name__}: {err}"

class Dup(CorePolicy):
    pass

out["errors"] = [error(lambda: get_policy("no-such-policy")),
                 error(lambda: register_policy("proposed")(Dup)),
                 error(lambda: register_policy("x")(42))]
json.dump(out, sys.stdout)
'''


def _drive(policy, opts, ops, n, hub=None):
    """The port under the child's `drive`, field for field."""
    m = CoreManager(n, policy=policy, policy_opts=opts,
                    rng=np.random.default_rng(0), telemetry=hub,
                    telemetry_id=3)
    speeds = []
    for op in ops:
        name, args = op[0], op[1:]
        if name == "assign":
            speeds.append(m.assign(*args))
        elif name == "periodic":
            m.periodic(*args)
        else:
            getattr(m, name)(*args)
    return {"speeds": speeds,
            "frequencies": m.frequencies(m.now).tolist(),
            "c_state": m.c_state.tolist(), "dvth": m.dvth.tolist(),
            "frequency_cv": m.frequency_cv(),
            "mean_frequency_degradation": m.mean_frequency_degradation(),
            "metrics": dataclasses.asdict(m.metrics),
            "residency": m.residency().to_dict()}


@pytest.fixture(scope="module")
def reference():
    job = {"ops": _script(), "n": N_CORES,
           "policies": {k: list(v) for k, v in POLICIES.items()},
           "telemetry_policy": TELEMETRY_POLICY}
    return run_reference(_CHILD, job, timeout=300)


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_manager_equals_reference(reference, name):
    policy, opts = POLICIES[name]
    # through JSON as the child's answer came: tuples become lists, and
    # floats round-trip exactly
    port = json.loads(json.dumps(_drive(policy, opts, _script(), N_CORES)))
    ref = reference[name]
    assert port.keys() == ref.keys()
    for key in port:
        assert port[key] == ref[key], key


def test_script_exercises_the_manager(reference):
    """The script reaches oversubscription, gating and the fault hooks."""
    ref = reference["proposed"]
    assert ref["metrics"]["oversub_assigns"] > 0
    assert min(ref["metrics"]["active_count_samples"]) < N_CORES
    assert ref["c_state"][3] != 0          # the failed core stays fenced


def test_registry_error_wordings_equal_reference(reference):
    class Dup(CorePolicy):
        pass

    errors = []
    for fn in (lambda: get_policy("no-such-policy"),
               lambda: register_policy("proposed")(Dup),
               lambda: register_policy("x")(42)):
        with pytest.raises(Exception) as info:
            fn()
        errors.append(f"{type(info.value).__name__}: {info.value}")
    assert errors == reference["errors"]


def test_available_policies():
    assert available_policies() == ("aging-greedy", "least-aged", "linux",
                                    "proposed", "round-robin")


def test_idle_correction_defaults_are_fresh():
    """ROADMAP A3: default factories, not one shared ndarray."""
    a, b = IdleCorrection(), IdleCorrection()
    assert a.to_idle is not b.to_idle
    assert len(a.to_idle) == len(a.to_wake) == 0 and not a


def test_telemetry_hooks_equal_reference(reference):
    """Every probe of the hub equals the reference's, with the per-core
    timelines on a stride of 2 periods; the manager's own numbers equal
    the run without a hub."""
    hub = TelemetryHub(timeline_every=2)
    policy, opts = POLICIES[TELEMETRY_POLICY]
    port = json.loads(json.dumps(_drive(policy, opts, _script(), N_CORES,
                                        hub)))
    ref = reference["telemetry"]
    assert port == ref["drive"] == reference[TELEMETRY_POLICY]
    assert hub.summary() == ref["summary"]
    assert json.loads(json.dumps(list(hub.events))) == ref["events"]
    assert {k: [[t, np.asarray(v).tolist()] for t, v in tl.samples()]
            for k, tl in hub.timelines.items()} == ref["timelines"]
    kinds = ref["summary"]["event_kinds"]
    assert {"assign", "gate", "wake", "oversub", "promote",
            "release"} <= set(kinds)
    # the hub counts a task that finds no free core apart
    assert hub.counter("oversub_assigns").value == \
        port["metrics"]["oversub_assigns"] > 0
    assert hub.counter("assigns").value + \
        hub.counter("oversub_assigns").value == port["metrics"]["assigns"]
