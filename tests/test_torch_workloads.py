"""Workload, carbon, power and registry copies of the port against the
reference, in this process.

`repro.workloads`, `repro.carbon` and `repro.power` import cleanly on
Python 3.12 (none of them reaches `repro.core`), so both sides run
here. The copies must be exact: the same request lists, the same prices
and the same registry error wordings.
"""
from __future__ import annotations

import dataclasses

import pytest

import repro.carbon as ref_carbon
import repro.power as ref_power
import repro.workloads as ref_workloads
import repro_torch.carbon as carbon
import repro_torch.power as power
import repro_torch.workloads as workloads

SCENARIOS = sorted(ref_workloads.available_scenarios())


def test_same_scenarios():
    assert workloads.available_scenarios() == \
        ref_workloads.available_scenarios()


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_request_list_identical(name):
    """The fingerprint config of `tests/test_workloads.py`."""
    kw = {"rate_rps": 50, "duration_s": 30, "seed": 11}
    port = workloads.get_scenario(name).generate(**kw)
    ref = ref_workloads.get_scenario(name).generate(**kw)
    assert [dataclasses.astuple(r) for r in port] == \
        [dataclasses.astuple(r) for r in ref]


def test_csv_export_identical():
    kw = {"rate_rps": 20, "duration_s": 10, "seed": 3}
    port = workloads.get_scenario("conversation-mmpp").generate(**kw)
    ref = ref_workloads.get_scenario("conversation-mmpp").generate(**kw)
    assert workloads.export_csv_str(port) == ref_workloads.export_csv_str(ref)


@pytest.mark.parametrize("axis", ["scenario", "carbon", "power"])
def test_unknown_name_wording_identical(axis):
    get = {"scenario": (workloads.get_scenario,
                        ref_workloads.get_scenario),
           "carbon": (carbon.get_carbon_model, ref_carbon.get_carbon_model),
           "power": (power.get_power_model, ref_power.get_power_model)}[axis]
    messages = []
    for fn in get:
        with pytest.raises(KeyError) as err:
            fn("definitely-not-registered")
        messages.append(err.value.args[0])
    assert messages[0] == messages[1]


@pytest.mark.parametrize("model", sorted(ref_carbon.available_carbon_models()))
def test_carbon_lifetime_identical(model):
    port = carbon.get_carbon_model(model).lifetime(0.021, 0.011)
    ref = ref_carbon.get_carbon_model(model).lifetime(0.021, 0.011)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("model", sorted(ref_power.available_power_models()))
def test_power_energy_identical(model):
    kw = dict(num_cores=40, duration_s=60.0, busy_core_s=700.0,
              idle_core_s=1000.0, gated_core_s=700.0,
              freq_busy_core_s=690.0, window_s=30.0,
              window_busy_s=(300.0, 400.0), window_idle_s=(500.0, 500.0),
              window_gated_s=(400.0, 300.0))
    port_r = power.StateResidency(**kw)
    ref_r = ref_power.StateResidency(**kw)
    port_m = power.get_power_model(model)
    ref_m = ref_power.get_power_model(model)
    assert port_m.energy_kwh(port_r) == ref_m.energy_kwh(ref_r)
    assert port_m.operational_g(port_r, carbon.ConstantIntensity()) == \
        ref_m.operational_g(ref_r, ref_carbon.ConstantIntensity())
