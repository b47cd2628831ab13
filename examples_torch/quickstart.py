"""Quickstart: the paper's aging-aware CPU core management in 60 lines.

Runs one server CPU (40 cores) under a bursty inference load — drawn
from the pluggable workload-scenario registry (`repro_torch.workloads`) —
with the proposed technique vs the linux baseline, and prints the aging
outcome plus the embodied-carbon estimate. Host numpy only: it touches no
device, and prints what `examples/quickstart.py` prints.

  PYTHONPATH=src python examples_torch/quickstart.py
"""
import numpy as np

from repro_torch.carbon import get_carbon_model
from repro_torch.core import CoreManager
from repro_torch.workloads import get_scenario

HOURS = 6
RATE = 3          # mean requests (-> CPU task bursts) per second
SCENARIO = "conversation-mmpp"   # try conversation-diurnal, code-poisson...


def simulate(policy: str) -> CoreManager:
    mgr = CoreManager(num_cores=40, policy=policy,
                      rng=np.random.default_rng(0), idling_period_s=1.0)
    # One request stream, shared by both policies (seeded): each request
    # lands on the host CPU as one short inference task. Merge assigns,
    # releases and periodic ticks into one time-ordered event stream —
    # the manager requires non-decreasing timestamps.
    requests = get_scenario(SCENARIO).generate(
        rate_rps=RATE, duration_s=HOURS * 3600, seed=1)
    durations = np.random.default_rng(2).uniform(0.005, 0.03,
                                                 size=len(requests))
    events = sorted(
        [(r.arrival_s + durations[tid], 0, tid)         # release
         for tid, r in enumerate(requests)]
        + [(r.arrival_s, 1, tid) for tid, r in enumerate(requests)]
        + [(float(k), 2, -1) for k in range(1, HOURS * 3600 + 1)])
    for t, kind, tid in events:
        if kind == 1:
            mgr.assign(tid, t)
        elif kind == 0:
            mgr.release(tid, t)
        else:
            mgr.periodic(t)      # Algorithm 2: Selective Core Idling
    mgr.settle_all(HOURS * 3600)
    return mgr


def main() -> None:
    results = {}
    for policy in ("linux", "proposed"):
        mgr = simulate(policy)
        deg = mgr.mean_frequency_degradation()
        results[policy] = deg
        active = int((mgr.c_state == 0).sum())
        print(f"{policy:10s} mean_freq_degradation={deg:.5f} "
              f"freq_cv={mgr.frequency_cv():.4f} active_cores={active}/40")

    est = get_carbon_model("linear-extension").lifetime(
        results["linux"], results["proposed"])
    print(f"\nCPU lifetime extension: {est.extension_factor:.2f}x "
          f"({est.extended_life_years:.1f} years)")
    print(f"Yearly CPU embodied carbon: "
          f"{est.baseline_yearly_kgco2eq:.1f} -> {est.yearly_kgco2eq:.1f} "
          f"kgCO2eq  ({100*est.reduction_frac:.1f}% reduction)")


if __name__ == "__main__":
    main()
