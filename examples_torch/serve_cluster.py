"""End-to-end driver (the paper's kind = inference serving): serve a small
model with batched requests through the continuous-batching engine while
the aging-aware core manager governs the host CPU, then replay the SAME
workload shape at cluster scale in the simulator and report the paper's
headline metrics.

  PYTHONPATH=src python examples_torch/serve_cluster.py [--metrics-port PORT]
      [--device cpu]

The serving demo runs on the card unless `--device cpu`; without CUDA it
refuses rather than fall back to the CPU. On the card its prefill and
decode attention go through the flash_attention and decode_attention
kernels. The two cluster sweeps run the event engine on the host (numpy)
and print what `examples/serve_cluster.py` prints.

With `--metrics-port`, the serving demo additionally exposes the
engine's live Prometheus-style snapshot at
`http://127.0.0.1:PORT/metrics` while it drains — the same metrics
surface the simulator exports (`repro_torch.telemetry.prometheus_text`),
which is what lets a simulator run shadow a live engine as a digital
twin.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from repro_torch.serving.engine import InferenceEngine
from repro_torch.sim import (ExperimentConfig, carbon_comparison,
                             run_policy_sweep)
from repro_torch.telemetry import TelemetryHub, start_metrics_server


def serve_demo(metrics_port: int | None = None,
               model: Model | None = None, device: str = "cuda") -> None:
    """The serving demo on `model`; by default the smoke Llama-3-8B on
    `device`, its weights from the port's seeded init (seed 0)."""
    print("=== serving demo (llama3-8b reduced config) ===")
    if model is None:
        model = Model(get_smoke_config("llama3-8b"), device=device, seed=0)
    cfg = model.cfg
    engine = InferenceEngine(model, max_batch=4, max_len=96,
                             policy="proposed", num_host_cores=16,
                             telemetry=TelemetryHub())
    server = None
    if metrics_port is not None:
        server = start_metrics_server(engine.prometheus_text,
                                      port=metrics_port)
        print(f"metrics endpoint: "
              f"http://127.0.0.1:{server.server_port}/metrics")
    rng = np.random.default_rng(0)
    t0 = time.time()
    for _ in range(12):
        engine.submit(rng.integers(0, cfg.vocab_size, 24).tolist(),
                      max_new_tokens=12)
    engine.run_until_drained()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.time() - t0
    print(f"12 requests x 12 tokens in {dt:.2f}s "
          f"({144/dt:,.1f} tok/s)")
    rep = engine.host_cpu_report()
    print(f"host CPU: active {rep['active_cores']}/16 cores, "
          f"{rep['assigns']} CPU tasks routed through Algorithm 1")
    snapshot = engine.prometheus_text()
    head = [ln for ln in snapshot.splitlines()
            if not ln.startswith("#")][:6]
    print("prometheus snapshot (first lines):")
    for ln in head:
        print(f"  {ln}")
    if server is not None:
        server.shutdown()
    print()


def cluster_demo() -> None:
    print("=== cluster simulation (22 machines, policy x scenario) ===")
    res = run_policy_sweep(
        ExperimentConfig(num_cores=40, rate_rps=60, duration_s=60, seed=0),
        policies=("linux", "least-aged", "proposed"),
        scenarios=("conversation-poisson", "conversation-mmpp"))
    for (policy, scenario), m in res.items():
        print(f"{policy:10s} {scenario:24s} "
              f"deg_p99={m.mean_degradation_percentiles[99]:.5f} "
              f"idle_p90={m.idle_norm_percentiles[90]:+.3f} "
              f"lat_p99={m.p99_latency_s:.1f}s")
    sc = "conversation-poisson"
    est = carbon_comparison(res[("linux", sc)], res[("proposed", sc)], 99)
    print(f"\nestimated yearly CPU-embodied carbon reduction (p99, {sc}): "
          f"{100*est.reduction_frac:.2f}%  (paper: 37.67%)")


def routing_demo() -> None:
    print("\n=== cluster-level routing (fleet aging imbalance) ===")
    cfg = ExperimentConfig(num_cores=40, rate_rps=60, duration_s=60, seed=0)
    res = run_policy_sweep(cfg, policies=("proposed",),
                           routers=("jsq", "least-aged-cpu",
                                    "carbon-greedy"))
    for (policy, router), m in res.items():
        print(f"{router:16s} fleet_deg_cv={m.fleet_degradation_cv:.4f} "
              f"fleet_yearly={m.fleet_yearly_kgco2eq:7.1f} kgCO2eq "
              f"lat_p99={m.p99_latency_s:.1f}s")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="expose the engine's Prometheus-style snapshot "
                    "at /metrics on this port during the serving demo "
                    "(0 = ephemeral)")
    ap.add_argument("--device", default="cuda",
                    help="where the serving demo's model runs (the "
                    "cluster sweeps run on the host)")
    args = ap.parse_args()
    serve_demo(metrics_port=args.metrics_port, device=args.device)
    cluster_demo()
    routing_demo()
