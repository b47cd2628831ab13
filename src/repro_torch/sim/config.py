"""ExperimentConfig — the one frozen object that defines an experiment.

Replaces the positional-kwarg piles previously duplicated across
`sim/runner.py`, `benchmarks/*` and `examples/*`:

    cfg = ExperimentConfig(policy="proposed", num_cores=40,
                           rate_rps=70.0, duration_s=120.0, seed=1)
    metrics = run_experiment(cfg)
    sweep = run_policy_sweep(cfg, policies=("linux", "proposed"))

The policy is addressed by registry name (see `repro.core.policies`);
`policy_opts` carries constructor options for it (e.g.
`policy="linux", policy_opts={"stickiness": 0.5}`). The workload is
likewise addressed by scenario registry name (see `repro.workloads`)
with `scenario_opts` for its factory (e.g.
`scenario="conversation-mmpp", scenario_opts={"burst_factor": 8.0}`).
The dataclass is frozen and hashable, so configs can key caches and
result dicts.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Mapping

from repro_torch.carbon.registry import canonical_carbon_model_name
from repro_torch.hardware.inventory import canonical_fleet_name
from repro_torch.power.registry import canonical_power_model_name
from repro_torch.workloads import canonical_scenario_name

# The policy, router and fault-model registries are not ported yet
# (ROADMAP A3-A5). Each of their canonical-name helpers is the shared
# registry normalizer, so the port takes that normalizer directly.
from repro_torch.registry import canonical_name as canonical_policy_name
from repro_torch.registry import canonical_name as canonical_router_name
from repro_torch.registry import (
    canonical_name as canonical_fault_model_name)


def _deep_freeze(value):
    """Hashable mirror of nested opts: mappings become sorted item
    tuples, sequences become tuples (fleet rows carry nested opts)."""
    if isinstance(value, Mapping):
        return tuple(sorted((str(k), _deep_freeze(v))
                            for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return tuple(_deep_freeze(v) for v in value)
    return value


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Full specification of one cluster experiment (paper §6.1)."""

    # policy under test (registry name + constructor options)
    policy: str = "proposed"
    policy_opts: tuple[tuple[str, Any], ...] = ()
    # per-machine host CPU
    num_cores: int = 40
    idling_period_s: float = 1.0
    # cluster topology (Splitwise phase-splitting deployment)
    n_prompt: int = 5
    n_token: int = 17
    # cluster-level request routing (router registry name + constructor
    # options; see `repro.sim.routing`)
    router: str = "jsq"
    router_opts: tuple[tuple[str, Any], ...] = ()
    # carbon accounting (model registry name + constructor options; see
    # `repro.carbon` — prices per-machine embodied carbon in the result)
    carbon_model: str = "linear-extension"
    carbon_opts: tuple[tuple[str, Any], ...] = ()
    # machine power accounting (model registry name + constructor options;
    # see `repro.power` — prices measured per-core state residencies into
    # energy and operational carbon in the result)
    power_model: str = "flat-tdp"
    power_opts: tuple[tuple[str, Any], ...] = ()
    # workload (scenario registry name + factory options; the scenario
    # receives rate_rps / duration_s / seed at generation time)
    scenario: str = "conversation-poisson"
    scenario_opts: tuple[tuple[str, Any], ...] = ()
    rate_rps: float = 60.0
    duration_s: float = 120.0
    # bookkeeping
    seed: int = 0
    sample_period_s: float = 0.1
    # residency-window width for temporal power x intensity integration;
    # 0.0 = auto (`max(idling_period_s, duration_s / 1024)`)
    power_window_s: float = 0.0
    # simulation engine: "event" = per-machine event loop (bit-exact
    # small-scale reference), "fleet" = vectorized time-stepped engine
    # (`repro.sim.fleetsim`) for fleet-scale horizons. `engine_opts`
    # carries FleetEngine options (dt_s, backend, checkpoint_dir,
    # checkpoint_every_s, resume).
    engine: str = "event"
    engine_opts: tuple[tuple[str, Any], ...] = ()
    # fault injection (model registry name + constructor options; see
    # `repro.faults` — the sixth axis). "none" (the default) builds no
    # fault machinery at all: bit-exact with pre-fault behavior, and
    # omitted from `fingerprint()` so historical hashes survive.
    fault_model: str = "none"
    fault_opts: tuple[tuple[str, Any], ...] = ()
    # fleet hardware composition (see `repro.hardware` — the seventh
    # axis). "uniform" (the default) keeps every machine on the
    # implicit reference SKU with `num_cores` cores: bit-exact with
    # pre-hardware behavior and omitted from `fingerprint()` so
    # historical hashes survive. Other specs: a catalog SKU name, a
    # "sku:count+sku:count" string, or "mixed" with
    # `fleet_opts={"rows": ((sku, count, opts?), ...)}`.
    fleet: str = "uniform"
    fleet_opts: tuple[tuple[str, Any], ...] = ()
    # streaming telemetry (repro.telemetry): False = zero-cost off.
    # `telemetry_opts` carries TelemetryHub options (window_s,
    # max_events, max_windows, timeline_every, timeline_maxlen) plus the
    # runner-level `export_dir` (write JSONL/trace/series/prom exports
    # there after the run).
    telemetry: bool = False
    telemetry_opts: tuple[tuple[str, Any], ...] = ()

    def __post_init__(self):
        # Normalize: accept any hyphen/underscore spelling for registry
        # names and a dict for opts — store canonical + frozen. Always
        # sorted, so equal logical opts hash equally regardless of the
        # order (or form) they were supplied in.
        object.__setattr__(self, "policy",
                           canonical_policy_name(self.policy))
        object.__setattr__(self, "scenario",
                           canonical_scenario_name(self.scenario))
        object.__setattr__(self, "router",
                           canonical_router_name(self.router))
        object.__setattr__(self, "carbon_model",
                           canonical_carbon_model_name(self.carbon_model))
        object.__setattr__(self, "power_model",
                           canonical_power_model_name(self.power_model))
        object.__setattr__(self, "fault_model",
                           canonical_fault_model_name(self.fault_model))
        object.__setattr__(self, "fleet",
                           canonical_fleet_name(self.fleet))
        for field in ("policy_opts", "scenario_opts", "router_opts",
                      "carbon_opts", "power_opts", "telemetry_opts",
                      "engine_opts", "fault_opts"):
            opts = getattr(self, field)
            if isinstance(opts, Mapping):
                opts = opts.items()
            object.__setattr__(self, field, tuple(sorted(opts)))
        # fleet_opts may nest row tuples with their own opts dicts —
        # deep-freeze so the config stays hashable.
        fopts = self.fleet_opts
        if isinstance(fopts, Mapping):
            fopts = fopts.items()
        object.__setattr__(self, "fleet_opts",
                           tuple(sorted((str(k), _deep_freeze(v))
                                        for k, v in fopts)))
        if self.num_cores < 1:
            raise ValueError(f"num_cores must be >= 1, got {self.num_cores}")
        if self.n_prompt < 1 or self.n_token < 1:
            raise ValueError("need at least one prompt and one token "
                             f"instance, got {self.n_prompt}/{self.n_token}")
        if self.power_window_s < 0.0:
            raise ValueError(f"power_window_s must be >= 0, got "
                             f"{self.power_window_s}")
        if self.engine not in ("event", "fleet"):
            raise ValueError(f"unknown engine {self.engine!r}: expected "
                             f"'event' or 'fleet'")

    @property
    def n_machines(self) -> int:
        return self.n_prompt + self.n_token

    @property
    def policy_options(self) -> dict[str, Any]:
        """`policy_opts` as a plain kwargs dict."""
        return dict(self.policy_opts)

    @property
    def scenario_options(self) -> dict[str, Any]:
        """`scenario_opts` as a plain kwargs dict."""
        return dict(self.scenario_opts)

    @property
    def router_options(self) -> dict[str, Any]:
        """`router_opts` as a plain kwargs dict."""
        return dict(self.router_opts)

    @property
    def carbon_options(self) -> dict[str, Any]:
        """`carbon_opts` as a plain kwargs dict."""
        return dict(self.carbon_opts)

    @property
    def power_options(self) -> dict[str, Any]:
        """`power_opts` as a plain kwargs dict."""
        return dict(self.power_opts)

    @property
    def fault_options(self) -> dict[str, Any]:
        """`fault_opts` as a plain kwargs dict."""
        return dict(self.fault_opts)

    @property
    def fleet_options(self) -> dict[str, Any]:
        """`fleet_opts` as a plain kwargs dict (rows stay tuples)."""
        return dict(self.fleet_opts)

    @property
    def telemetry_options(self) -> dict[str, Any]:
        """`telemetry_opts` as a plain kwargs dict."""
        return dict(self.telemetry_opts)

    @property
    def engine_options(self) -> dict[str, Any]:
        """`engine_opts` as a plain kwargs dict."""
        return dict(self.engine_opts)

    @property
    def resolved_power_window_s(self) -> float:
        """Residency-window width with the auto default applied."""
        if self.power_window_s > 0.0:
            return self.power_window_s
        return max(self.idling_period_s, self.duration_s / 1024.0)

    def fingerprint(self) -> str:
        """Stable short hash of every field — the provenance key that
        says whether two `ExperimentResult`s came from the same
        experiment. Robust to opt ordering (opts are stored sorted).

        Fields still at their defaults that postdate existing pinned
        goldens (`engine`, `engine_opts`, `fault_model`, `fault_opts`,
        `fleet`, `fleet_opts`) are omitted from the payload, so configs
        that don't use them
        keep their historical hashes — a default-engine, faultless
        config fingerprints identically to one built before the fields
        existed."""
        payload_dict = dataclasses.asdict(self)
        if self.engine == "event" and not self.engine_opts:
            del payload_dict["engine"]
            del payload_dict["engine_opts"]
        if self.fault_model == "none" and not self.fault_opts:
            del payload_dict["fault_model"]
            del payload_dict["fault_opts"]
        if self.fleet == "uniform" and not self.fleet_opts:
            del payload_dict["fleet"]
            del payload_dict["fleet_opts"]
        payload = json.dumps(payload_dict, sort_keys=True, default=repr)
        return hashlib.sha256(payload.encode()).hexdigest()[:12]

    def replace(self, **changes) -> "ExperimentConfig":
        """Frozen-friendly copy-with-overrides."""
        return dataclasses.replace(self, **changes)

    def with_policy(self, policy: str,
                    **policy_opts) -> "ExperimentConfig":
        """Same experiment, different policy (opts reset unless given)."""
        return dataclasses.replace(self, policy=policy,
                                   policy_opts=tuple(sorted(
                                       policy_opts.items())))

    def with_scenario(self, scenario: str,
                      **scenario_opts) -> "ExperimentConfig":
        """Same experiment, different workload (opts reset unless given)."""
        return dataclasses.replace(self, scenario=scenario,
                                   scenario_opts=tuple(sorted(
                                       scenario_opts.items())))

    def with_router(self, router: str,
                    **router_opts) -> "ExperimentConfig":
        """Same experiment, different routing (opts reset unless given)."""
        return dataclasses.replace(self, router=router,
                                   router_opts=tuple(sorted(
                                       router_opts.items())))

    def with_carbon_model(self, carbon_model: str,
                          **carbon_opts) -> "ExperimentConfig":
        """Same experiment, different carbon accounting (opts reset
        unless given)."""
        return dataclasses.replace(self, carbon_model=carbon_model,
                                   carbon_opts=tuple(sorted(
                                       carbon_opts.items())))

    def with_power_model(self, power_model: str,
                         **power_opts) -> "ExperimentConfig":
        """Same experiment, different power accounting (opts reset
        unless given)."""
        return dataclasses.replace(self, power_model=power_model,
                                   power_opts=tuple(sorted(
                                       power_opts.items())))

    def with_engine(self, engine: str, **engine_opts) -> "ExperimentConfig":
        """Same experiment, different simulation engine (opts reset
        unless given; see `repro.sim.fleetsim.FleetEngine`)."""
        return dataclasses.replace(self, engine=engine,
                                   engine_opts=tuple(sorted(
                                       engine_opts.items())))

    def with_fault_model(self, fault_model: str,
                         **fault_opts) -> "ExperimentConfig":
        """Same experiment, different fault injection (opts reset
        unless given; see `repro.faults`)."""
        return dataclasses.replace(self, fault_model=fault_model,
                                   fault_opts=tuple(sorted(
                                       fault_opts.items())))

    def with_fleet(self, fleet: str, **fleet_opts) -> "ExperimentConfig":
        """Same experiment, different hardware composition (opts reset
        unless given; see `repro.hardware`)."""
        return dataclasses.replace(self, fleet=fleet,
                                   fleet_opts=tuple(sorted(
                                       fleet_opts.items())))

    def with_telemetry(self, **telemetry_opts) -> "ExperimentConfig":
        """Same experiment, telemetry recording on (opts reset unless
        given; see `repro.telemetry.TelemetryHub` + `export_dir`)."""
        return dataclasses.replace(self, telemetry=True,
                                   telemetry_opts=tuple(sorted(
                                       telemetry_opts.items())))
