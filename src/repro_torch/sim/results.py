"""Structured, serializable experiment results.

`ExperimentResult` is the frozen record one `run_experiment` call
produces (replacing the mutable, numpy-laden `ExperimentMetrics`):
every field is a plain Python value, `to_dict`/`from_dict` round-trip
losslessly through JSON, and a `Provenance` block (config hash, seed,
package version) says exactly which experiment produced it.

`SweepResult` wraps a `run_policy_sweep` grid. It is a read-only
`Mapping` with the same keys the sweep always returned (policy name, or
`(policy, scenario)` / `(policy, router)` / `(policy, scenario,
router)` tuples), plus `save`/`load` for persistence and `to_rows` for
flat tables that diff across runs:

    sweep = run_policy_sweep(cfg, policies=("linux", "proposed"))
    sweep["proposed"].p99_latency_s          # mapping access, as before
    sweep.save("sweep.json")
    old = SweepResult.load("sweep.json")
    rows = sweep.to_rows()                   # flat dicts, one per cell
"""
from __future__ import annotations

import dataclasses
import json
import math
from collections.abc import Mapping
from typing import Any, Iterator

from repro_torch.carbon.base import LifetimeEstimate
from repro_torch.power.residency import StateResidency

#: bumped when the serialized layout changes incompatibly
RESULT_SCHEMA_VERSION = 1


def _check_schema(version) -> None:
    if version != RESULT_SCHEMA_VERSION:
        raise ValueError(f"unsupported result schema {version!r}; this "
                         f"version reads schema {RESULT_SCHEMA_VERSION}")


def _tuplify(v):
    """JSON arrays back to tuples (deep) — opts are stored as tuples
    (the repo's frozen-config convention), and the round-trip must
    restore them for dataclass equality."""
    if isinstance(v, list):
        return tuple(_tuplify(x) for x in v)
    if isinstance(v, dict):
        return {k: _tuplify(x) for k, x in v.items()}
    return v


def _package_version() -> str:
    try:
        from importlib.metadata import version
        return version("repro-aging-core-mgmt")
    except Exception:
        # running from a source checkout (PYTHONPATH=src) without an
        # installed distribution
        return "0.1.0+src"


PACKAGE_VERSION = _package_version()


@dataclasses.dataclass(frozen=True)
class Provenance:
    """Where a result came from: enough to re-run or refuse to compare.

    `config_hash` is `ExperimentConfig.fingerprint()` — two results with
    different hashes were produced by different experiments and should
    not be diffed as if they were reruns.
    """

    config_hash: str
    seed: int
    package_version: str = PACKAGE_VERSION

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Provenance":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ExperimentResult:
    """Frozen record of one cluster experiment (paper §6.1.3 metrics).

    Sequence fields are tuples (not lists/ndarrays) and the dataclass is
    frozen, so the record is JSON-serializable and can't be rebound;
    the three percentile fields remain plain dicts for ergonomic
    `result.x_percentiles[99]` access — treat them as read-only.
    `None` defaults mark optional per-machine detail that older
    serialized results may omit.
    """

    policy: str
    num_cores: int
    rate_rps: float
    scenario: str
    # paper Fig. 6: CV of per-server core-frequency distribution, and mean
    # frequency degradation, percentiled across the cluster's machines.
    freq_cv_percentiles: dict[int, float]
    mean_degradation_percentiles: dict[int, float]
    # paper Fig. 8: normalized idle cores distribution (negative = oversub)
    idle_norm_percentiles: dict[int, float]
    oversub_frac_below: float      # fraction of samples below -0.1
    # paper Fig. 2: concurrent CPU tasks per machine
    task_count_mean: float
    task_count_max: int
    # service quality (NaN when nothing completed — a starved config must
    # never rank as winning a latency comparison)
    mean_latency_s: float
    p99_latency_s: float
    completed: int
    # cluster-routing axis (see `repro.sim.routing`)
    router: str = "jsq"
    # carbon-accounting axis (see `repro.carbon`): the model (and its
    # constructor opts) that priced `per_machine_carbon` /
    # `fleet_yearly_kgco2eq` — kept so default `carbon_comparison`
    # pricing can rebuild the exact same model
    carbon_model: str = "linear-extension"
    carbon_opts: tuple[tuple[str, Any], ...] = ()
    # fleet-level aging imbalance: cross-machine CV of per-machine mean
    # frequency degradation, computed within each serving role (prompt /
    # token) and machine-count-weighted. A cluster router can only level
    # aging among peers serving the same phase — the prompt/token role
    # gap is deployment topology, not routing quality — so mixing roles
    # into one CV would swamp the quantity routing actually controls.
    fleet_degradation_cv: float = float("nan")
    # per-machine embodied-carbon estimates vs the worst-case
    # linear-aging reference at the same horizon, and their fleet total;
    # `deg_reference` is that reference degradation, kept so the fleet
    # can be re-priced under another model without re-simulating
    per_machine_carbon: tuple[LifetimeEstimate, ...] | None = None
    fleet_yearly_kgco2eq: float = float("nan")
    deg_reference: float | None = None
    # raw per-machine values for downstream carbon estimates
    per_machine_cv: tuple[float, ...] | None = None
    per_machine_degradation: tuple[float, ...] | None = None
    per_machine_idle_norm: tuple[tuple[float, ...], ...] | None = None
    per_machine_task_samples: tuple[tuple[int, ...], ...] | None = None
    # power-accounting axis (see `repro.power`): the model (and opts)
    # that priced the measured per-core state residencies into energy /
    # operational carbon. `per_machine_residency` keeps the raw
    # residencies so the fleet can be re-priced under another power
    # model without re-simulating (`fleet_energy_under`).
    power_model: str = "flat-tdp"
    power_opts: tuple[tuple[str, Any], ...] = ()
    per_machine_energy_kwh: tuple[float, ...] | None = None
    per_machine_residency: tuple[StateResidency, ...] | None = None
    fleet_energy_kwh: float = float("nan")      # over the sim horizon
    mean_machine_power_w: float = float("nan")
    # operational carbon from measured energy x the carbon model's grid
    # intensity, over the sim horizon and annualized; `..._total` adds
    # the embodied yearly figure for the full-footprint headline
    fleet_operational_kgco2eq: float = float("nan")
    fleet_yearly_operational_kgco2eq: float = float("nan")
    fleet_yearly_total_kgco2eq: float = float("nan")
    # telemetry digest (`TelemetryHub.summary()` + export paths) when the
    # run recorded telemetry; None otherwise. A JSON-safe plain dict —
    # deliberately NOT part of `scalars()`: it carries wall-time gauges
    # that legitimately differ between bit-identical reruns, so it must
    # never trip `diff_scalars` drift checks.
    telemetry_summary: dict[str, Any] | None = None
    # which simulation engine produced this result: "event" (bit-exact
    # per-machine event loop) or "fleet" (vectorized time-stepped
    # surrogate, `repro.sim.fleetsim`). Deliberately NOT part of
    # `scalars()` — engine parity checks diff the metric columns of an
    # event run against a fleet run, so the engine label itself must
    # not show up as a drift.
    engine: str = "event"
    # fault-injection axis (see `repro.faults`): which fault model ran
    # and the robustness metrics it produced. With the default "none"
    # model every field below keeps its default and `scalars()` omits
    # the whole block, so faultless scalar rows (and the pinned drift
    # gate) stay byte-identical to pre-fault results.
    fault_model: str = "none"
    fault_opts: tuple[tuple[str, Any], ...] = ()
    # hardware axis (see `repro.hardware`): which fleet composition ran
    # and each machine's SKU name. With the default "uniform" fleet the
    # fields keep their defaults and `scalars()` omits the block, so
    # uniform scalar rows (and the pinned drift-gate golden) stay
    # byte-identical to pre-hardware results.
    fleet: str = "uniform"
    fleet_opts: tuple[tuple[str, Any], ...] = ()
    per_machine_sku: tuple[str, ...] | None = None
    availability: float = 1.0      # 1 - lost core-seconds / capacity
    core_failures: int = 0
    machine_crashes: int = 0
    stalls: int = 0
    retries: int = 0
    failed_requests: int = 0       # admitted, then retry budget exhausted
    rejected_requests: int = 0     # never admitted (no live machine)
    pending_requests: int = 0      # still in flight at the horizon
    submitted: int = -1            # -1 = not tracked (faults off)
    p99_degraded_window_s: float = 0.0
    provenance: Provenance | None = None

    # ------------------------------------------------------------------ #
    # serialization
    # ------------------------------------------------------------------ #
    def to_dict(self) -> dict[str, Any]:
        """Plain-value dict; `json.dumps`-able (NaN uses the JSON
        extension Python emits/reads by default)."""
        d = dataclasses.asdict(self)
        d["schema"] = RESULT_SCHEMA_VERSION
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentResult":
        d = dict(d)
        _check_schema(d.pop("schema", RESULT_SCHEMA_VERSION))
        for f in ("freq_cv_percentiles", "mean_degradation_percentiles",
                  "idle_norm_percentiles"):
            d[f] = {int(p): float(v) for p, v in d[f].items()}
        d["carbon_opts"] = tuple((str(k), _tuplify(v))
                                 for k, v in d.get("carbon_opts", ()))
        d["power_opts"] = tuple((str(k), _tuplify(v))
                                for k, v in d.get("power_opts", ()))
        d["fault_opts"] = tuple((str(k), _tuplify(v))
                                for k, v in d.get("fault_opts", ()))
        d["fleet_opts"] = tuple((str(k), _tuplify(v))
                                for k, v in d.get("fleet_opts", ()))
        if d.get("per_machine_sku") is not None:
            d["per_machine_sku"] = tuple(str(s)
                                         for s in d["per_machine_sku"])
        if d.get("per_machine_carbon") is not None:
            d["per_machine_carbon"] = tuple(
                LifetimeEstimate.from_dict(e)
                for e in d["per_machine_carbon"])
        for f in ("per_machine_cv", "per_machine_degradation",
                  "per_machine_energy_kwh"):
            if d.get(f) is not None:
                d[f] = tuple(float(x) for x in d[f])
        if d.get("per_machine_residency") is not None:
            d["per_machine_residency"] = tuple(
                StateResidency.from_dict(r)
                for r in d["per_machine_residency"])
        if d.get("per_machine_idle_norm") is not None:
            d["per_machine_idle_norm"] = tuple(
                tuple(float(x) for x in row)
                for row in d["per_machine_idle_norm"])
        if d.get("per_machine_task_samples") is not None:
            d["per_machine_task_samples"] = tuple(
                tuple(int(x) for x in row)
                for row in d["per_machine_task_samples"])
        if d.get("provenance") is not None:
            d["provenance"] = Provenance.from_dict(d["provenance"])
        return cls(**d)

    def to_json(self, **dumps_kw) -> str:
        return json.dumps(self.to_dict(), **dumps_kw)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentResult":
        return cls.from_dict(json.loads(text))

    # ------------------------------------------------------------------ #
    # tabulation
    # ------------------------------------------------------------------ #
    _SCALARS = ("policy", "scenario", "router", "carbon_model",
                "power_model", "num_cores",
                "rate_rps", "completed", "task_count_mean", "task_count_max",
                "oversub_frac_below", "mean_latency_s", "p99_latency_s",
                "fleet_degradation_cv", "fleet_yearly_kgco2eq",
                "fleet_energy_kwh", "mean_machine_power_w",
                "fleet_yearly_operational_kgco2eq",
                "fleet_yearly_total_kgco2eq")
    _PCT_SHORT = (("freq_cv_percentiles", "freq_cv"),
                  ("mean_degradation_percentiles", "mean_degradation"),
                  ("idle_norm_percentiles", "idle_norm"))
    # appended to `scalars()` only when a fault model actually ran —
    # faultless rows must stay byte-identical (`diff_scalars` flags any
    # new key as drift, and the pinned golden mini-grid is faultless)
    _ROBUST_SCALARS = ("fault_model", "availability", "core_failures",
                      "machine_crashes", "stalls", "retries",
                      "failed_requests", "rejected_requests",
                      "pending_requests", "submitted",
                      "p99_degraded_window_s")
    # appended only when a non-uniform fleet ran, for the same reason
    _FLEET_SCALARS = ("fleet",)

    def scalars(self) -> dict[str, Any]:
        """One flat row: identity + scalar metrics + flattened
        percentiles (`mean_degradation_p99`-style keys). Per-machine
        detail is deliberately dropped — this is the diffable view."""
        row: dict[str, Any] = {f: getattr(self, f) for f in self._SCALARS}
        for field, short in self._PCT_SHORT:
            for p, v in getattr(self, field).items():
                row[f"{short}_p{p}"] = v
        if self.fault_model != "none":
            for f in self._ROBUST_SCALARS:
                row[f] = getattr(self, f)
        if self.fleet != "uniform":
            for f in self._FLEET_SCALARS:
                row[f] = getattr(self, f)
        if self.provenance is not None:
            row["config_hash"] = self.provenance.config_hash
            row["seed"] = self.provenance.seed
        return row

    def fleet_yearly_under(self, model=None) -> float:
        """Re-price the fleet's yearly embodied total under another
        carbon model. The simulation is carbon-model-independent, so
        repricing saved degradation data is exact: `model=None` rebuilds
        the result's own model *and opts*, reproducing
        `fleet_yearly_kgco2eq` bit for bit; a registry name is built
        with default opts; pass a `CarbonModel` instance for full
        control."""
        from repro_torch.carbon import get_carbon_model
        from repro_torch.carbon.base import CarbonModel
        if model is None:
            model = get_carbon_model(self.carbon_model,
                                     **dict(self.carbon_opts))
        elif not isinstance(model, CarbonModel):
            model = get_carbon_model(model)
        if self.deg_reference is None or self.per_machine_degradation is None:
            raise ValueError("result lacks per-machine degradation detail "
                             "(deg_reference/per_machine_degradation)")
        return float(sum(
            model.lifetime(self.deg_reference, max(d, 0.0)).yearly_kgco2eq
            for d in self.per_machine_degradation))

    def fleet_energy_under(self, model=None) -> float:
        """Re-price the fleet's horizon energy (kWh) under another power
        model. The saved per-machine residencies are power-model-
        independent, so repricing is exact: `model=None` rebuilds the
        result's own model *and opts*, reproducing `fleet_energy_kwh`
        bit for bit; a registry name is built with default opts; pass a
        `PowerModel` instance for full control."""
        from repro_torch.power import get_power_model
        from repro_torch.power.base import PowerModel
        if model is None:
            model = get_power_model(self.power_model,
                                    **dict(self.power_opts))
        elif not isinstance(model, PowerModel):
            model = get_power_model(model)
        if self.per_machine_residency is None:
            raise ValueError("result lacks per-machine residency detail "
                             "(per_machine_residency)")
        return float(sum(model.energy_kwh(r)
                         for r in self.per_machine_residency))

    def same_experiment(self, other: "ExperimentResult") -> bool:
        """True when both results carry provenance for the *same*
        experiment config — the precondition for diffing them as
        reruns."""
        return (self.provenance is not None
                and other.provenance is not None
                and self.provenance.config_hash
                == other.provenance.config_hash)


def _result_key(key) -> str | tuple[str, ...]:
    """Normalize a sweep key: JSON lists come back as tuples."""
    if isinstance(key, str):
        return key
    parts = tuple(key)
    return parts if len(parts) > 1 else parts[0]


class SweepResult(Mapping):
    """A `run_policy_sweep` grid: ordered `(key -> ExperimentResult)`.

    Behaves exactly like the dict the sweep historically returned
    (`sweep["proposed"]`, `sweep[("proposed", "jsq")]`, iteration in
    insertion order, `len`, `.items()` / `.values()`), plus:

      axes     — the grid's axis names, e.g. ("policy", "router")
      to_rows  — flat diffable dicts (axis columns + scalar metrics)
      save     — persist to JSON;  load — read back losslessly
    """

    def __init__(self, cells, axes: tuple[str, ...] = ("policy",)):
        self.axes = tuple(axes)
        self._cells: dict[Any, ExperimentResult] = {}
        for key, result in (cells.items() if isinstance(cells, Mapping)
                            else cells):
            key = _result_key(key)
            arity = len(key) if isinstance(key, tuple) else 1
            if arity != len(self.axes):
                raise ValueError(
                    f"sweep key {key!r} has {arity} part(s) but the grid "
                    f"declares axes {self.axes}")
            if not isinstance(result, ExperimentResult):
                raise TypeError(f"cell {key!r} must hold an "
                                f"ExperimentResult, got {result!r}")
            self._cells[key] = result

    # -- Mapping protocol ---------------------------------------------- #
    def __getitem__(self, key) -> ExperimentResult:
        return self._cells[_result_key(key)]

    def __iter__(self) -> Iterator:
        return iter(self._cells)

    def __len__(self) -> int:
        return len(self._cells)

    def __repr__(self) -> str:
        return (f"SweepResult(axes={self.axes}, "
                f"cells={len(self._cells)})")

    # -- tabulation / persistence -------------------------------------- #
    def to_rows(self) -> list[dict[str, Any]]:
        """One flat dict per cell: axis columns first, then the cell's
        scalar metrics — ready for CSV emission or cross-run diffs."""
        rows = []
        for key, result in self._cells.items():
            parts = key if isinstance(key, tuple) else (key,)
            row = dict(zip(self.axes, parts))
            row.update(result.scalars())
            rows.append(row)
        return rows

    def to_dict(self) -> dict[str, Any]:
        return {
            "schema": RESULT_SCHEMA_VERSION,
            "package_version": PACKAGE_VERSION,
            "axes": list(self.axes),
            "cells": [
                {"key": list(key) if isinstance(key, tuple) else [key],
                 "result": result.to_dict()}
                for key, result in self._cells.items()
            ],
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SweepResult":
        _check_schema(d.get("schema", RESULT_SCHEMA_VERSION))
        axes = tuple(d["axes"])
        cells = [(_result_key(c["key"]),
                  ExperimentResult.from_dict(c["result"]))
                 for c in d["cells"]]
        return cls(cells, axes=axes)

    def save(self, path: str) -> None:
        """Write the grid to `path` as JSON (lossless: `load` restores
        every field, including per-machine detail and provenance)."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "SweepResult":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def diff_scalars(self, other: "SweepResult",
                     rel_tol: float = 0.0) -> dict[Any, dict[str, tuple]]:
        """Cells/fields whose scalar metrics differ between two sweeps —
        `{key: {field: (self_value, other_value)}}`. A cell present in
        only one sweep is itself a diff, reported under the pseudo-field
        `"_cell"` as `("present", "missing")` (or the reverse), so a
        dropped or renamed grid cell can never pass a
        `diff_scalars(old) == {}` drift check. NaN == NaN here (a
        starved cell matching a starved cell is not a diff)."""
        out: dict[Any, dict[str, tuple]] = {}
        for key in other:
            if key not in self:
                out[key] = {"_cell": ("missing", "present")}
        for key in self:
            if key not in other:
                out[key] = {"_cell": ("present", "missing")}
                continue
            a, b = self[key].scalars(), other[key].scalars()
            fields = {}
            for f, va in a.items():
                vb = b.get(f)
                if isinstance(va, float) and isinstance(vb, float):
                    if math.isnan(va) and math.isnan(vb):
                        continue
                    if va == vb or (rel_tol and vb and
                                    abs(va - vb) <= rel_tol * abs(vb)):
                        continue
                    fields[f] = (va, vb)
                elif va != vb:
                    fields[f] = (va, vb)
            if fields:
                out[key] = fields
        return out
