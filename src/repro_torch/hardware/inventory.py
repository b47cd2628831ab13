"""Fleet inventory: which SKU each machine is, and what that costs.

A `FleetInventory` is the resolved per-machine hardware description of
one experiment: `(sku_key, count, opts)` rows expanded in machine order
(prompt machines first, token machines after, matching
`repro.sim.cluster`). It answers every per-machine question the stack
asks — core count, aging/variation parameters, per-SKU carbon model,
TDP power scale, and the carbon-intensity phase offset `t0_s`.

Fleet specs (`ExperimentConfig.fleet` / `fleet_opts`):

  fleet="uniform"                       the default clone army; resolves
                                        to None so every legacy code
                                        path runs bit-identically
  fleet="epyc-64c"                      whole fleet on one catalog SKU
                                        (opts override SKU fields)
  fleet="mixed",
  fleet_opts={"rows": (("xeon-40c", 1),
                       ("epyc-64c", 2, {"t0_s": 3600.0}))}
                                        explicit rows; counts must sum
                                        to n_machines ("rest" fills)
  fleet="xeon-40c:1+epyc-64c:2"         the same rows as a CLI-friendly
                                        spec string (--fleet flag)
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.carbon import get_carbon_model
from repro_torch.carbon.base import CarbonModel
from repro_torch.carbon.intensity import CarbonIntensity, ShiftedIntensity
from repro_torch.core import aging
from repro_torch.hardware.base import HardwareSKU
from repro_torch.hardware.registry import canonical_sku_name, get_sku
from repro_torch.registry import canonical_name


def canonical_fleet_name(name: str) -> str:
    """Normalize a fleet spec key; spec strings ("a:1+b:2") pass
    through with their SKU parts canonicalized."""
    name = canonical_name(name)
    if ":" in name or "+" in name:
        return "+".join(
            ":".join([canonical_sku_name(part.split(":", 1)[0])]
                     + part.split(":", 1)[1:])
            for part in name.split("+"))
    return name


def _freeze_opts(opts) -> dict:
    if opts is None:
        return {}
    if isinstance(opts, Mapping):
        return dict(opts)
    return dict(opts)  # tuple of (key, value) pairs


def _parse_spec_string(spec: str) -> tuple:
    """"xeon-40c:1+epyc-64c:rest" -> (("xeon-40c", 1), ("epyc-64c", "rest"))."""
    rows = []
    for part in spec.split("+"):
        sku, _, count = part.partition(":")
        if not sku or not count:
            raise ValueError(
                f"bad fleet spec segment {part!r}; expected 'sku:count' "
                f"(counts: positive int or 'rest')")
        rows.append((sku, count if count == "rest" else int(count)))
    return tuple(rows)


class FleetInventory:
    """Per-machine hardware description, expanded from inventory rows.

    Machine `i`'s SKU is `skus[i]`; all per-machine accessors are
    precomputed tuples so the hot paths never re-instantiate SKUs.
    """

    def __init__(self, skus: tuple[HardwareSKU, ...],
                 sku_names: tuple[str, ...],
                 rows: tuple = ()):
        if not skus:
            raise ValueError("FleetInventory needs at least one machine")
        self.skus = tuple(skus)
        self.sku_names = tuple(sku_names)
        self.rows = tuple(rows)
        self.num_cores = tuple(s.num_cores for s in self.skus)
        self.generations = tuple(s.generation for s in self.skus)
        self.launch_years = tuple(s.launch_year for s in self.skus)
        self.t0_s = tuple(s.t0_s for s in self.skus)
        self.power_scales = tuple(s.power_scale for s in self.skus)
        self.aging_params = tuple(s.aging_params() for s in self.skus)
        self.variation_params = tuple(s.variation_params()
                                      for s in self.skus)

    # ------------------------------------------------------------------ #
    @property
    def n_machines(self) -> int:
        return len(self.skus)

    @property
    def max_cores(self) -> int:
        return max(self.num_cores)

    @property
    def total_cores(self) -> int:
        return sum(self.num_cores)

    @property
    def ragged(self) -> bool:
        """True when machines disagree on core count (the fleet engine
        then pads state to `(n_machines, max_cores)` under a mask)."""
        return len(set(self.num_cores)) > 1

    def shared_dynamics_params(self) -> aging.AgingParams:
        """The one `AgingParams` the vectorized fleet engine advances.

        `f_nominal` only enters through per-machine f0 draws and
        pricing, so SKUs may differ there; any Vdd/Vth (physics) spread
        needs the per-machine event engine."""
        first = self.aging_params[0]
        norm = dataclasses.replace(first, f_nominal=1.0)
        for p in self.aging_params[1:]:
            if dataclasses.replace(p, f_nominal=1.0) != norm:
                raise ValueError(
                    "fleet engine cannot vectorize fleets mixing NBTI "
                    "operating points (Vdd/Vth); run it under "
                    "engine='event'")
        return first

    def carbon_models(self, model_name: str,
                      model_opts: Mapping | None) -> tuple[CarbonModel, ...]:
        """One carbon-model instance per machine, each pricing against
        its own SKU's embodied figure and baseline lifespan."""
        opts = dict(model_opts or {})
        cache: dict[str, CarbonModel] = {}
        out = []
        for name, sku in zip(self.sku_names, self.skus):
            if name not in cache:
                cache[name] = sku_carbon_model(sku, model_name, opts)
            out.append(cache[name])
        return tuple(out)

    def intensity_for(self, i: int,
                      base: CarbonIntensity) -> CarbonIntensity:
        """Machine `i`'s intensity signal: `base` phase-shifted by the
        row's `t0_s` (the base object itself when the offset is 0)."""
        t0 = self.t0_s[i]
        return base if t0 == 0.0 else ShiftedIntensity(base, t0)


def sku_carbon_model(sku: HardwareSKU, model_name: str,
                     model_opts: Mapping | None) -> CarbonModel:
    """Instantiate carbon model `model_name` priced against `sku`.

    Explicit user opts win; the SKU supplies `embodied_kg` /
    `base_life_years` defaults (routed through `lifetime_opts` for
    `operational-embodied`, whose embodied figure lives on its wrapped
    lifetime model). Custom registered models that don't accept the
    embodied kwargs fall back to their plain opts.
    """
    opts = dict(model_opts or {})
    name = canonical_name(model_name)
    if name == "operational-embodied":
        lo = dict(opts.get("lifetime_opts") or {})
        lo.setdefault("embodied_kg", sku.embodied_kg)
        lo.setdefault("base_life_years", sku.base_life_years)
        opts["lifetime_opts"] = lo
        return get_carbon_model(name, **opts)
    skud = dict(opts)
    skud.setdefault("embodied_kg", sku.embodied_kg)
    skud.setdefault("base_life_years", sku.base_life_years)
    try:
        return get_carbon_model(name, **skud)
    except TypeError:
        return get_carbon_model(name, **opts)


def resolve_fleet(fleet: str, fleet_opts: Mapping | None,
                  n_machines: int) -> FleetInventory | None:
    """Resolve a fleet spec to a `FleetInventory`, or None for the
    bit-exact `uniform` default (no opts) — callers treat None as
    "run the legacy homogeneous path unchanged"."""
    name = canonical_fleet_name(fleet)
    opts = _freeze_opts(fleet_opts)
    if name == "uniform" and not opts:
        return None

    if name == "uniform":
        sku_name = canonical_sku_name(opts.pop("sku", "xeon-40c"))
        rows = ((sku_name, "rest", opts),)
    elif name == "mixed":
        raw = opts.pop("rows", None)
        if raw is None:
            raise ValueError(
                "fleet='mixed' needs fleet_opts={'rows': ((sku, count, "
                "opts?), ...)}")
        if opts:
            raise ValueError(f"unknown fleet_opts for 'mixed': "
                             f"{', '.join(sorted(opts))}")
        rows = tuple((r[0], r[1], _freeze_opts(r[2]) if len(r) > 2 else {})
                     for r in raw)
    elif ":" in name or "+" in name:
        rows = tuple((sku, count, dict(opts))
                     for sku, count in _parse_spec_string(name))
    else:
        # bare SKU name: the whole fleet on that part
        rows = ((name, "rest", opts),)

    return _expand_rows(rows, n_machines)


def _expand_rows(rows, n_machines: int) -> FleetInventory:
    skus: list[HardwareSKU] = []
    names: list[str] = []
    rest: tuple[int, HardwareSKU, str] | None = None
    for sku_name, count, row_opts in rows:
        key = canonical_sku_name(sku_name)
        sku = get_sku(key, **_freeze_opts(row_opts))
        if count == "rest" or count is None:
            if rest is not None:
                raise ValueError("only one fleet row may take count='rest'")
            rest = (len(skus), sku, key)
            continue
        if int(count) < 1:
            raise ValueError(f"fleet row count must be >= 1 or 'rest', "
                             f"got {count!r}")
        skus.extend([sku] * int(count))
        names.extend([key] * int(count))
    if rest is not None:
        at, sku, key = rest
        missing = n_machines - len(skus)
        if missing < 0:
            raise ValueError(
                f"fleet rows place {len(skus)} machines but the "
                f"experiment has n_machines={n_machines}")
        skus[at:at] = [sku] * missing
        names[at:at] = [key] * missing
    if len(skus) != n_machines:
        raise ValueError(
            f"fleet rows place {len(skus)} machines but the experiment "
            f"has n_machines={n_machines} (use count='rest' to fill)")
    return FleetInventory(tuple(skus), tuple(names), tuple(
        (n, c, tuple(sorted(o.items()))) for n, c, o in rows))
