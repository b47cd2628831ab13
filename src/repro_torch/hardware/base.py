"""Hardware SKU protocol + Boavizta-style per-CPU embodied-impact table.

A `HardwareSKU` describes one CPU model an operator can rack: core
count, TDP, base/max frequency, the f0/Vth process-distribution
parameters feeding `repro.core.variation` / `repro.core.aging`, the
hardware generation and launch year (for generation-aware routing), and
the embodied-carbon figure used to price replace-vs-extend decisions.

Embodied figures come from a per-CPU-model impact table in the style of
Boavizta / ichnos `EmbodiedCarbon.py`: `get_cpu_impact(cpu_model)`
returns the full-lifecycle manufacturing footprint in kgCO2eq, and
`embodied_carbon(...)` amortizes it over a usage window.

The default (reference) SKU reproduces today's fleet-wide constants
exactly — 40 cores, `CPU_EMBODIED_KGCO2EQ`, `BASELINE_LIFESPAN_YEARS`,
the `tdp-per-core` 13.75 W/core TDP, and `aging.DEFAULT_PARAMS` — so a
`uniform` fleet of reference machines is bit-identical to the
pre-heterogeneity simulator.
"""
from __future__ import annotations

import dataclasses

from repro_torch.carbon.base import BASELINE_LIFESPAN_YEARS, CPU_EMBODIED_KGCO2EQ
from repro_torch.core import aging
from repro_torch.core.variation import VariationParams

#: TDP of the reference SKU (tdp-per-core default: 13.75 W x 40 cores).
#: Per-SKU power scaling is the ratio `cpu_tdp_w / REFERENCE_CPU_TDP_W`.
REFERENCE_CPU_TDP_W = 550.0

#: Hours in the amortization year (matches `repro.carbon`).
_HOURS_PER_YEAR = 24.0 * 365.0

#: Per-CPU-model manufacturing footprint, kgCO2eq over the full
#: lifecycle (Boavizta-style LCA figures a la ichnos EmbodiedCarbon.py).
#: The reference entry equals `CPU_EMBODIED_KGCO2EQ` so default pricing
#: is unchanged; other entries scale roughly with die area / core count.
CPU_IMPACT_KGCO2EQ: dict[str, float] = {
    "reference-xeon-40c": CPU_EMBODIED_KGCO2EQ,   # 278.3
    "xeon-e5-2695v4-18c": 127.9,
    "xeon-platinum-8280-28c": 191.4,
    "epyc-9354-32c": 224.6,
    "epyc-9554-64c": 347.8,
    "epyc-9754-128c": 512.5,
}


def get_cpu_impact(cpu_model: str) -> float:
    """Full-lifecycle embodied footprint of `cpu_model` in kgCO2eq."""
    try:
        return CPU_IMPACT_KGCO2EQ[cpu_model]
    except KeyError:
        raise KeyError(
            f"unknown cpu_model {cpu_model!r} in the embodied-impact "
            f"table; known: {', '.join(sorted(CPU_IMPACT_KGCO2EQ))}"
        ) from None


def embodied_carbon(cpu_model: str, duration_used_h: float,
                    lifetime_years: float = BASELINE_LIFESPAN_YEARS,
                    cpu_usage: float = 1.0) -> float:
    """Embodied kgCO2eq attributable to `duration_used_h` hours of use,
    amortizing the LCA figure over `lifetime_years` (ichnos-style)."""
    if duration_used_h < 0.0:
        raise ValueError("duration_used_h must be >= 0")
    if lifetime_years <= 0.0:
        raise ValueError("lifetime_years must be > 0")
    total = get_cpu_impact(cpu_model)
    return total * (duration_used_h / (lifetime_years * _HOURS_PER_YEAR)) \
        * cpu_usage


@dataclasses.dataclass(frozen=True)
class HardwareSKU:
    """One CPU model: silicon, power, and embodied-carbon description.

    Subclass and redeclare field defaults to add catalog entries (see
    `repro.hardware.skus`); `register_sku` makes them selectable by
    name. `embodied_kgco2eq == 0.0` means "look `cpu_model` up in
    `CPU_IMPACT_KGCO2EQ`".
    """

    num_cores: int = 40
    cpu_model: str = "reference-xeon-40c"
    generation: int = 3
    launch_year: int = 2021
    cpu_tdp_w: float = REFERENCE_CPU_TDP_W
    base_freq_ghz: float = 2.3
    max_freq_ghz: float = 3.4
    #: process-distribution parameters: fresh-core frequencies are drawn
    #: around `f_nominal` with spread `sigma_frac` (repro.core.variation)
    f_nominal: float = 1.0
    sigma_frac: float = 0.05
    #: NBTI operating point; headroom = vdd - vth (repro.core.aging)
    vdd: float = 1.0
    vth: float = 0.45
    embodied_kgco2eq: float = 0.0
    base_life_years: float = BASELINE_LIFESPAN_YEARS
    #: carbon-intensity phase offset (timezone) for machines of this row
    t0_s: float = 0.0

    def __post_init__(self):
        if self.num_cores < 1:
            raise ValueError("num_cores must be >= 1")
        if self.cpu_tdp_w <= 0.0:
            raise ValueError("cpu_tdp_w must be > 0")
        if self.sigma_frac < 0.0:
            raise ValueError("sigma_frac must be >= 0")
        if not self.vdd > self.vth:
            raise ValueError("vdd must exceed vth (aging headroom)")
        if self.base_life_years <= 0.0:
            raise ValueError("base_life_years must be > 0")

    # ------------------------------------------------------------------ #
    @property
    def embodied_kg(self) -> float:
        """Embodied footprint: explicit override or impact-table entry."""
        if self.embodied_kgco2eq > 0.0:
            return self.embodied_kgco2eq
        return get_cpu_impact(self.cpu_model)

    @property
    def power_scale(self) -> float:
        """TDP relative to the reference SKU; multiplies every power
        figure the configured power model reports for this machine."""
        return self.cpu_tdp_w / REFERENCE_CPU_TDP_W

    def aging_params(self, base: aging.AgingParams | None = None
                     ) -> aging.AgingParams:
        """NBTI parameters for this silicon. Returns `base` *unchanged*
        (same object) when the SKU matches its operating point — the
        identity keeps reference-SKU fleets bit-exact and lets the
        fleet settler group machines sharing parameters."""
        base = aging.DEFAULT_PARAMS if base is None else base
        if (self.vdd, self.vth, self.f_nominal) == \
                (base.vdd, base.vth, base.f_nominal):
            return base
        return aging.solve_k(dataclasses.replace(
            base, vdd=self.vdd, vth=self.vth, f_nominal=self.f_nominal,
            K=0.0))

    def variation_params(self) -> VariationParams:
        """Process-variation distribution for fresh-core f0 draws."""
        return VariationParams(sigma_frac=self.sigma_frac,
                               f_nominal=self.f_nominal)
