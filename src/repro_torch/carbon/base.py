"""Carbon-accounting data model + `CarbonModel` protocol (paper §2).

Carbon accounting is the fourth pluggable axis of the reproduction
(after policies, workload scenarios and cluster routers): a
`CarbonModel` turns observed aging — a reference degradation and a
technique's degradation over the same horizon — into

  * a `LifetimeEstimate` (how much longer the CPU lives, and what the
    amortized yearly *embodied* carbon becomes), and
  * a `CarbonFootprint` (the yearly total, split into embodied and
    grid-intensity-dependent *operational* components, EcoServe-style).

Models register under string keys (`repro.carbon.registry`) and are
selected per experiment via `ExperimentConfig(carbon_model=...)`.

Constants come from Li'24 ("Towards Carbon-efficient LLM Life Cycle",
paper [18]): a typical Linux LLM inference server refreshes hardware
every 3 years, with 278.3 kgCO2eq CPU embodied carbon over that
lifespan.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar

CPU_EMBODIED_KGCO2EQ = 278.3   # per server CPU over baseline lifespan [18]
BASELINE_LIFESPAN_YEARS = 3.0  # hardware refresh cycle [18]

#: Extension factor substituted when a technique halts aging entirely
#: within the observation horizon (deg_technique <= 0), where the raw
#: ratio diverges — large but finite (a 300-year CPU life is already far
#: beyond any plausible deployment). `linear-extension` applies it ONLY
#: at that singularity, preserving bit-exactness with the pre-subsystem
#: `carbon.estimate` (which never clamped positive ratios);
#: `reliability-threshold` additionally uses it as a true upper clamp
#: (`max_extension` opt) because its ratio^(1/n) amplification reaches
#: unphysical values at ordinary inputs. Named so the figure drivers and
#: docs can reference the exact bound instead of a magic 100.0 buried in
#: a formula.
MAX_EXTENSION_FACTOR = 100.0
#: Floor on the extension factor: a technique that ages *faster* than
#: the reference still yields a positive, finite life.
MIN_EXTENSION_FACTOR = 1e-6


@dataclasses.dataclass(frozen=True)
class LifetimeEstimate:
    """One model's lifetime/embodied-carbon verdict for one CPU.

    Field order (and the first five names) matches the historical
    `repro.core.carbon.CarbonEstimate`, which this type replaces.
    """

    extension_factor: float
    extended_life_years: float
    yearly_kgco2eq: float            # embodied, amortized per year
    baseline_yearly_kgco2eq: float
    reduction_frac: float            # 1 - yearly'/yearly
    model: str = "linear-extension"
    baseline_life_years: float = BASELINE_LIFESPAN_YEARS

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LifetimeEstimate":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class CarbonFootprint:
    """Yearly kgCO2eq of one inference server, split into operational
    (grid-intensity-dependent energy) and embodied (CPU / accelerator
    die amortization) components — the decomposition behind the paper's
    Fig. 1 and EcoServe's serving decisions."""

    operational_kg: float
    cpu_embodied_kg: float
    gpu_embodied_kg: float
    total_kg: float
    carbon_intensity_g_per_kwh: float   # mean intensity priced in
    model: str = "operational-embodied"

    @property
    def embodied_kg(self) -> float:
        return self.cpu_embodied_kg + self.gpu_embodied_kg

    @property
    def embodied_frac(self) -> float:
        return self.embodied_kg / self.total_kg if self.total_kg else 0.0

    @property
    def cpu_embodied_frac(self) -> float:
        return self.cpu_embodied_kg / self.total_kg if self.total_kg else 0.0

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "CarbonFootprint":
        return cls(**d)


class CarbonModel:
    """Base class for pluggable carbon-accounting models.

    Subclasses register under a string key with
    `@register_carbon_model(name)` and are instantiated per experiment
    via `get_carbon_model(name, **opts)`. Both hooks take the same pair
    of observations: `deg_ref`, the reference (worst-case / `linux`)
    mean frequency degradation over the horizon, and `deg_technique`,
    the technique's degradation over the *same* horizon.
    """

    #: canonical registry key, set by @register_carbon_model
    name: ClassVar[str] = "?"

    def lifetime(self, deg_ref: float,
                 deg_technique: float) -> LifetimeEstimate:
        """Project CPU lifetime + amortized embodied carbon."""
        raise NotImplementedError

    def footprint(self, deg_ref: float, deg_technique: float,
                  utilization: float = 0.6) -> CarbonFootprint:
        """Yearly total footprint. The base implementation prices the
        embodied component only (zero-carbon grid); the
        `operational-embodied` model overrides this with an intensity
        signal."""
        life = self.lifetime(deg_ref, deg_technique)
        return CarbonFootprint(
            operational_kg=0.0,
            cpu_embodied_kg=life.yearly_kgco2eq,
            gpu_embodied_kg=0.0,
            total_kg=life.yearly_kgco2eq,
            carbon_intensity_g_per_kwh=0.0,
            model=self.name,
        )

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"
