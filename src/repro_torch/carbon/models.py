"""Built-in carbon models (paper §2.1/§2.2, §6.2 Fig. 7; EcoServe).

Amortization accounts embodied carbon over the asset's operating life:
a CPU with E kgCO2eq embodied over L years emits E/L kgCO2eq per year.
Slowing aging extends L; how observed degradation maps to L is exactly
what the pluggable models disagree about:

  linear-extension      — the paper's model: life scales with the ratio
                          of reference to technique degradation
                          (conservative; this is the 37.67% headline)
  reliability-threshold — life ends when projected degradation crosses
                          the frequency guardband (paper §2.2); NBTI's
                          dVth = ADF * t^n inverts to a ratio^(1/n)
                          extension (optimistic upper bound)
  operational-embodied  — EcoServe-style total: embodied amortization
                          from a wrapped lifetime model *plus*
                          operational carbon priced by a grid
                          `CarbonIntensity` signal

Reporting the same experiment under several models gives an
EcoLogits-style range over explicit assumptions instead of one number.
"""
from __future__ import annotations

from repro_torch.carbon.base import (BASELINE_LIFESPAN_YEARS, CPU_EMBODIED_KGCO2EQ,
                               CarbonFootprint, CarbonModel,
                               LifetimeEstimate, MAX_EXTENSION_FACTOR,
                               MIN_EXTENSION_FACTOR)
from repro_torch.carbon.intensity import CarbonIntensity, get_intensity
from repro_torch.carbon.registry import get_carbon_model, register_carbon_model

#: NBTI reaction-diffusion time exponent (paper §3.2); must match the
#: `repro.core.aging.AgingParams.n` default — duplicated here (rather
#: than imported) so the carbon layer never imports `repro.core`, which
#: itself re-exports this package through `repro.core.carbon`.
NBTI_TIME_EXPONENT = 1.0 / 6.0


def _amortize(model_name: str, ext: float, embodied_kg: float,
              base_life_years: float) -> LifetimeEstimate:
    """Turn an extension factor into the amortized estimate — the
    arithmetic shared by every lifetime model (kept in one place, and in
    this exact operation order: it is golden-pinned bit-exact against
    the pre-subsystem `carbon.estimate`)."""
    life = base_life_years * ext
    yearly = embodied_kg / life
    base_yearly = embodied_kg / base_life_years
    return LifetimeEstimate(
        extension_factor=ext,
        extended_life_years=life,
        yearly_kgco2eq=yearly,
        baseline_yearly_kgco2eq=base_yearly,
        reduction_frac=1.0 - yearly / base_yearly,
        model=model_name,
        baseline_life_years=base_life_years,
    )

#: historical name — `repro.core.carbon.CarbonEstimate` callers keep
#: working; the type gained `model` / `baseline_life_years` tail fields.
CarbonEstimate = LifetimeEstimate


def lifetime_extension(deg_linux: float, deg_technique: float) -> float:
    """Linear lifetime-extension model. Degradations must be >= 0.

    A technique that halted aging entirely within the horizon
    (`deg_technique <= 0`) has a divergent ratio; `MAX_EXTENSION_FACTOR`
    stands in for it. Positive ratios are NOT clamped (only floored at
    `MIN_EXTENSION_FACTOR`) — the pre-subsystem `carbon.estimate` never
    clamped them, and this function is pinned bit-exact against it."""
    if deg_technique <= 0.0:
        return MAX_EXTENSION_FACTOR
    return max(deg_linux / deg_technique, MIN_EXTENSION_FACTOR)


@register_carbon_model("linear-extension")
class LinearExtensionModel(CarbonModel):
    """The paper's linear lifetime-extension model (§2.1):

        extension = deg_ref / deg_technique
        life'     = base_life * extension
        yearly'   = E / life'
        saving    = 1 - yearly'/yearly = 1 - 1/extension

    Bit-exact with the pre-subsystem `repro.core.carbon.estimate`
    (golden-pinned in tests/test_carbon.py).
    """

    def __init__(self, embodied_kg: float = CPU_EMBODIED_KGCO2EQ,
                 base_life_years: float = BASELINE_LIFESPAN_YEARS):
        if embodied_kg <= 0.0 or base_life_years <= 0.0:
            raise ValueError("embodied_kg and base_life_years must be > 0, "
                             f"got {embodied_kg}/{base_life_years}")
        self.embodied_kg = embodied_kg
        self.base_life_years = base_life_years

    def lifetime(self, deg_ref: float,
                 deg_technique: float) -> LifetimeEstimate:
        return _amortize(self.name, lifetime_extension(deg_ref,
                                                       deg_technique),
                         self.embodied_kg, self.base_life_years)


@register_carbon_model("reliability-threshold")
class ReliabilityThresholdModel(CarbonModel):
    """Guardband-crossing lifetime model (paper §2.2).

    A CPU's service life ends when aging-induced frequency degradation
    crosses the design guardband. Both CPUs are observed over the same
    horizon t_obs, and NBTI degradation follows dVth = ADF * t^n, so a
    core's time-to-guardband is t_obs * (D_guard / deg)^(1/n) and the
    ratio of technique to reference life is

        extension = (deg_ref / deg_technique)^(1/n)

    independent of the guardband level itself. The reference CPU is
    defined to exhaust its guardband at the refresh cycle
    (`base_life_years`), anchoring absolute life. With the paper's
    n = 1/6 the extension is ratio^6 — the physics-faithful *optimistic*
    bound, where linear-extension is the conservative one; the cap
    (`max_extension`, default `MAX_EXTENSION_FACTOR`) therefore binds
    often and is part of the reported estimate.
    """

    def __init__(self, embodied_kg: float = CPU_EMBODIED_KGCO2EQ,
                 base_life_years: float = BASELINE_LIFESPAN_YEARS,
                 n: float = NBTI_TIME_EXPONENT,
                 max_extension: float = MAX_EXTENSION_FACTOR):
        if embodied_kg <= 0.0 or base_life_years <= 0.0:
            raise ValueError("embodied_kg and base_life_years must be > 0, "
                             f"got {embodied_kg}/{base_life_years}")
        if not 0.0 < n <= 1.0:
            raise ValueError(f"time exponent n must be in (0, 1], got {n}")
        if max_extension < 1.0:
            raise ValueError(f"max_extension must be >= 1, got "
                             f"{max_extension}")
        self.embodied_kg = embodied_kg
        self.base_life_years = base_life_years
        self.n = n
        self.max_extension = max_extension

    def lifetime(self, deg_ref: float,
                 deg_technique: float) -> LifetimeEstimate:
        if deg_technique <= 0.0:
            ext = self.max_extension
        else:
            ratio = max(deg_ref / deg_technique, MIN_EXTENSION_FACTOR)
            ext = min(ratio ** (1.0 / self.n), self.max_extension)
            ext = max(ext, MIN_EXTENSION_FACTOR)
        return _amortize(self.name, ext, self.embodied_kg,
                         self.base_life_years)


# ------------------------------------------------------------------ #
# Fig.-1-style server power envelope: operational vs embodied carbon of
# an inference server as grid carbon intensity falls (paper Fig. 1).
# ------------------------------------------------------------------ #
SERVER_GPU_TDP_W = 4 * 700.0        # 4x accelerator server (H100-class)
SERVER_OTHER_TDP_W = 800.0          # host CPU/mem/fans
# Accelerator embodied is comparatively small: Li'24 (paper [18]) finds
# the CPU die + mainboard dominate inference-server embodied carbon.
GPU_EMBODIED_KGCO2EQ = 150.0
HOURS_PER_YEAR = 8766.0


@register_carbon_model("operational-embodied")
class OperationalEmbodiedModel(CarbonModel):
    """EcoServe-style total footprint: embodied amortization from a
    wrapped lifetime model plus grid-intensity-priced operational
    carbon.

        operational = served energy [kWh/yr] * mean intensity [g/kWh]
        embodied    = E_cpu / life'(aging)  +  E_gpu / gpu_life

    `intensity` is a `CarbonIntensity` instance or a spec name
    ("constant" / "diurnal" / "trace" / "trace-csv") built with
    `intensity_opts`; `lifetime_model` is any registered lifetime model
    (the embodied axis stays pluggable inside the total)."""

    def __init__(self, intensity="constant", intensity_opts=None,
                 lifetime_model: str = "linear-extension",
                 lifetime_opts=None,
                 utilization: float = 0.6,
                 gpu_tdp_w: float = SERVER_GPU_TDP_W,
                 other_tdp_w: float = SERVER_OTHER_TDP_W,
                 gpu_embodied_kg: float = GPU_EMBODIED_KGCO2EQ,
                 gpu_life_years: float = BASELINE_LIFESPAN_YEARS):
        if not 0.0 <= utilization <= 1.0:
            raise ValueError(f"utilization must be in [0, 1], got "
                             f"{utilization}")
        if gpu_life_years <= 0.0:
            raise ValueError(f"gpu_life_years must be > 0, got "
                             f"{gpu_life_years}")
        self.intensity: CarbonIntensity = get_intensity(
            intensity, **dict(intensity_opts or {}))
        self.lifetime_model: CarbonModel = get_carbon_model(
            lifetime_model, **dict(lifetime_opts or {}))
        self.utilization = utilization
        self.gpu_tdp_w = gpu_tdp_w
        self.other_tdp_w = other_tdp_w
        self.gpu_embodied_kg = gpu_embodied_kg
        self.gpu_life_years = gpu_life_years

    def lifetime(self, deg_ref: float,
                 deg_technique: float) -> LifetimeEstimate:
        return self.lifetime_model.lifetime(deg_ref, deg_technique)

    def footprint(self, deg_ref: float, deg_technique: float,
                  utilization: float | None = None,
                  energy_kwh_per_year: float | None = None
                  ) -> CarbonFootprint:
        """Total yearly footprint. `energy_kwh_per_year` feeds MEASURED
        energy (e.g. an `ExperimentResult`'s power-model accounting,
        annualized) in place of the flat `tdp * utilization` stand-in;
        the stand-in remains the default so existing callers keep their
        exact numbers."""
        if energy_kwh_per_year is None:
            util = self.utilization if utilization is None else utilization
            energy_kwh = (self.gpu_tdp_w + self.other_tdp_w) \
                * util * HOURS_PER_YEAR / 1000.0
        else:
            if energy_kwh_per_year < 0.0:
                raise ValueError(f"energy_kwh_per_year must be >= 0, got "
                                 f"{energy_kwh_per_year}")
            energy_kwh = energy_kwh_per_year
        mean_ci = self.intensity.mean_g_per_kwh()
        operational = energy_kwh * mean_ci / 1000.0
        cpu_embodied = self.lifetime(deg_ref, deg_technique).yearly_kgco2eq
        gpu_embodied = self.gpu_embodied_kg / self.gpu_life_years
        return CarbonFootprint(
            operational_kg=operational,
            cpu_embodied_kg=cpu_embodied,
            gpu_embodied_kg=gpu_embodied,
            total_kg=operational + cpu_embodied + gpu_embodied,
            carbon_intensity_g_per_kwh=mean_ci,
            model=self.name,
        )


# ------------------------------------------------------------------ #
# Convenience functions kept from the pre-subsystem repro.core.carbon
# module (thin wrappers over the registered models).
# ------------------------------------------------------------------ #
def estimate(deg_linux: float, deg_technique: float,
             embodied_kg: float = CPU_EMBODIED_KGCO2EQ,
             base_life_years: float = BASELINE_LIFESPAN_YEARS
             ) -> LifetimeEstimate:
    """The paper's linear model in one call (== `linear-extension`)."""
    return LinearExtensionModel(
        embodied_kg=embodied_kg,
        base_life_years=base_life_years).lifetime(deg_linux, deg_technique)


def cluster_yearly_emissions(
        per_server_estimates: list[LifetimeEstimate]) -> float:
    return sum(e.yearly_kgco2eq for e in per_server_estimates)


def reference_degradation(params, elapsed_s: float) -> float:
    """Worst-case mean frequency degradation of a fresh core (an
    `aging.AgingParams`) aged continuously at active-allocated stress
    for `elapsed_s` — the linear-aging reference the carbon-greedy
    router and the fleet carbon metrics normalize against (stands in
    for the `linux` baseline of `lifetime_extension` within a single
    run)."""
    # Imported lazily: `repro.core` re-exports this package through
    # `repro.core.carbon`, so a module-level import would be circular.
    from repro_torch.core import aging, temperature
    dvth = aging.dvth_after(params, temperature.TEMP_ACTIVE_ALLOCATED_C,
                            temperature.STRESS_ACTIVE,
                            max(elapsed_s, 1e-9))
    return params.f_nominal * dvth / params.headroom


def yearly_footprint(carbon_intensity_g_per_kwh: float,
                     utilization: float = 0.6,
                     cpu_life_years: float = BASELINE_LIFESPAN_YEARS,
                     gpu_life_years: float = BASELINE_LIFESPAN_YEARS) -> dict:
    """Yearly kgCO2eq of one inference server split into operational and
    embodied components (the paper's Fig.-1 composition), as a plain
    dict. Thin wrapper over `operational-embodied` with a constant
    intensity; extended CPU life enters via `cpu_life_years`."""
    model = OperationalEmbodiedModel(
        intensity="constant",
        intensity_opts={"value_g_per_kwh": carbon_intensity_g_per_kwh},
        lifetime_opts={"base_life_years": cpu_life_years},
        utilization=utilization, gpu_life_years=gpu_life_years)
    # equal degradations -> extension 1.0 -> embodied = E / cpu_life
    fp = model.footprint(1.0, 1.0)
    return {
        "carbon_intensity": carbon_intensity_g_per_kwh,
        "operational_kg": fp.operational_kg,
        "cpu_embodied_kg": fp.cpu_embodied_kg,
        "gpu_embodied_kg": fp.gpu_embodied_kg,
        "total_kg": fp.total_kg,
        "cpu_embodied_frac": fp.cpu_embodied_kg / fp.total_kg,
    }
