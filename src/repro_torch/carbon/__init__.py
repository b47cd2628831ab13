"""Pluggable carbon-accounting subsystem (paper §2, §6.2 Fig. 7).

The fourth experiment axis, mirroring `repro.core.policies`,
`repro.workloads` and `repro.sim.routing`: a string-keyed registry of
`CarbonModel`s that turn observed aging into lifetime and footprint
estimates.

    from repro_torch.carbon import get_carbon_model, available_carbon_models

    est = get_carbon_model("linear-extension").lifetime(0.02, 0.01)
    est.extension_factor, est.yearly_kgco2eq, est.reduction_frac

    fp = get_carbon_model(
        "operational-embodied",
        intensity="diurnal", intensity_opts={"mean": 120.0},
    ).footprint(0.02, 0.01)
    fp.operational_kg, fp.cpu_embodied_kg, fp.embodied_frac

Experiments select models by name — `ExperimentConfig(carbon_model=...,
carbon_opts=...)` — and `run_experiment` prices every machine's
embodied carbon through the configured model. Custom models register
like policies:

    from repro_torch.carbon import CarbonModel, register_carbon_model

    @register_carbon_model("my-model")
    class MyModel(CarbonModel):
        def lifetime(self, deg_ref, deg_technique): ...
"""
from repro_torch.carbon import intensity
from repro_torch.carbon.base import (BASELINE_LIFESPAN_YEARS, CPU_EMBODIED_KGCO2EQ,
                               CarbonFootprint, CarbonModel,
                               LifetimeEstimate, MAX_EXTENSION_FACTOR,
                               MIN_EXTENSION_FACTOR)
from repro_torch.carbon.intensity import (CarbonIntensity, ConstantIntensity,
                                    DiurnalIntensity, ShiftedIntensity,
                                    TraceIntensity, WORLD_AVG_G_PER_KWH,
                                    get_intensity)
# Importing the module registers the built-in model library.
from repro_torch.carbon.models import (CarbonEstimate, GPU_EMBODIED_KGCO2EQ,
                                 HOURS_PER_YEAR, LinearExtensionModel,
                                 NBTI_TIME_EXPONENT,
                                 OperationalEmbodiedModel,
                                 ReliabilityThresholdModel,
                                 SERVER_GPU_TDP_W, SERVER_OTHER_TDP_W,
                                 cluster_yearly_emissions, estimate,
                                 lifetime_extension, reference_degradation,
                                 yearly_footprint)
from repro_torch.carbon.registry import (available_carbon_models,
                                   canonical_carbon_model_name,
                                   get_carbon_model, register_carbon_model)

__all__ = [
    "BASELINE_LIFESPAN_YEARS", "CPU_EMBODIED_KGCO2EQ",
    "MAX_EXTENSION_FACTOR", "MIN_EXTENSION_FACTOR",
    "CarbonEstimate", "CarbonFootprint", "CarbonIntensity", "CarbonModel",
    "ConstantIntensity", "DiurnalIntensity", "ShiftedIntensity",
    "TraceIntensity",
    "LifetimeEstimate", "LinearExtensionModel", "OperationalEmbodiedModel",
    "ReliabilityThresholdModel", "WORLD_AVG_G_PER_KWH",
    "GPU_EMBODIED_KGCO2EQ", "HOURS_PER_YEAR", "NBTI_TIME_EXPONENT",
    "SERVER_GPU_TDP_W",
    "SERVER_OTHER_TDP_W", "available_carbon_models",
    "canonical_carbon_model_name", "cluster_yearly_emissions", "estimate",
    "get_carbon_model", "get_intensity", "intensity", "lifetime_extension",
    "reference_degradation", "register_carbon_model", "yearly_footprint",
]
