"""Compatibility re-export: carbon accounting moved to `repro_torch.carbon`.

The single hard-coded linear lifetime-extension formula that lived here
is now the `linear-extension` model in the pluggable `repro_torch.carbon`
subsystem (bit-exact, golden-pinned in tests/test_carbon.py), alongside
a reliability-threshold lifetime model and an EcoServe-style
operational+embodied footprint model driven by grid `CarbonIntensity`
signals. New code should do:

    from repro_torch.carbon import get_carbon_model
    est = get_carbon_model("linear-extension").lifetime(deg_ref, deg_tech)

`carbon.estimate` / `CarbonEstimate` / `yearly_footprint` keep working
through this module unchanged.
"""
from __future__ import annotations

from repro_torch.carbon.base import (BASELINE_LIFESPAN_YEARS,
                               CPU_EMBODIED_KGCO2EQ, MAX_EXTENSION_FACTOR,
                               MIN_EXTENSION_FACTOR)
from repro_torch.carbon.models import (CarbonEstimate, GPU_EMBODIED_KGCO2EQ,
                                 HOURS_PER_YEAR, SERVER_GPU_TDP_W,
                                 SERVER_OTHER_TDP_W,
                                 cluster_yearly_emissions, estimate,
                                 lifetime_extension, reference_degradation,
                                 yearly_footprint)

__all__ = [
    "BASELINE_LIFESPAN_YEARS", "CPU_EMBODIED_KGCO2EQ",
    "MAX_EXTENSION_FACTOR", "MIN_EXTENSION_FACTOR", "CarbonEstimate",
    "GPU_EMBODIED_KGCO2EQ", "HOURS_PER_YEAR", "SERVER_GPU_TDP_W",
    "SERVER_OTHER_TDP_W", "cluster_yearly_emissions", "estimate",
    "lifetime_extension", "reference_degradation", "yearly_footprint",
]
