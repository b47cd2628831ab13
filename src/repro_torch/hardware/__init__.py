"""Heterogeneous hardware — the seventh registry axis.

Per-SKU fleet inventory: `HardwareSKU` describes one CPU model (cores,
TDP, process distribution, generation, Boavizta-style embodied impact;
see `repro.hardware.base`), the shared-`Registry` catalog makes SKUs
selectable by name, and `FleetInventory` expands
`ExperimentConfig.fleet` / `fleet_opts` into per-machine hardware. The
default `"uniform"` fleet resolves to None and builds no heterogeneity
machinery at all — bit-exact and fingerprint-invisible vs the
pre-hardware simulator.
"""
from repro_torch.hardware.base import (CPU_IMPACT_KGCO2EQ, HardwareSKU,
                                 REFERENCE_CPU_TDP_W, embodied_carbon,
                                 get_cpu_impact)
from repro_torch.hardware.inventory import (FleetInventory, canonical_fleet_name,
                                      resolve_fleet, sku_carbon_model)
from repro_torch.hardware.registry import (
    available_skus,
    canonical_sku_name,
    get_sku,
    register_sku,
)

# importing the package registers the built-in catalog
from repro_torch.hardware import skus as _skus  # noqa: E402,F401

__all__ = [
    "CPU_IMPACT_KGCO2EQ",
    "FleetInventory",
    "HardwareSKU",
    "REFERENCE_CPU_TDP_W",
    "available_skus",
    "canonical_fleet_name",
    "canonical_sku_name",
    "embodied_carbon",
    "get_cpu_impact",
    "get_sku",
    "register_sku",
    "resolve_fleet",
    "sku_carbon_model",
]
