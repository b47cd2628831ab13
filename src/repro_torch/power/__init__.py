"""Machine power models — the fifth pluggable registry axis.

Maps per-core C-state residencies (busy / shallow-idle / gated, plus
settled frequency) to machine watts, energy (kWh), and — priced
against a `CarbonIntensity` — operational gCO2eq. See `base` for the
`PowerModel` protocol, `models` for the built-ins, and `residency`
for the accounting the `CoreManager` keeps in its settle hot path.
"""
from repro_torch.power.base import PowerModel
from repro_torch.power.models import (FittedLinearModel, FlatTdpModel,
                                MinMaxLinearModel, NODE_COEFFS,
                                TdpPerCoreModel)
from repro_torch.power.registry import (available_power_models,
                                  canonical_power_model_name,
                                  get_power_model, register_power_model)
from repro_torch.power.residency import ResidencyAccumulator, StateResidency

__all__ = [
    "PowerModel", "FlatTdpModel", "TdpPerCoreModel", "MinMaxLinearModel",
    "FittedLinearModel", "NODE_COEFFS", "ResidencyAccumulator",
    "StateResidency", "available_power_models",
    "canonical_power_model_name", "get_power_model",
    "register_power_model",
]
