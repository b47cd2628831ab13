"""Fault injection — the sixth registry axis (the port's copy of
`repro.faults`).

Aging-induced core failures, machine crashes, and transient stalls as
pluggable `FaultModel`s (see `repro_torch.faults.base`), selected per
experiment via `ExperimentConfig.fault_model` / `fault_opts`. The
default `"none"` builds no fault machinery at all and is bit-exact with
pre-fault behavior.
"""
from repro_torch.faults.base import FaultDecision, FaultModel, FaultView
from repro_torch.faults.registry import (
    available_fault_models,
    canonical_fault_model_name,
    get_fault_model,
    register_fault_model,
)

# importing the package registers the built-ins
from repro_torch.faults import models as _models  # noqa: E402,F401

__all__ = [
    "FaultDecision",
    "FaultModel",
    "FaultView",
    "available_fault_models",
    "canonical_fault_model_name",
    "get_fault_model",
    "register_fault_model",
]
