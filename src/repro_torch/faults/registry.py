"""String-keyed registry of fault-injection models — the sixth axis
(the port's copy of `repro.faults.registry`).

    @register_fault_model("guardband")
    class GuardbandFaults(FaultModel): ...

    model = get_fault_model("guardband")
    model = get_fault_model("guardband", margin=0.02)

Names are case-insensitive and underscore/hyphen-insensitive, matching
the policy / scenario / router / carbon / power axes. Every
`get_fault_model` call returns a NEW instance (models carry per-machine
state). The mechanics live in the shared
`repro_torch.registry.Registry` (one implementation for all six axes).
"""
from __future__ import annotations

from repro_torch.faults.base import FaultModel
from repro_torch.registry import Registry, canonical_name

_MODELS = Registry(
    noun="fault model", kind="fault model",
    decorator="register_fault_model", expects="FaultModel subclass",
    check=lambda cls: isinstance(cls, type) and issubclass(cls,
                                                           FaultModel),
)
#: module-level alias matching the other axes (tests clean up through it)
_REGISTRY = _MODELS.store


def canonical_fault_model_name(name: str) -> str:
    """Normalize a user-supplied model key ("Machine_Crash" style)."""
    return canonical_name(name)


def register_fault_model(name: str):
    """Class decorator: register a `FaultModel` subclass under `name`."""
    return _MODELS.register(name)


def get_fault_model(name: str, **opts) -> FaultModel:
    """Instantiate the fault model registered under `name` with `opts`."""
    return _MODELS.get(name, **opts)


def available_fault_models() -> tuple[str, ...]:
    """Sorted canonical names of every registered fault model."""
    return _MODELS.available()
