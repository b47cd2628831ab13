"""String-keyed registry of carbon-accounting models.

    @register_carbon_model("linear-extension")
    class LinearExtensionModel(CarbonModel): ...

    model = get_carbon_model("linear-extension")
    model = get_carbon_model("reliability-threshold", max_extension=20.0)

Names are case-insensitive and underscore/hyphen-insensitive, matching
the policy / scenario / router axes. Every `get_carbon_model` call
returns a NEW instance. The mechanics live in the shared
`repro.registry.Registry` (one implementation for all five axes).
"""
from __future__ import annotations

from repro_torch.carbon.base import CarbonModel
from repro_torch.registry import Registry, canonical_name

_MODELS = Registry(
    noun="carbon model", kind="carbon model",
    decorator="register_carbon_model", expects="CarbonModel subclass",
    check=lambda cls: isinstance(cls, type) and issubclass(cls,
                                                           CarbonModel),
)
#: module-level alias matching the other axes (tests clean up through it)
_REGISTRY = _MODELS.store


def canonical_carbon_model_name(name: str) -> str:
    """Normalize a user-supplied model key ("Linear_Extension" style)."""
    return canonical_name(name)


def register_carbon_model(name: str):
    """Class decorator: register a `CarbonModel` subclass under `name`."""
    return _MODELS.register(name)


def get_carbon_model(name: str, **opts) -> CarbonModel:
    """Instantiate the carbon model registered under `name` with `opts`."""
    return _MODELS.get(name, **opts)


def available_carbon_models() -> tuple[str, ...]:
    """Sorted canonical names of every registered carbon model."""
    return _MODELS.available()
