"""String-keyed registry of machine power models.

    @register_power_model("minmax-linear")
    class MinMaxLinearModel(PowerModel): ...

    model = get_power_model("minmax-linear")
    model = get_power_model("minmax-linear", governor="performance")

Names are case-insensitive and underscore/hyphen-insensitive, matching
the policy / scenario / router / carbon axes. Every `get_power_model`
call returns a NEW instance. The mechanics live in the shared
`repro.registry.Registry` (one implementation for all five axes).
"""
from __future__ import annotations

from repro_torch.power.base import PowerModel
from repro_torch.registry import Registry, canonical_name

_MODELS = Registry(
    noun="power model", kind="power model",
    decorator="register_power_model", expects="PowerModel subclass",
    check=lambda cls: isinstance(cls, type) and issubclass(cls,
                                                           PowerModel),
)
#: module-level alias matching the other axes (tests clean up through it)
_REGISTRY = _MODELS.store


def canonical_power_model_name(name: str) -> str:
    """Normalize a user-supplied model key ("MinMax_Linear" style)."""
    return canonical_name(name)


def register_power_model(name: str):
    """Class decorator: register a `PowerModel` subclass under `name`."""
    return _MODELS.register(name)


def get_power_model(name: str, **opts) -> PowerModel:
    """Instantiate the power model registered under `name` with `opts`."""
    return _MODELS.get(name, **opts)


def available_power_models() -> tuple[str, ...]:
    """Sorted canonical names of every registered power model."""
    return _MODELS.available()
