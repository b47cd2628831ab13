"""String-keyed registry of hardware SKUs — the seventh axis.

    @register_sku("epyc-9554-64c")
    class Epyc9554(HardwareSKU): ...

    sku = get_sku("epyc-9554-64c")
    sku = get_sku("epyc-9554-64c", num_cores=32)

Names are case-insensitive and underscore/hyphen-insensitive, matching
the policy / scenario / router / carbon / power / fault axes. Every
`get_sku` call returns a NEW instance (row opts may override any SKU
field). The mechanics live in the shared `repro.registry.Registry` (one
implementation for all seven axes).
"""
from __future__ import annotations

from repro_torch.hardware.base import HardwareSKU
from repro_torch.registry import Registry, canonical_name

_SKUS = Registry(
    noun="hardware SKU", kind="hardware SKU",
    decorator="register_sku", expects="HardwareSKU subclass",
    check=lambda cls: isinstance(cls, type) and issubclass(cls,
                                                           HardwareSKU),
)
#: module-level alias matching the other axes (tests clean up through it)
_REGISTRY = _SKUS.store


def canonical_sku_name(name: str) -> str:
    """Normalize a user-supplied SKU key ("Epyc_9554_64c" style)."""
    return canonical_name(name)


def register_sku(name: str):
    """Class decorator: register a `HardwareSKU` subclass under `name`."""
    return _SKUS.register(name)


def get_sku(name: str, **opts) -> HardwareSKU:
    """Instantiate the SKU registered under `name` with field overrides."""
    return _SKUS.get(name, **opts)


def available_skus() -> tuple[str, ...]:
    """Sorted canonical names of every registered hardware SKU."""
    return _SKUS.available()
