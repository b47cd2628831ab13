"""String-keyed registry of core-management policies.

    @register_policy("proposed")
    class ProposedPolicy(CorePolicy): ...

    policy = get_policy("proposed")            # fresh instance
    policy = get_policy("linux", stickiness=0.5)

Names are case-insensitive and underscore/hyphen-insensitive, so
"least-aged", "least_aged" and "LEAST_AGED" all resolve to the same
policy. Every `get_policy` call returns a NEW instance: policies carry
per-server state and must not be shared across managers.

The mechanics live in the shared `repro_torch.registry.Registry` (one
implementation for the policy / scenario / router axes).
"""
from __future__ import annotations

from repro_torch.core.policies.base import CorePolicy
from repro_torch.registry import Registry, canonical_name

_POLICIES = Registry(
    noun="policy", kind="core policy", decorator="register_policy",
    expects="CorePolicy subclass",
    check=lambda cls: isinstance(cls, type) and issubclass(cls, CorePolicy),
)
#: historical module-level alias (tests clean up through it)
_REGISTRY = _POLICIES.store


def canonical_policy_name(name: str) -> str:
    """Normalize a user-supplied policy key ("least_aged" -> "least-aged")."""
    return canonical_name(name)


def register_policy(name: str):
    """Class decorator: register a `CorePolicy` subclass under `name`."""
    return _POLICIES.register(name)


def get_policy(name: str, **opts) -> CorePolicy:
    """Instantiate the policy registered under `name` with `opts`."""
    return _POLICIES.get(name, **opts)


def available_policies() -> tuple[str, ...]:
    """Sorted canonical names of every registered policy."""
    return _POLICIES.available()
