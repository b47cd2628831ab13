"""Generic string-keyed registry shared by the five pluggable axes.

`repro.core.policies`, `repro.workloads` and `repro.sim.routing`
deliberately mirror each other: canonical-name normalization, a
registering decorator, `get_*` instantiation and `available_*` listing.
This module holds the one implementation they all wrap, so the axes
cannot drift apart. Error messages are parameterized because the
per-axis wordings are test-pinned ("unknown core policy ...", "unknown
workload scenario ...", "unknown cluster router ...") and must stay
byte-identical.

    _policies = Registry(noun="policy", kind="core policy",
                         decorator="register_policy",
                         expects="CorePolicy subclass",
                         check=lambda c: isinstance(c, type)
                         and issubclass(c, CorePolicy))
    register_policy = _policies.register
    get_policy = _policies.get
"""
from __future__ import annotations

from typing import Any, Callable


def canonical_name(name: str) -> str:
    """Normalize a user-supplied registry key: case-insensitive and
    underscore/hyphen-insensitive ("Least_Aged" -> "least-aged")."""
    return str(name).strip().lower().replace("_", "-")


class Registry:
    """One pluggable axis: decorator registration + name-keyed lookup.

    Args:
      noun:       short kind used in duplicate-name errors ("policy").
      kind:       full kind used in unknown-name errors ("core policy").
      decorator:  public decorator name for registration-type errors
                  ("register_policy").
      expects:    what the decorator accepts ("CorePolicy subclass",
                  "callable factory").
      check:      predicate validating a registered entry.
      set_name:   assign the canonical key to `entry.name` (class
                  registries do; factory registries don't).
      quote_prev: duplicate-name errors show the previous entry repr'd
                  (the scenario registry's historical wording) instead
                  of its bare `__name__`.
      post_get:   optional hook validating/transforming `get` results,
                  called as post_get(key, obj).
    """

    def __init__(self, *, noun: str, kind: str, decorator: str,
                 expects: str, check: Callable[[Any], bool],
                 set_name: bool = True, quote_prev: bool = False,
                 post_get: Callable[[str, Any], Any] | None = None):
        self.noun = noun
        self.kind = kind
        self.decorator = decorator
        self.expects = expects
        self.check = check
        self.set_name = set_name
        self.quote_prev = quote_prev
        self.post_get = post_get
        # Plain dict so axis modules can alias it as their historical
        # module-level `_REGISTRY` (tests reach in to clean up).
        self.store: dict[str, Any] = {}

    # ------------------------------------------------------------------ #
    def register(self, name: str):
        """Decorator: register an entry under `name`."""
        key = canonical_name(name)

        def deco(entry):
            if not self.check(entry):
                raise TypeError(f"@{self.decorator}({name!r}) expects a "
                                f"{self.expects}, got {entry!r}")
            prev = self.store.get(key)
            if prev is not None and prev is not entry:
                prev_desc = (repr(getattr(prev, "__name__", prev))
                             if self.quote_prev else prev.__name__)
                raise ValueError(f"{self.noun} name {key!r} already "
                                 f"registered to {prev_desc}")
            if self.set_name:
                entry.name = key
            self.store[key] = entry
            return entry

        return deco

    def get(self, name: str, **opts):
        """Instantiate/build the entry registered under `name`."""
        key = canonical_name(name)
        try:
            entry = self.store[key]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} {name!r}; available: "
                f"{', '.join(self.available())}") from None
        obj = entry(**opts)
        if self.post_get is not None:
            obj = self.post_get(key, obj)
        return obj

    def available(self) -> tuple[str, ...]:
        """Sorted canonical names of every registered entry."""
        return tuple(sorted(self.store))
