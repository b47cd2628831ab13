"""Fault-model protocol: aging-induced failures as a pluggable axis
(the port's copy of `repro.faults.base`).

The paper's argument is that extending CPU lifetime is only safe if the
*reliability* consequences of silicon aging are managed — guardband
violations, degraded cores, machine loss. This module defines the
contract a fault model implements so those consequences can actually
occur at runtime:

  * `FaultModel.periodic(view)` runs once per idling period per machine
    and returns a `FaultDecision` (cores to fail, cores to stall, or a
    machine crash) or `None`.
  * `FaultView` is the read-only window the model judges from — the
    machine's settled aging state, which cores already failed, whether
    the machine is up, and the fault axis' own seeded RNG stream.

Models are registered under `repro_torch.faults.registry` (the sixth
registry axis) and instantiated per machine, mirroring how `CorePolicy`
instances are per-server. The handling of a decision — offlining cores,
migrating in-flight work, crash/reboot orchestration, request retries —
lives in the engines (`repro_torch.sim.cluster.FaultCoordinator` for the
event loop, `repro_torch.sim.fleetsim` vectorized), never in the model
itself.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np


@dataclasses.dataclass(frozen=True)
class FaultDecision:
    """What a fault model wants to happen this period on one machine.

    `fail_cores` offline cores permanently (guardband violation);
    `stall_cores` slow cores to `stall_factor` x their settled speed for
    `stall_s` seconds; `crash=True` takes the whole machine down for a
    deterministic `reboot_s` window. A default-constructed decision is
    a no-op (models normally return `None` instead)."""

    fail_cores: tuple[int, ...] = ()
    stall_cores: tuple[int, ...] = ()
    stall_factor: float = 1.0
    stall_s: float = 0.0
    crash: bool = False
    reboot_s: float = 0.0

    def __bool__(self) -> bool:
        return bool(self.fail_cores or self.stall_cores or self.crash)


class FaultView:
    """Read-only per-machine window for fault models.

    Mirrors `CoreView`/`FleetView` one axis over: the model reads the
    machine's *settled* aging state (pure — `CoreManager._settled_dvth`
    never mutates) plus its own seeded RNG stream, and returns decisions
    instead of mutating anything.
    """

    __slots__ = ("_machine", "_rng", "period_s")

    def __init__(self, machine, rng: np.random.Generator, period_s: float):
        self._machine = machine
        self._rng = rng
        self.period_s = float(period_s)

    @property
    def machine_id(self) -> int:
        return self._machine.machine_id

    @property
    def now(self) -> float:
        return self._machine.queue.now

    @property
    def num_cores(self) -> int:
        return self._machine.manager.num_cores

    @property
    def rng(self) -> np.random.Generator:
        """The fault axis' own per-machine RNG stream (never shared with
        the manager or router streams, so adding faults cannot perturb
        their draws)."""
        return self._rng

    @property
    def up(self) -> bool:
        """Whether the machine is powered (False during a reboot window)."""
        return getattr(self._machine, "up", True)

    @property
    def failed_mask(self) -> np.ndarray:
        """(num_cores,) bool — cores already permanently offlined."""
        m = self._machine.manager.failed
        v = m.view()
        v.flags.writeable = False
        return v

    def degradation(self) -> np.ndarray:
        """(num_cores,) fractional guardband consumption at `now`:
        settled dVth / headroom, i.e. the fraction of the frequency
        guardband each core's NBTI shift has eaten (pure read)."""
        mgr = self._machine.manager
        return mgr._settled_dvth(self.now) / mgr.params.headroom

    def frequencies(self) -> np.ndarray:
        """(num_cores,) settled frequency factors at `now` (pure read)."""
        from repro_torch.core import aging
        mgr = self._machine.manager
        return aging.frequency(mgr.params, mgr.f0,
                               mgr._settled_dvth(self.now))


class FaultModel:
    """Base class for fault-injection models (the sixth registry axis).

    Subclasses register with `@register_fault_model(name)` and are
    instantiated once per machine via `get_fault_model(name, **opts)` —
    they may carry per-machine state (e.g. a pre-drawn next crash time).
    """

    #: canonical registry key, set by @register_fault_model
    name: ClassVar[str] = "?"

    def periodic(self, view: FaultView) -> FaultDecision | None:
        """Called once per idling period; return what should fail (or
        `None`). RNG draws must come from `view.rng` only."""
        return None

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"
