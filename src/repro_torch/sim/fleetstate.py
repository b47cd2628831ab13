"""Fleet-batched NBTI aging settlement (the counterpart of
`repro.sim.fleetstate`).

The cluster's periodic tick used to settle each machine's cores through
its own `CoreManager.settle_all` — 22 sequential numpy dispatch chains
per second of simulated time. `FleetAgingSettler` stacks every
machine's per-core state into one `(n_machines, n_cores)` batch and
advances all of it through a single `advance_dvth` call, then scatters
the settled shifts back into the managers.

Backends:

  numpy  — default; bit-identical to calling `settle_all` per machine
           (elementwise float64 math over a stacked array), so the serial
           simulation stays golden-exact.
  torch  — the counterpart of the reference's `jax` backend: routes the
           stacked batch through the aging kernel
           (`repro_torch.kernels.aging_update`, float32) on `device`,
           which is the hand-written CUDA kernel on a card and its plain
           PyTorch version on the CPU. NOT bit-exact with the float64
           numpy path — for analytics sweeps and kernel-backed runs, not
           for golden-pinned experiments.
  auto   — torch, as the port's fleet engine resolves it.

Managers must be homogeneous (same `AgingParams`, same core count) —
exactly what a `Cluster` builds.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import aging, temperature
from repro_torch.kernels.aging_update.ops import advance_fleet

_BACKENDS = ("numpy", "torch", "auto")


class FleetAgingSettler:
    """Settles a fleet of `CoreManager`s to a common timestamp in one
    batched dVth advance (the paper's hot loop, fleet-vectorized).

    `device` places the torch backend (default "cuda"; "cpu" runs the
    kernel's plain version); it raises when CUDA is asked for and absent.
    """

    def __init__(self, managers, backend: str = "numpy", device=None):
        if backend not in _BACKENDS:
            raise ValueError(f"unknown fleetstate backend {backend!r}; "
                             f"expected one of {_BACKENDS}")
        managers = list(managers)
        if not managers:
            raise ValueError("FleetAgingSettler needs at least one manager")
        params = managers[0].params
        n = managers[0].num_cores
        for m in managers[1:]:
            if m.params != params or m.num_cores != n:
                raise ValueError(
                    "FleetAgingSettler requires homogeneous managers "
                    "(same AgingParams and num_cores)")
        self.managers = managers
        self.params = params
        self.num_cores = n
        if backend == "auto":
            backend = "torch"
        self.backend = backend
        self.device = None
        if backend == "torch":
            self.device = torch.device("cuda" if device is None else device)
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    "the torch fleetstate backend runs on device "
                    f"{str(self.device)!r} but CUDA is not available; pass "
                    "device='cpu' to run it on the CPU")
        elif device is not None:
            raise ValueError(f"device={device!r} applies to the torch "
                             f"backend only, not {backend!r}")

    # ------------------------------------------------------------------ #
    def _gather(self, now: float):
        """Stack per-machine state into (M, N) regime arrays (regimes
        derived through the same `temperature.regime_arrays` helper the
        per-machine settle path uses, so the two can never drift)."""
        ms = self.managers
        dvth = np.stack([m.dvth for m in ms])
        tau = now - np.stack([m.last_update for m in ms])
        cs = np.stack([m.c_state for m in ms])
        alloc = np.stack([m.task_of_core for m in ms]) >= 0
        temps, stress = temperature.regime_arrays(cs, alloc)
        return dvth, temps, stress, np.maximum(tau, 0.0)

    def _scatter(self, new_dvth: np.ndarray, now: float) -> None:
        for k, m in enumerate(self.managers):
            m.dvth[:] = new_dvth[k]
            np.maximum(m.last_update, now, out=m.last_update)
            if now > m.now:
                m.now = now

    # ------------------------------------------------------------------ #
    def settle(self, now: float) -> None:
        """Advance every machine's every core to `now` under its current
        regime. Equivalent to `for m in managers: m.settle_all(now)`
        (bit-identical on the numpy backend), one batched call."""
        dvth, temps, stress, tau = self._gather(now)
        if not (tau > 0.0).any():
            for m in self.managers:
                if now > m.now:
                    m.now = now
            return
        if self.backend == "torch":
            new = self._advance_torch(dvth, temps, stress, tau)
        else:
            adf_vals = aging.adf(self.params, temps, stress)
            new = aging.advance_dvth(self.params, dvth, adf_vals, tau)
        self._scatter(new, now)

    def _advance_torch(self, dvth, temps, stress, tau) -> np.ndarray:
        """Flatten the (M, N) batch into contiguous float32 tensors on the
        device, advance it through the aging kernel, and come back as
        float64 numpy (the counterpart of the reference's
        `_advance_jax`)."""
        shape = dvth.shape
        dev = self.device
        out = advance_fleet(*(torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.float32).ravel()).to(dev)
            for a in (dvth, temps, stress, tau)), self.params)
        return out.cpu().numpy().astype(np.float64).reshape(shape)


class GroupedAgingSettler:
    """Heterogeneous-fleet settler: groups managers by `(AgingParams,
    num_cores)` and runs one `FleetAgingSettler` per homogeneous group.

    Mixed fleets (`repro_torch.hardware`) build machines with per-SKU core
    counts and aging parameters, so one stacked batch no longer fits;
    each group still advances through a single batched call, and every
    group is bit-identical to its machines settling individually.
    """

    def __init__(self, managers, backend: str = "numpy", device=None):
        managers = list(managers)
        if not managers:
            raise ValueError("GroupedAgingSettler needs at least one "
                             "manager")
        groups: dict[tuple, list] = {}
        for m in managers:
            groups.setdefault((m.params, m.num_cores), []).append(m)
        self.settlers = [FleetAgingSettler(g, backend=backend, device=device)
                         for g in groups.values()]
        self.managers = managers
        # all groups resolve "auto" identically; surface the first
        self.backend = self.settlers[0].backend

    def settle(self, now: float) -> None:
        for s in self.settlers:
            s.settle(now)


def settle_fleet(managers, now: float, backend: str = "numpy") -> None:
    """One-shot convenience wrapper around `FleetAgingSettler`."""
    FleetAgingSettler(managers, backend=backend).settle(now)
