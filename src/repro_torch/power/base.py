"""PowerModel protocol: per-core state residencies -> machine watts.

A power model prices one machine's draw from the fractions of core-time
spent busy / shallow-idle / gated (see `residency.StateResidency`),
plus the busy-time-weighted mean settled frequency factor (the aging
technique slows cores down, which genuinely changes dynamic power).

The protocol deliberately works on *fractions within a time window*,
not instantaneous core sets: energy is the windowed integral
`sum_w P(fracs_w) * elapsed_w`, and operational carbon prices each
window at the grid intensity of its midpoint — the temporal coupling
that makes carbon-aware deferral measurable instead of cosmetic.

Subclasses implement `machine_power_w`; `energy_kwh`,
`operational_g`, and `marginal_task_w` have generic defaults.
"""
from __future__ import annotations

from repro_torch.carbon.intensity import CarbonIntensity
from repro_torch.power.residency import StateResidency

_J_PER_KWH = 3.6e6


class PowerModel:
    """Base class for machine power models (the fifth registry axis).

    Constructor kwargs come from `ExperimentConfig.power_opts` via
    `get_power_model(name, **opts)`, so every option must have a
    sensible default.
    """

    name = "base"

    def machine_power_w(self, busy_frac: float, idle_frac: float,
                        gated_frac: float, mean_busy_freq: float,
                        num_cores: int) -> float:
        """Instantaneous machine draw (W) given core-state fractions.

        `busy_frac + idle_frac + gated_frac == 1`; `mean_busy_freq` is
        the settled frequency factor (nominal 1.0) of the busy cores.
        """
        raise NotImplementedError

    def energy_kwh(self, residency: StateResidency) -> float:
        """Machine energy (kWh) over the residency horizon: windowed
        integral of `machine_power_w`."""
        f = residency.mean_busy_frequency
        n = residency.num_cores
        joules = 0.0
        for _, elapsed, bf, if_, gf in residency.iter_windows():
            joules += self.machine_power_w(bf, if_, gf, f, n) * elapsed
        return joules / _J_PER_KWH

    def operational_g(self, residency: StateResidency,
                      intensity: CarbonIntensity,
                      t0: float = 0.0) -> float:
        """Operational carbon (gCO2eq) over the horizon: each residency
        window's energy priced at the grid intensity of its midpoint
        (`t0` offsets simulation time into intensity time)."""
        f = residency.mean_busy_frequency
        n = residency.num_cores
        grams = 0.0
        for t_start, elapsed, bf, if_, gf in residency.iter_windows():
            kwh = (self.machine_power_w(bf, if_, gf, f, n) * elapsed
                   / _J_PER_KWH)
            grams += kwh * intensity.g_per_kwh(t0 + t_start + 0.5 * elapsed)
        return grams

    def marginal_task_w(self, mean_busy_freq: float,
                        num_cores: int) -> float:
        """Extra draw (W) of running one more core busy instead of
        shallow-idle — the per-task operational signal routers score.
        Zero for residency-blind models like `flat-tdp`."""
        full = self.machine_power_w(1.0, 0.0, 0.0, mean_busy_freq,
                                    num_cores)
        idle = self.machine_power_w(0.0, 1.0, 0.0, mean_busy_freq,
                                    num_cores)
        return (full - idle) / num_cores

    def describe(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"
