"""NBTI reaction-diffusion aging model (paper §3.2).

Implements the paper's aging physics:

  f(t)        = f0 * (1 - dVth / (Vdd - Vth))                       (Eq. 1)
  dVth(t_p)   = ADF_p * [ (dVth(t_{p-1}) / ADF_p)^(1/n) + tau_p ]^n
  ADF(T,V,Y)  = K * exp(-E0 / (kB*T)) * exp(C_field*Vdd / (kB*T)) * Y^n  (Eq. 2)

where the recursive dVth update lets a core move through intervals with
different ADFs (different temperatures / stress levels / idle states) while
accumulating a single threshold-voltage shift.  Deep idle (C6) power-gates
the core: no transistor switching, stress Y = 0, and the shift is frozen.

`K` is a fitting parameter calibrated exactly as the paper describes: for
22nm technology the worst-case 10-year frequency reduction is 30% [Ansari
'23], so we solve dVth(10yr, T=54C, Y=1) = 0.3 * (Vdd - Vth) for K.

Everything is provided in three flavours:
  * scalar / numpy  — the simulator fast path (per-event, per-core),
  * jnp             — vectorized fleet analytics, the Pallas kernel oracle,
  * the Pallas kernel itself lives in repro/kernels/aging_update.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

SECONDS_PER_YEAR = 365.25 * 24 * 3600.0
TEN_YEARS_S = 10.0 * SECONDS_PER_YEAR


@dataclasses.dataclass(frozen=True)
class AgingParams:
    """Physical constants of the NBTI model (22nm-class, see DESIGN.md)."""

    n: float = 1.0 / 6.0          # reaction-diffusion time exponent
    kB: float = 8.617333e-5       # Boltzmann constant [eV/K]
    E0: float = 0.1897            # activation energy [eV]
    c_field: float = 0.075        # B/tox folded field coefficient [eV/V]
    vdd: float = 1.0              # supply voltage [V]
    vth: float = 0.45             # nominal threshold voltage [V]
    f_nominal: float = 1.0        # normalized nominal max frequency
    worst_case_temp_c: float = 54.0       # Table 1: C0 + allocated task
    worst_case_lifetime_red: float = 0.30  # 30% freq drop @ 10 years
    K: float = dataclasses.field(default=0.0)  # fitting parameter, solved

    @property
    def headroom(self) -> float:
        """Vdd - Vth, the denominator of Eq. 1."""
        return self.vdd - self.vth


def _adf_unscaled(params: AgingParams, temp_c: float, stress: float) -> float:
    """ADF / K — everything in Eq. 2 except the fitting parameter."""
    if stress <= 0.0:
        return 0.0
    t_k = temp_c + 273.15
    return (
        math.exp(-params.E0 / (params.kB * t_k))
        * math.exp(params.c_field * params.vdd / (params.kB * t_k))
        * stress ** params.n
    )


# exp() factors per (params, T, Y) — the simulator only ever sees the
# three Table-1 regimes, so this stays tiny. Keyed on the frozen params
# value (hashable dataclass), NOT id(params): a GC'd-and-reused id could
# otherwise serve stale factors for new params.
_ADF_UNSCALED_CACHE: dict[tuple[AgingParams, float, float], float] = {}


def adf_unscaled_cached(params: AgingParams, temp_c: float,
                        stress: float) -> float:
    """Memoized `_adf_unscaled` — the event-loop fast path (`CoreManager`
    settles a core's regime on every assign/release)."""
    key = (params, temp_c, stress)
    v = _ADF_UNSCALED_CACHE.get(key)
    if v is None:
        v = _adf_unscaled(params, temp_c, stress)
        _ADF_UNSCALED_CACHE[key] = v
    return v


def solve_k(params: AgingParams) -> AgingParams:
    """Calibrate K so worst-case 10-year aging costs 30% of frequency.

    From a fresh core, dVth(t) = ADF * t^n, so
        K = dVth_target / (adf_unscaled * t^n).
    """
    target_dvth = params.worst_case_lifetime_red * params.headroom
    base = _adf_unscaled(params, params.worst_case_temp_c, 1.0)
    k = target_dvth / (base * TEN_YEARS_S ** params.n)
    return dataclasses.replace(params, K=k)


DEFAULT_PARAMS = solve_k(AgingParams())


def adf(params: AgingParams, temp_c, stress):
    """Aging-degradation factor (Eq. 2). Vectorized over numpy inputs.

    stress == 0 (deep idle) yields ADF == 0, which `advance_dvth`
    interprets as "aging halted".
    """
    temp_c = np.asarray(temp_c, dtype=np.float64)
    stress = np.asarray(stress, dtype=np.float64)
    t_k = temp_c + 273.15
    out = (
        params.K
        * np.exp(-params.E0 / (params.kB * t_k))
        * np.exp(params.c_field * params.vdd / (params.kB * t_k))
        * np.where(stress > 0.0, stress, 1.0) ** params.n
    )
    return np.where(stress > 0.0, out, 0.0)


def advance_dvth(params: AgingParams, dvth, adf_value, tau):
    """One step of the recursive dVth update (paper §3.2).

    dVth' = ADF * [ (dVth/ADF)^(1/n) + tau ]^n;  ADF == 0 freezes dVth.
    Vectorized over numpy arrays; `tau` in seconds.
    """
    dvth = np.asarray(dvth, dtype=np.float64)
    adf_value = np.asarray(adf_value, dtype=np.float64)
    tau = np.asarray(tau, dtype=np.float64)
    safe_adf = np.where(adf_value > 0.0, adf_value, 1.0)
    eff_time = (dvth / safe_adf) ** (1.0 / params.n)  # equivalent stress time
    new = safe_adf * (eff_time + tau) ** params.n
    return np.where((adf_value > 0.0) & (tau > 0.0), new, dvth)


def advance_dvth_scalar(params: AgingParams, dvth: float, adf_value: float,
                        tau: float) -> float:
    """Scalar fast path for the event loop (avoids numpy dispatch)."""
    if adf_value <= 0.0 or tau <= 0.0:
        return dvth
    eff_time = (dvth / adf_value) ** (1.0 / params.n)
    return adf_value * (eff_time + tau) ** params.n


def frequency(params: AgingParams, f0, dvth):
    """Eq. 1 — degraded max frequency given threshold-voltage shift."""
    return np.asarray(f0) * (1.0 - np.asarray(dvth) / params.headroom)


def frequency_scalar(params: AgingParams, f0: float, dvth: float) -> float:
    return f0 * (1.0 - dvth / params.headroom)


def dvth_after(params: AgingParams, temp_c: float, stress: float,
               duration_s: float, dvth0: float = 0.0) -> float:
    """Convenience: shift after `duration_s` at constant (T, Y)."""
    a = float(adf(params, temp_c, stress))
    return advance_dvth_scalar(params, dvth0, a, duration_s)
