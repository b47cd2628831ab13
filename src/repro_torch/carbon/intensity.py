"""Grid carbon-intensity signals — the *when is the grid dirty* layer.

Mirrors `repro.workloads.arrivals` on the carbon axis: small composable
dataclasses, each answering `g_per_kwh(t_s)` (instantaneous gCO2eq per
kWh at time `t_s`) and `mean_g_per_kwh()` (the time-weighted mean an
amortized yearly estimate should price in). The
`operational-embodied` carbon model consumes one of these to turn
served energy into operational carbon; EcoLogits-style range reporting
falls out of evaluating the same experiment under several signals.

Built-in shapes:

  constant — one fixed intensity (world-average grid by default)
  diurnal  — sinusoidal day/night swing around a mean (solar-heavy
             grids dip mid-day; mirrors `DiurnalPoissonArrivals`)
  trace    — step-held samples from a CSV (`time_s,g_per_kwh`), looped
             cyclically so a one-day trace can price a full year
"""
from __future__ import annotations

import csv
import dataclasses
import io
import math

#: world-average grid intensity, gCO2eq/kWh (Ember 2023, the value the
#: paper's Fig. 1 uses for the "grid" column)
WORLD_AVG_G_PER_KWH = 436.0


class CarbonIntensity:
    """Base class: an intensity signal over simulation/wall time."""

    def g_per_kwh(self, t_s: float) -> float:
        raise NotImplementedError

    def mean_g_per_kwh(self) -> float:
        """Time-weighted mean intensity over one full cycle of the
        signal (== the yearly mean for periodic signals)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ConstantIntensity(CarbonIntensity):
    """Fixed grid intensity (the classic single-number assumption)."""

    value_g_per_kwh: float = WORLD_AVG_G_PER_KWH

    def __post_init__(self):
        if self.value_g_per_kwh < 0.0:
            raise ValueError(f"intensity must be >= 0, got "
                             f"{self.value_g_per_kwh}")

    def g_per_kwh(self, t_s: float) -> float:
        return self.value_g_per_kwh

    def mean_g_per_kwh(self) -> float:
        return self.value_g_per_kwh


@dataclasses.dataclass(frozen=True)
class ShiftedIntensity(CarbonIntensity):
    """`base` evaluated at `t + t0_s` — a timezone/phase offset.

    Fleets spanning regions see the same diurnal shape at different
    local phases; `FleetInventory` rows carry a per-machine `t0_s` and
    pricing wraps the configured signal per machine. The time-weighted
    mean is shift-invariant, so amortized yearly estimates are
    unchanged — only *when* the operational carbon lands moves.
    """

    base: CarbonIntensity = dataclasses.field(
        default_factory=lambda: ConstantIntensity())
    t0_s: float = 0.0

    def g_per_kwh(self, t_s: float) -> float:
        return self.base.g_per_kwh(t_s + self.t0_s)

    def mean_g_per_kwh(self) -> float:
        return self.base.mean_g_per_kwh()


@dataclasses.dataclass(frozen=True)
class DiurnalIntensity(CarbonIntensity):
    """Sinusoidal day/night swing around a mean intensity.

    intensity(t) = mean * (1 + amplitude * sin(2*pi*t/period + phase)).
    The analytic mean over any whole number of periods is exactly
    `mean_g_per_kwh` — matching the mean-rate-preserving contract of the
    arrival processes, so footprints stay comparable across shapes.
    """

    mean: float = WORLD_AVG_G_PER_KWH
    amplitude: float = 0.4
    period_s: float = 86_400.0
    phase: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError(f"amplitude must be in [0, 1), got "
                             f"{self.amplitude}")
        if self.mean < 0.0:
            raise ValueError(f"mean intensity must be >= 0, got {self.mean}")
        if self.period_s <= 0.0:
            raise ValueError(f"period_s must be > 0, got {self.period_s}")

    def g_per_kwh(self, t_s: float) -> float:
        return self.mean * (1.0 + self.amplitude * math.sin(
            2.0 * math.pi * t_s / self.period_s + self.phase))

    def mean_g_per_kwh(self) -> float:
        return self.mean


@dataclasses.dataclass(frozen=True)
class TraceIntensity(CarbonIntensity):
    """Step-held intensity samples, extended cyclically.

    `times_s` must be strictly increasing and start at 0; each value
    holds until the next sample time, and the signal wraps modulo the
    trace span (last sample time + its holding interval, taken as the
    mean gap). A 24-hour grid trace therefore prices a whole year.
    """

    times_s: tuple[float, ...]
    values_g_per_kwh: tuple[float, ...]

    def __post_init__(self):
        times = tuple(float(t) for t in self.times_s)
        values = tuple(float(v) for v in self.values_g_per_kwh)
        if len(times) != len(values) or not times:
            raise ValueError("need equally many sample times and values, "
                             f"got {len(times)}/{len(values)}")
        # Power x intensity integration multiplies these values straight
        # into headline results, so reject bad ingest loudly and point
        # at the offending sample (NaN fails every comparison below).
        for i, t in enumerate(times):
            if not math.isfinite(t):
                raise ValueError("sample times must be finite, got "
                                 f"times_s[{i}]={t}")
        if times[0] != 0.0:
            raise ValueError("sample times must be strictly increasing "
                             f"and start at 0; got times_s[0]={times[0]}")
        for i, (a, b) in enumerate(zip(times, times[1:])):
            if not b > a:
                raise ValueError(
                    "sample times must be strictly increasing and start "
                    f"at 0; got times_s[{i + 1}]={b} after times_s[{i}]="
                    f"{a}")
        for i, v in enumerate(values):
            if not (math.isfinite(v) and v >= 0.0):
                raise ValueError("intensities must be finite and >= 0, "
                                 f"got g_per_kwh[{i}]={v}")
        object.__setattr__(self, "times_s", times)
        object.__setattr__(self, "values_g_per_kwh", values)
        # The last sample holds for the mean inter-sample gap, closing
        # the cycle (a single-sample trace degenerates to constant).
        tail = times[-1] / (len(times) - 1) if len(times) > 1 else 1.0
        object.__setattr__(self, "_span_s", times[-1] + tail)

    @classmethod
    def from_csv(cls, path_or_text: str) -> "TraceIntensity":
        """Load a `time_s,g_per_kwh` CSV: a path, or the CSV text
        itself. Dispatch is on newline presence — CSV text always spans
        header + data lines, while a path never contains one (a comma
        in a path is fine). Extra columns ignored."""
        if "\n" in path_or_text:
            fh = io.StringIO(path_or_text)
        else:
            fh = open(path_or_text, newline="")
        with fh:
            rows = list(csv.DictReader(fh))
        if not rows:
            raise ValueError("empty carbon-intensity CSV")
        try:
            times = tuple(float(r["time_s"]) for r in rows)
            values = tuple(float(r["g_per_kwh"]) for r in rows)
        except KeyError as e:
            raise ValueError(f"carbon-intensity CSV needs a {e.args[0]!r} "
                             "column (schema: time_s,g_per_kwh)") from None
        return cls(times_s=times, values_g_per_kwh=values)

    def g_per_kwh(self, t_s: float) -> float:
        t = t_s % self._span_s
        # Step-hold: last sample at or before t. Linear scan is fine —
        # signals have a handful of samples and footprint() integrates
        # analytically via mean_g_per_kwh, not by sampling.
        i = 0
        for j, tj in enumerate(self.times_s):
            if tj <= t:
                i = j
            else:
                break
        return self.values_g_per_kwh[i]

    def mean_g_per_kwh(self) -> float:
        times = self.times_s + (self._span_s,)
        total = sum(v * (times[i + 1] - times[i])
                    for i, v in enumerate(self.values_g_per_kwh))
        return total / self._span_s


#: spec-name → signal factory, mirroring how scenarios name arrival
#: shapes. Kept a plain dict (not a Registry): signals are constructor
#: details of the `operational-embodied` model, not an experiment axis.
_INTENSITIES = {
    "constant": ConstantIntensity,
    "diurnal": DiurnalIntensity,
    "trace": TraceIntensity,
    "trace-csv": TraceIntensity.from_csv,
}


def get_intensity(spec, **opts) -> CarbonIntensity:
    """Resolve an intensity spec: a `CarbonIntensity` passes through,
    a name in {constant, diurnal, trace, trace-csv} builds one."""
    if isinstance(spec, CarbonIntensity):
        if opts:
            raise TypeError("intensity opts only apply to named specs, "
                            f"got instance {spec!r} with opts {opts}")
        return spec
    try:
        factory = _INTENSITIES[str(spec)]
    except KeyError:
        raise KeyError(
            f"unknown carbon-intensity signal {spec!r}; available: "
            f"{', '.join(sorted(_INTENSITIES))}") from None
    return factory(**opts)
