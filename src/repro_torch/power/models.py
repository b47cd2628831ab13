"""Built-in power models.

flat-tdp      — bit-exact re-homing of the simulator's historical
                implicit assumption: constant `(gpu + other) * util`
                watts regardless of core state. Golden-pinned so the
                `operational-embodied` carbon model reproduces its
                pre-power-subsystem numbers exactly.
tdp-per-core  — per-core TDP share: busy cores draw full share,
                shallow-idle cores a fraction, gated cores ~nothing,
                plus platform + accelerator floors.
minmax-linear — governor-aware linear model in the style of ichnos'
                PowerModel.py (min/max watts per core, draw linear in
                load between them; `ondemand` additionally scales busy
                draw with the settled frequency factor, so aged-slow
                cores genuinely burn less).
fitted-linear — linear regression coefficients per node type
                (named presets or explicit coefficient dict).

All watt defaults are chosen so the machine-level draw is comparable
to flat-tdp's 2160 W at the repo's assumed 0.6 utilization — models
differ in *shape* (how draw responds to gating, load, and frequency),
which is what the temporal consumers exploit.
"""
from __future__ import annotations

from repro_torch.carbon.models import SERVER_GPU_TDP_W, SERVER_OTHER_TDP_W
from repro_torch.power.base import PowerModel
from repro_torch.power.registry import register_power_model
from repro_torch.power.residency import StateResidency

_J_PER_KWH = 3.6e6

# SERVER_OTHER_TDP_W at the assumed utilization; the CPU-side models
# keep the accelerator as a constant floor at that same operating point
# so cross-model comparisons isolate the CPU-state response.
_DEFAULT_UTILIZATION = 0.6
_DEFAULT_GPU_FLOOR_W = SERVER_GPU_TDP_W * _DEFAULT_UTILIZATION   # 1680.0


def _check_nonnegative(**kwargs: float) -> None:
    for name, value in kwargs.items():
        if not value >= 0.0:          # also rejects NaN
            raise ValueError(f"{name} must be >= 0, got {value}")


@register_power_model("flat-tdp")
class FlatTdpModel(PowerModel):
    """Constant draw `(gpu_tdp_w + other_tdp_w) * utilization`.

    Residency-blind by construction: this is exactly the flat-watts
    stand-in the `operational-embodied` carbon model used before the
    power subsystem existed, re-homed here so the default config
    reproduces pre-PR operational numbers bit-exactly.
    """

    name = "flat-tdp"

    def __init__(self, gpu_tdp_w: float = SERVER_GPU_TDP_W,
                 other_tdp_w: float = SERVER_OTHER_TDP_W,
                 utilization: float = _DEFAULT_UTILIZATION):
        _check_nonnegative(gpu_tdp_w=gpu_tdp_w, other_tdp_w=other_tdp_w,
                           utilization=utilization)
        self.gpu_tdp_w = gpu_tdp_w
        self.other_tdp_w = other_tdp_w
        self.utilization = utilization

    def machine_power_w(self, busy_frac: float, idle_frac: float,
                        gated_frac: float, mean_busy_freq: float,
                        num_cores: int) -> float:
        return (self.gpu_tdp_w + self.other_tdp_w) * self.utilization

    def energy_kwh(self, residency: StateResidency) -> float:
        # Closed form (constant power) keeps the golden pin independent
        # of window partitioning.
        watts = (self.gpu_tdp_w + self.other_tdp_w) * self.utilization
        return watts * residency.duration_s / _J_PER_KWH


@register_power_model("tdp-per-core")
class TdpPerCoreModel(PowerModel):
    """Per-core TDP shares on top of platform + accelerator floors.

    Busy cores draw `core_tdp_w`, shallow-idle cores
    `idle_core_frac * core_tdp_w` (clocks gated, rails up), gated
    cores `gated_core_w` (~0: rails down in C6).
    """

    name = "tdp-per-core"

    def __init__(self, core_tdp_w: float = 13.75,
                 idle_core_frac: float = 0.3,
                 gated_core_w: float = 0.0,
                 platform_w: float = 250.0,
                 gpu_w: float = _DEFAULT_GPU_FLOOR_W):
        _check_nonnegative(core_tdp_w=core_tdp_w, gated_core_w=gated_core_w,
                           platform_w=platform_w, gpu_w=gpu_w)
        if not 0.0 <= idle_core_frac <= 1.0:
            raise ValueError(
                f"idle_core_frac must be in [0, 1], got {idle_core_frac}")
        self.core_tdp_w = core_tdp_w
        self.idle_core_frac = idle_core_frac
        self.gated_core_w = gated_core_w
        self.platform_w = platform_w
        self.gpu_w = gpu_w

    def machine_power_w(self, busy_frac: float, idle_frac: float,
                        gated_frac: float, mean_busy_freq: float,
                        num_cores: int) -> float:
        per_core = (busy_frac * self.core_tdp_w
                    + idle_frac * self.idle_core_frac * self.core_tdp_w
                    + gated_frac * self.gated_core_w)
        return self.platform_w + self.gpu_w + num_cores * per_core


_GOVERNORS = ("performance", "ondemand", "powersave")


@register_power_model("minmax-linear")
class MinMaxLinearModel(PowerModel):
    """Governor-aware min/max linear model (ichnos PowerModel.py style).

    Each core has a `min_core_w` (idle, lowest P-state) and
    `max_core_w` (busy, highest P-state) draw. The cpufreq governor
    decides where busy cores land between them:

      performance — busy cores pinned at `max_core_w`
      powersave   — busy cores pinned at `min_core_w`
      ondemand    — busy draw scales with the settled frequency
                    factor: `min + (max - min) * clamp(f, 0, 1)`, so
                    aging-slowed cores draw measurably less

    Shallow-idle cores draw `min_core_w`; gated cores `c6_core_w`.
    """

    name = "minmax-linear"

    def __init__(self, min_core_w: float = 1.5, max_core_w: float = 13.75,
                 c6_core_w: float = 0.1, platform_w: float = 250.0,
                 gpu_w: float = _DEFAULT_GPU_FLOOR_W,
                 governor: str = "ondemand"):
        _check_nonnegative(min_core_w=min_core_w, max_core_w=max_core_w,
                           c6_core_w=c6_core_w, platform_w=platform_w,
                           gpu_w=gpu_w)
        if max_core_w < min_core_w:
            raise ValueError(
                f"max_core_w ({max_core_w}) must be >= min_core_w "
                f"({min_core_w})")
        if governor not in _GOVERNORS:
            raise ValueError(f"unknown governor {governor!r}; available: "
                             f"{', '.join(_GOVERNORS)}")
        self.min_core_w = min_core_w
        self.max_core_w = max_core_w
        self.c6_core_w = c6_core_w
        self.platform_w = platform_w
        self.gpu_w = gpu_w
        self.governor = governor

    def _busy_core_w(self, mean_busy_freq: float) -> float:
        if self.governor == "performance":
            return self.max_core_w
        if self.governor == "powersave":
            return self.min_core_w
        f = min(max(mean_busy_freq, 0.0), 1.0)
        return self.min_core_w + (self.max_core_w - self.min_core_w) * f

    def machine_power_w(self, busy_frac: float, idle_frac: float,
                        gated_frac: float, mean_busy_freq: float,
                        num_cores: int) -> float:
        per_core = (busy_frac * self._busy_core_w(mean_busy_freq)
                    + idle_frac * self.min_core_w
                    + gated_frac * self.c6_core_w)
        return self.platform_w + self.gpu_w + num_cores * per_core


# Coefficients are per-machine linear terms:
#   P_cpu = c0 + c_busy*n_busy + c_idle*n_idle + c_gated*n_gated
#           + c_freq*(f - 1)*n_busy
# fitted offline against wall-power measurements for a node type.
NODE_COEFFS = {
    "xeon-40c": {"c0": 220.0, "c_busy": 12.5, "c_idle": 3.0,
                 "c_gated": 0.2, "c_freq": 40.0},
    "epyc-64c": {"c0": 180.0, "c_busy": 8.5, "c_idle": 2.2,
                 "c_gated": 0.15, "c_freq": 28.0},
}


@register_power_model("fitted-linear")
class FittedLinearModel(PowerModel):
    """Linear model with regression coefficients from node configs.

    Pick a preset with `node="xeon-40c"` or pass an explicit `coeffs`
    dict (keys `c0`, `c_busy`, `c_idle`, `c_gated`, `c_freq`).
    """

    name = "fitted-linear"

    def __init__(self, node: str = "xeon-40c",
                 coeffs: dict | None = None,
                 gpu_w: float = _DEFAULT_GPU_FLOOR_W):
        _check_nonnegative(gpu_w=gpu_w)
        if coeffs is None:
            if node not in NODE_COEFFS:
                raise ValueError(f"unknown node {node!r}; available: "
                                 f"{', '.join(sorted(NODE_COEFFS))}")
            coeffs = NODE_COEFFS[node]
        coeffs = dict(coeffs)
        missing = {"c0", "c_busy", "c_idle", "c_gated",
                   "c_freq"} - coeffs.keys()
        if missing:
            raise ValueError(
                f"coeffs missing keys: {', '.join(sorted(missing))}")
        self.node = node
        self.coeffs = coeffs
        self.gpu_w = gpu_w

    def machine_power_w(self, busy_frac: float, idle_frac: float,
                        gated_frac: float, mean_busy_freq: float,
                        num_cores: int) -> float:
        c = self.coeffs
        n_busy = num_cores * busy_frac
        cpu = (c["c0"] + c["c_busy"] * n_busy
               + c["c_idle"] * num_cores * idle_frac
               + c["c_gated"] * num_cores * gated_frac
               + c["c_freq"] * (mean_busy_freq - 1.0) * n_busy)
        return self.gpu_w + max(cpu, 0.0)
