"""Built-in hardware SKU catalog.

Five generations of server CPUs spanning the replace-vs-extend design
space: the reference `xeon-40c` (bit-exact with the pre-heterogeneity
fleet-wide constants), an old low-core part, a mid-life Xeon, and two
modern high-core EPYCs whose larger dies carry larger embodied
footprints. Names align with the `fitted-linear` power model's
`NODE_COEFFS` presets where both exist (`xeon-40c`, `epyc-64c`).

`legacy-18c` deliberately runs at a different NBTI operating point
(higher Vth, lower headroom): mixing it into a fleet exercises the
grouped per-parameter aging settlers under the event engine. The fleet
engine vectorizes one shared `AgingParams` per run, so fleets mixing
Vdd/Vth corners must use `engine="event"`.
"""
from __future__ import annotations

import dataclasses

from repro_torch.hardware.base import HardwareSKU
from repro_torch.hardware.registry import register_sku


@register_sku("xeon-40c")
@dataclasses.dataclass(frozen=True)
class Xeon40c(HardwareSKU):
    """Reference SKU — today's implicit fleet-wide machine."""


@register_sku("legacy-18c")
@dataclasses.dataclass(frozen=True)
class Legacy18c(HardwareSKU):
    num_cores: int = 18
    cpu_model: str = "xeon-e5-2695v4-18c"
    generation: int = 1
    launch_year: int = 2016
    cpu_tdp_w: float = 270.0
    base_freq_ghz: float = 2.1
    max_freq_ghz: float = 3.3
    f_nominal: float = 0.82
    sigma_frac: float = 0.08
    vth: float = 0.48  # tighter headroom: ages faster per stress-second


@register_sku("xeon-28c")
@dataclasses.dataclass(frozen=True)
class Xeon28c(HardwareSKU):
    num_cores: int = 28
    cpu_model: str = "xeon-platinum-8280-28c"
    generation: int = 2
    launch_year: int = 2019
    cpu_tdp_w: float = 405.0
    base_freq_ghz: float = 2.7
    max_freq_ghz: float = 4.0
    f_nominal: float = 0.93
    sigma_frac: float = 0.06


@register_sku("epyc-64c")
@dataclasses.dataclass(frozen=True)
class Epyc64c(HardwareSKU):
    num_cores: int = 64
    cpu_model: str = "epyc-9554-64c"
    generation: int = 4
    launch_year: int = 2023
    cpu_tdp_w: float = 720.0
    base_freq_ghz: float = 3.1
    max_freq_ghz: float = 3.75
    f_nominal: float = 1.06
    sigma_frac: float = 0.045


@register_sku("epyc-128c")
@dataclasses.dataclass(frozen=True)
class Epyc128c(HardwareSKU):
    num_cores: int = 128
    cpu_model: str = "epyc-9754-128c"
    generation: int = 5
    launch_year: int = 2025
    cpu_tdp_w: float = 1120.0
    base_freq_ghz: float = 2.25
    max_freq_ghz: float = 3.1
    f_nominal: float = 1.1
    sigma_frac: float = 0.04
