"""Architecture registry: one module per assigned architecture, and the
port's own (`PORT_ONLY`: architectures the JAX package does not have).

Each module defines FULL (the exact assigned config, cited) and SMOKE
(reduced same-family variant: <=2 layers, d_model<=512, <=4 experts; the
port's own at most 3 layers and 8 experts) for CPU smoke tests. Select
via get_config(name) / get_smoke_config(name).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig

ARCH_IDS = [
    "granite_moe_3b_a800m",
    "internvl2_2b",
    "mamba2_2p7b",
    "seamless_m4t_large_v2",
    "minicpm3_4b",
    "mixtral_8x22b",
    "zamba2_7b",
    "granite_3_8b",
    "llama3_8b",
    "phi3_medium_14b",
    "deepseek_v2_lite",
]

#: the port's own architectures, which the JAX package's registry lacks
PORT_ONLY = ["deepseek-v2-lite"]

# public --arch ids (dashes) -> module names
ALIASES = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "internvl2-2b": "internvl2_2b",
    "mamba2-2.7b": "mamba2_2p7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "minicpm3-4b": "minicpm3_4b",
    "mixtral-8x22b": "mixtral_8x22b",
    "zamba2-7b": "zamba2_7b",
    "granite-3-8b": "granite_3_8b",
    "llama3-8b": "llama3_8b",
    "phi3-medium-14b": "phi3_medium_14b",
    "deepseek-v2-lite": "deepseek_v2_lite",
}


def _module(name: str):
    mod_name = ALIASES.get(name, name)
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).FULL


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


def all_arch_names() -> list[str]:
    return list(ALIASES.keys())
