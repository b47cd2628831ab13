"""Model zoo of the port: configs for all ten architectures, and `Model`,
which runs every family of the reference (dense, mixture-of-experts,
MLA, Mamba2, the Zamba2 hybrid, the vision frontend, the
encoder-decoder) with its attention and SSD scan on the hand-written
CUDA kernels."""
from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.models.model import Model, params_from_jax, params_to_jax

__all__ = ["INPUT_SHAPES", "InputShape", "ModelConfig", "Model",
           "params_from_jax", "params_to_jax"]
