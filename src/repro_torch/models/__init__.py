"""Model zoo of the port: configs for all ten architectures, and the
dense GQA decoder (`Model`) with its attention on the hand-written CUDA
kernels."""
from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.models.model import Model, params_from_jax

__all__ = ["INPUT_SHAPES", "InputShape", "ModelConfig", "Model",
           "params_from_jax"]
