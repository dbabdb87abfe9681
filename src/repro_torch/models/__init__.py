"""Model zoo of the port: the dense, ssm and hybrid decoder families with
EULER-ADAS numerics on every matmul."""
from .config import ModelConfig
from .transformer import Model, params_from_jax

__all__ = ["ModelConfig", "Model", "params_from_jax"]
