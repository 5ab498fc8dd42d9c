"""eilev_tpu_torch: the PyTorch + CUDA port of eilev_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout and names. Imports torch and numpy only,
never jax, flax or eilev_tpu; the JAX package is the reference the port is
tested against (tests/test_torch_*.py).
"""

from . import configs

__version__ = "0.1.0"

__all__ = ["configs", "__version__"]
