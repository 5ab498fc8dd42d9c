"""Logging and meters (counterpart of ``eilev_tpu/utils``; its compilation
cache is JAX's own and has no counterpart here)."""

from .logging import WandbLogger, maybe_wandb
from .meters import StepTimer, profile_trace

__all__ = ["StepTimer", "WandbLogger", "maybe_wandb", "profile_trace"]
