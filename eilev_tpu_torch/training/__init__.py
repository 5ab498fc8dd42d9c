"""v2 training (counterpart of ``eilev_tpu/training``): the train state and
optax-exact AdamW, the batch iterator with on-card augmentation, native
checkpoints with the HF safetensors export, and the Trainer, with data
parallelism, ZeRO-2, tensor parallelism and pipeline parallelism
(``pipeline_step.py``, ``parallel/``)."""

from .checkpoint import restore_checkpoint, save_checkpoint, whole_state
from .train_state import (
    OptimizerConfig,
    TrainState,
    ema_params,
    eval_step,
    freeze_towers,
    full_opt_state,
    make_optimizer,
    make_train_step,
    merge_params,
    partition_params,
    with_param_ema,
    zero_sharded_opt_state,
)

__all__ = [
    "OptimizerConfig",
    "TrainState",
    "ema_params",
    "eval_step",
    "freeze_towers",
    "full_opt_state",
    "make_optimizer",
    "make_train_step",
    "merge_params",
    "partition_params",
    "restore_checkpoint",
    "save_checkpoint",
    "whole_state",
    "with_param_ema",
    "zero_sharded_opt_state",
]
