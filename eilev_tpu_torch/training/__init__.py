"""v2 training (counterpart of ``eilev_tpu/training``): the train state and
optax-exact AdamW, the batch iterator with on-card augmentation, native
checkpoints and the Trainer. ZeRO, pipeline parallelism and the HF export
are not ported."""

from .train_state import (
    OptimizerConfig,
    TrainState,
    ema_params,
    eval_step,
    freeze_towers,
    make_optimizer,
    make_train_step,
    merge_params,
    partition_params,
    with_param_ema,
)

__all__ = [
    "OptimizerConfig",
    "TrainState",
    "ema_params",
    "eval_step",
    "freeze_towers",
    "make_optimizer",
    "make_train_step",
    "merge_params",
    "partition_params",
    "with_param_ema",
]
