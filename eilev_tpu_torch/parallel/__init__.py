"""Multi-device training (counterpart of ``eilev_tpu/parallel``): data
parallelism over ``torch.distributed`` (one process a replica), ZeRO-2
optimizer-state sharding (``training/train_state.py``) and GPipe pipeline
parallelism over a list of devices. Tensor parallelism is not ported."""

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, batch_sharding, make_mesh, replicated, shard_batch
from .pipeline import (
    STAGE_AXIS,
    StackedLayers,
    make_pipeline_mesh,
    make_pipeline_trunk,
    opt_layer_apply,
    shard_stacked,
    stack_layer_params,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "STAGE_AXIS",
    "Mesh",
    "StackedLayers",
    "batch_sharding",
    "make_mesh",
    "make_pipeline_mesh",
    "make_pipeline_trunk",
    "opt_layer_apply",
    "replicated",
    "shard_batch",
    "shard_stacked",
    "stack_layer_params",
]
