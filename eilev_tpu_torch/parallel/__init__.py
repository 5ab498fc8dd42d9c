"""Multi-device training and inference (counterpart of ``eilev_tpu/parallel``):
data parallelism over ``torch.distributed`` (one process a replica), ZeRO-2
optimizer-state sharding (``training/train_state.py``), GPipe pipeline
parallelism over a list of devices, and tensor-parallel inference over a
model group (``tensor.py``: the layout rule, local-head towers, vocab-parallel
tables; tensor-parallel training is not ported)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_sharding,
    make_mesh,
    mesh_coords,
    replicated,
    shard_batch,
    tensor_parallel_mesh,
)
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
    "mesh_coords",
    "make_pipeline_trunk",
    "opt_layer_apply",
    "replicated",
    "shard_batch",
    "shard_stacked",
    "stack_layer_params",
    "tensor_parallel_mesh",
]
