"""Multi-device training and inference (counterpart of ``eilev_tpu/parallel``):
data parallelism over ``torch.distributed`` (one process a replica), ZeRO-2
optimizer-state sharding (``training/train_state.py``), GPipe pipeline
parallelism over a list of devices, and tensor parallelism over a model
group, for inference and training (``tensor.py``: the layout rule,
local-head towers, vocab-parallel tables and loss, the collectives with
their gradients, the sharded and gathered state dicts)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_sharding,
    data_group_ranks,
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
from .tensor import (
    TensorParallel,
    copy_to_model,
    is_model_sharded,
    shard_state_dict,
    unshard_state_dict,
    vocab_parallel_cross_entropy,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "STAGE_AXIS",
    "Mesh",
    "StackedLayers",
    "TensorParallel",
    "batch_sharding",
    "copy_to_model",
    "data_group_ranks",
    "is_model_sharded",
    "make_mesh",
    "make_pipeline_mesh",
    "mesh_coords",
    "make_pipeline_trunk",
    "opt_layer_apply",
    "replicated",
    "shard_batch",
    "shard_stacked",
    "shard_state_dict",
    "stack_layer_params",
    "tensor_parallel_mesh",
    "unshard_state_dict",
    "vocab_parallel_cross_entropy",
]
