"""The device mesh and batch placement (counterpart of ``eilev_tpu/parallel/mesh.py``).

The original's training parallelism is 8-GPU DDP over NCCL with optional
ZeRO-2. The port runs one process a device: a :class:`Mesh` is this
process's place on a ``data x model`` grid of the default process group's
ranks (rank = d * model + m, as JAX's ``reshape(data, model)`` lays devices
out; :func:`mesh_coords`) and the devices this process drives, one for data
and tensor parallelism, one a stage for pipeline parallelism
(``parallel/pipeline.make_pipeline_mesh``).

- The data axis: the batch's rows split over the data group
  (:func:`shard_batch`); the weights are replicated (:func:`replicated`);
  the gradients are summed by explicit collectives in the train step, and
  the optimizer moments can shard over the data group like ZeRO-2
  (``training/train_state.zero_sharded_opt_state``). The ranks that share a
  model rank, {m, model + m, ...}, form a data group
  (:attr:`Mesh.data_group`); the train step's data collectives run over
  it. At ``model=1`` it is the default group.
- The model axis (tensor parallelism, inference and training): runs of
  ``model`` consecutive ranks form a model group (``dist.new_group``); the
  towers are built with local heads and their weights sharded over it
  (``parallel/tensor.py``, :attr:`Mesh.tp`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from .distributed import initialize, local_device
from .tensor import TensorParallel

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the mesh and its devices.

    ``data_size`` replicas, this one ``data_rank``; each replica is a model
    group of ``model_size`` processes (``model_group``, a process group, or
    None at size 1), this one ``model_rank`` in it; the replicas' processes
    of this model rank form ``data_group`` (None: the default group, as at
    ``model_size`` 1). ``devices`` are the devices this process drives: its
    one device, or a pipeline's stage devices (stage s on ``devices[s]``)."""

    data_size: int
    data_rank: int
    devices: tuple
    axes: tuple = (DATA_AXIS, MODEL_AXIS)
    model_size: int = 1
    model_rank: int = 0
    model_group: Any = None
    data_group: Any = None

    @property
    def device(self) -> torch.device:
        """Where this process keeps its batch and everything outside a
        pipeline trunk: its first device."""
        return self.devices[0]

    @property
    def shape(self) -> dict:
        """Axis sizes as JAX's ``mesh.shape`` gives them: ``data`` and
        ``model``, or ``data`` and ``stage``."""
        second = self.axes[1]
        return {DATA_AXIS: self.data_size, second: self.model_size if second == MODEL_AXIS else len(self.devices)}

    @property
    def tp(self) -> Optional[TensorParallel]:
        """The model axis as the towers take it (``tp=``), or None at size 1."""
        if self.model_size == 1:
            return None
        return TensorParallel(self.model_size, self.model_rank, self.model_group)


def data_group() -> tuple[int, int]:
    """(size, rank) of the default process group; (1, 0) when none is up."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def mesh_coords(rank: int, data: int, model: int) -> tuple[int, int]:
    """(data_rank, model_rank) of global ``rank`` on a ``data x model`` mesh:
    rank = data_rank * model + model_rank."""
    if not 0 <= rank < data * model:
        raise ValueError(f"rank {rank} is not on a {data} x {model} mesh")
    return divmod(rank, model)


def model_group_ranks(data_rank: int, model: int) -> list[int]:
    """The global ranks of replica ``data_rank``'s model group."""
    return list(range(data_rank * model, (data_rank + 1) * model))


def data_group_ranks(model_rank: int, data: int, model: int) -> list[int]:
    """The global ranks of model rank ``model_rank``'s data group: {m,
    model + m, ...}."""
    return [d * model + model_rank for d in range(data)]


def make_mesh(data: Optional[int] = None, model: int = 1, *, device="cuda") -> Mesh:
    """The ``data x model`` mesh of this process over the default process
    group (one process without a group), this process's device
    :func:`~.distributed.local_device` of ``device``. ``data`` defaults to
    the process count over ``model``; ``data * model`` must equal the
    process count (``ValueError`` otherwise). With ``model`` > 1 every
    process creates every model group (:func:`model_group_ranks`), then every
    data group (:func:`data_group_ranks`), as ``dist.new_group`` needs, and
    keeps its own."""
    size, rank = data_group()
    want = model * (data or max(size // model, 1))
    if model < 1 or size % model:
        raise ValueError(f"the model axis is one process a shard: model={model} needs a multiple of {model} "
                         f"processes, this run has {size} (start them with torchrun --nproc_per_node {want})")
    data = size // model if data is None else data
    if data * model != size:
        raise ValueError(f"the mesh is one process a device: data={data} x model={model} needs "
                         f"{want} processes, this run has {size} (start them with torchrun --nproc_per_node {want})")
    data_rank, model_rank = mesh_coords(rank, data, model)
    group = data_grp = None
    if model > 1:
        for d in range(data):
            g = dist.new_group(model_group_ranks(d, model))
            if d == data_rank:
                group = g
        for m in range(model):
            g = dist.new_group(data_group_ranks(m, data, model))
            if m == model_rank:
                data_grp = g
    return Mesh(data, data_rank, (local_device(device),), model_size=model, model_rank=model_rank,
                model_group=group, data_group=data_grp)


def tensor_parallel_mesh(model: int, device="cuda") -> Mesh:
    """The mesh of a tensor-parallel inference run (``--model_parallel``):
    joins the process group ``torchrun`` started (:func:`~.distributed.initialize`)
    and takes every process onto the model axis. A world of another size
    than ``model`` raises ``ValueError``: a data axis beside it would only
    repeat the work, as JAX's does in its inference CLIs."""
    initialize(device)
    size, _ = data_group()
    if size != model:
        raise ValueError(f"--model_parallel {model} runs one process a shard and no data axis: start {model} "
                         f"processes with torchrun --nproc_per_node {model} (this run has {size})")
    return make_mesh(data=1, model=model, device=device)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on a mesh: whole on every process
    (``axis=None``) or split along ``axis`` over the data group, each
    process keeping its contiguous block of rows."""

    mesh: Mesh
    axis: Optional[int] = None

    def place(self, x) -> torch.Tensor:
        """This process's part of the global ``x`` on ``mesh.device``: a
        divisibility check and a slice (nothing moves between processes)."""
        x = torch.as_tensor(x)
        if self.axis is not None and x.ndim > self.axis:
            n, size = x.shape[self.axis], self.mesh.data_size
            if n % size != 0:
                raise ValueError(
                    f"batch axis {n} does not divide the data axis {size}; pick a batch that is a multiple of "
                    "the data axis (an uneven split would change the global batch)")
            per = n // size
            x = x.narrow(self.axis, self.mesh.data_rank * per, per)
        return x.to(self.mesh.device)


def batch_sharding(mesh: Mesh, axis: int = 0) -> Sharding:
    """Leading-axis data sharding for batches."""
    return Sharding(mesh, axis)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(batch: dict, mesh: Mesh, axis: int = 0) -> dict:
    """Place a global batch with its ``axis`` split over the data group
    (0-d tensors whole); a batch axis that does not divide the data size
    raises ``ValueError``."""
    sh = batch_sharding(mesh, axis)
    return {k: sh.place(v) for k, v in batch.items()}
