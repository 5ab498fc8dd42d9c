"""The data-parallel mesh and batch placement (counterpart of ``eilev_tpu/parallel/mesh.py``,
its data-axis part).

The original's training parallelism is 8-GPU DDP over NCCL with optional
ZeRO-2. The port runs it as one process a data replica: a :class:`Mesh`
is the data group (this process's rank in it and its size) and the
devices this process drives, one for data parallelism, one a stage for
pipeline parallelism (``parallel/pipeline.make_pipeline_mesh``). The
batch's rows split over the data group (:func:`shard_batch`); the weights
are replicated (:func:`replicated`); the gradients are summed by explicit
collectives in the train step, and the optimizer moments can shard over
the data group like ZeRO-2 (``training/train_state.zero_sharded_opt_state``).

Tensor parallelism (a "model" axis of size > 1) is not ported: it needs
local-head modules in every model and is a slice of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from .distributed import local_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data group and this process's devices.

    ``data_size`` processes hold one replica each; this one is
    ``data_rank``; the data group is the default process group. ``devices``
    are the devices this process drives: its one device, or a pipeline's
    stage devices (stage s on ``devices[s]``)."""

    data_size: int
    data_rank: int
    devices: tuple
    axes: tuple = (DATA_AXIS, MODEL_AXIS)

    @property
    def device(self) -> torch.device:
        """Where this process keeps its batch and everything outside a
        pipeline trunk: its first device."""
        return self.devices[0]

    @property
    def shape(self) -> dict:
        """Axis sizes as JAX's ``mesh.shape`` gives them: ``data`` and
        ``model`` (1), or ``data`` and ``stage``."""
        second = self.axes[1]
        return {DATA_AXIS: self.data_size, second: 1 if second == MODEL_AXIS else len(self.devices)}


def data_group() -> tuple[int, int]:
    """(size, rank) of the default process group; (1, 0) when none is up."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(data: Optional[int] = None, model: int = 1, *, device="cuda") -> Mesh:
    """The data mesh of this process: every process of the default group on
    the data axis (one process without a group), this process's device
    :func:`~.distributed.local_device` of ``device``. ``data``, if given,
    must equal the process count; ``model`` > 1 (tensor parallelism) is not
    ported."""
    if model > 1:
        raise NotImplementedError(
            "tensor parallelism (a model axis > 1) is not ported: it waits for the port's tensor-parallel slice "
            "(local-head OPT, LLaMA, T5, ViT and Q-Former modules)")
    size, rank = data_group()
    if data is not None and data != size:
        raise ValueError(f"the data axis is one process a replica: data={data} needs {data} processes, "
                         f"this run has {size} (start them with torchrun --nproc_per_node)")
    return Mesh(size, rank, (local_device(device),))


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
