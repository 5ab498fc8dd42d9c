"""Multi-process start-up and gathering (counterpart of ``eilev_tpu/parallel/distributed.py``).

The original's multi-node story is torchrun's c10d rendezvous with NCCL
DDP; the JAX package puts every chip into one global mesh. The port runs
one process a data replica, as ``torchrun`` starts them: :func:`initialize`
joins the default process group from the ``torchrun`` environment
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``)
or from explicit arguments. The backend follows the device the caller
asks for: NCCL for CUDA, gloo for the CPU. A CUDA run whose NCCL cannot
start raises; it never falls back to gloo or to the CPU.

Each process loads its own stride of the data
(``training/data_module.train_batch_iterator(process_index=...,
process_count=...)``) and keeps its rows on its own device
(:func:`host_local_batch_to_global`); the gradients are summed across the
processes by explicit collectives in the train step
(``training/train_state.py``).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """The collective backend of ``device``: NCCL for CUDA, gloo for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device type {kind!r}")


def local_rank() -> int:
    """This process's index on its host (``LOCAL_RANK``; 0 outside torchrun)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def local_device(device="cuda") -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` for CUDA (one card a
    data-replica process), the device as given otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank())
    return device


def initialize(
    device="cuda",
    *,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout: Optional[datetime.timedelta] = None,
) -> bool:
    """Join the default process group; True if this call started it.

    ``world_size``/``rank`` default to ``WORLD_SIZE``/``RANK``, and
    ``init_method`` to ``env://`` (``MASTER_ADDR``/``MASTER_PORT``). A no-op
    when the group is already up, and when the run is a single process and
    no rendezvous is asked for, as JAX's ``initialize`` is. The backend is
    :func:`backend_for` ``device``; for CUDA the process first takes
    :func:`local_device` as its current card. A failure to start raises.
    """
    if dist.is_initialized():
        return False
    world_size = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else world_size
    if world_size == 1 and init_method is None:
        return False
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    backend = backend_for(device)
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA run needs NCCL, and this PyTorch build has none")
        torch.cuda.set_device(local_device(device))
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
                            **kwargs)
    return True


def is_primary() -> bool:
    """Whether this process is rank 0 of the default group (or alone): the
    one that writes a run's files and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0


def host_local_batch_to_global(batch: Any, mesh, *, non_blocking: bool = True) -> Any:
    """This process's rows of the global batch, on its device.

    Each process passes the (accum, local_micro, ...) tensors or arrays it
    loaded (its stride of the data); together the processes hold the global
    batch, (accum, local_micro * processes, ...), rank r holding rows r *
    local_micro onwards. Nothing moves between processes: the train step
    reduces what needs the global view (the gradient, the valid-label count,
    the dropout masks' rows). Returns the dict with every tensor on
    ``mesh.device``."""
    return {k: torch.as_tensor(v).to(mesh.device, non_blocking=non_blocking) for k, v in batch.items()}


def gather_to_host(x: torch.Tensor) -> np.ndarray:
    """Every process's ``x`` concatenated along axis 0, as numpy on every
    process (an all-gather; ``x`` must have the same shape on each; bf16
    comes back as float32). One process: ``x`` itself."""
    x = x.detach()
    if dist.is_initialized() and dist.get_world_size() > 1:
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        x = torch.cat(parts)
    return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()  # numpy has no bf16
