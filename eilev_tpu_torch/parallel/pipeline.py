"""GPipe pipeline parallelism for the frozen LM trunk over a list of devices
(counterpart of ``eilev_tpu/parallel/pipeline.py``).

Why: a layer stack that does not fit on one device, or whose activations
do not, is split into contiguous blocks of layers, one a stage, and the
batch into M micro-batches that flow through the stages; only the
activations at a stage boundary move between devices.

JAX's trunk is one SPMD program over the mesh's "stage" axis. Its PyTorch
counterpart is one process, a single controller, that

- keeps layer block s on ``mesh.devices[s]`` (:func:`shard_stacked`);
- issues the ticks in JAX's wavefront order: at tick t stage s runs
  micro-batch t - s through its block, and hands its output to stage s + 1
  by ``.to(next_device, non_blocking=True)``, which takes the place of
  ``ppermute``; M + S - 1 ticks drain the pipe, and the bubble is
  (S - 1) / (M + S - 1) of it. CUDA launches are asynchronous, so the
  stages on different cards run at once;
- lets autograd carry the gradient back through the copies.

Numerically it is the sequential stack, as JAX's is. Stages may share a
device (``make_pipeline_mesh(4, devices=["cuda:0"] * 4)``), which runs the
schedule on one card. Data parallelism composes: each data-replica process
drives its own stages (by default the CUDA devices from ``LOCAL_RANK *
stages`` on).

The layers are the model's own modules, grouped into blocks: nothing is
copied, and the frozen weights stay in the model, as everywhere in the
port's training (``training/train_state.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from .distributed import local_rank
from .mesh import DATA_AXIS, Mesh, data_group

STAGE_AXIS = "stage"


def make_pipeline_mesh(stages: int, *, data: Optional[int] = None, devices=None) -> Mesh:
    """A ("data", "stage") mesh for this process: the data group is every
    process (``data``, if given, must equal the process count), and
    ``stages`` devices carry the stages.

    ``devices`` None: the visible CUDA devices ``LOCAL_RANK * stages`` to
    ``LOCAL_RANK * stages + stages - 1``; more stages than there are
    devices raises ``ValueError``, as JAX's assert does. An explicit list
    gives the stages its first ``stages`` entries, and may repeat a device
    (several stages on one card, or on the CPU)."""
    if stages < 1:
        raise ValueError(f"a pipeline needs at least one stage, got {stages}")
    size, rank = data_group()
    if data is not None and data != size:
        raise ValueError(f"the data axis is one process a replica: data={data} needs {data} processes, "
                         f"this run has {size}")
    if devices is None:
        first = local_rank() * stages
        count = torch.cuda.device_count()
        if first + stages > count:
            raise ValueError(
                f"{stages} pipeline stages from cuda:{first} need {first + stages} visible CUDA devices, "
                f"there are {count}; pass devices=[...] to place the stages yourself (a device may repeat)")
        chosen = tuple(torch.device("cuda", first + i) for i in range(stages))
    else:
        chosen = tuple(torch.device(d) for d in devices)
        if len(chosen) < stages:
            raise ValueError(f"{stages} pipeline stages need {stages} devices, got {len(chosen)}")
        chosen = chosen[:stages]
    return Mesh(size, rank, chosen, axes=(DATA_AXIS, STAGE_AXIS))


@dataclasses.dataclass
class StackedLayers:
    """A layer stack split into per-stage blocks: ``blocks[s]`` holds the
    model's own layer modules s * L/S .. (s + 1) * L/S - 1. ``drop_key``
    names parameters that stay outside the trunk (T5's layer-0
    ``relative_attention_bias``: the bias is computed outside and passed in
    whole), so :func:`shard_stacked` leaves them where they are."""

    blocks: list
    drop_key: Optional[str] = None


def stack_layer_params(layers: Sequence[nn.Module], num_stages: int, *,
                       drop_key: Optional[str] = None) -> StackedLayers:
    """``layers`` (a ModuleList of L layers) -> ``num_stages`` contiguous
    blocks of L / num_stages, the modules themselves (no copy)."""
    n = len(layers)
    if n % num_stages != 0:
        raise ValueError(f"{n} layers do not split into {num_stages} equal pipeline stages")
    per = n // num_stages
    return StackedLayers([list(layers[s * per : (s + 1) * per]) for s in range(num_stages)], drop_key)


def unstack_layer_params(stacked: StackedLayers) -> list:
    """Inverse of :func:`stack_layer_params`: the L layer modules in order."""
    return [layer for block in stacked.blocks for layer in block]


def _move_(module: nn.Module, device: torch.device, skip: Optional[str]) -> None:
    """Move ``module``'s parameters and buffers to ``device`` in place (the
    model's own parameter objects keep their identity), except those whose
    name contains ``skip``."""
    with torch.no_grad():
        for name, t in [*module.named_parameters(), *module.named_buffers()]:
            if skip is None or skip not in name:
                t.data = t.data.to(device)


def shard_stacked(stacked: StackedLayers, mesh: Mesh) -> StackedLayers:
    """Place block s on ``mesh.devices[s]``, in place; returns ``stacked``."""
    if len(stacked.blocks) != len(mesh.devices):
        raise ValueError(f"{len(stacked.blocks)} blocks for {len(mesh.devices)} stage devices")
    for block, device in zip(stacked.blocks, mesh.devices):
        for layer in block:
            _move_(layer, device, stacked.drop_key)
    return stacked


def make_pipeline_trunk(
    layer_apply: Callable[..., torch.Tensor],
    mesh: Mesh,
    *,
    num_microbatches: int,
    batch_extras: int = 0,
    const_extras: int = 0,
) -> Callable[..., torch.Tensor]:
    """Build ``fn(stacked, x, mask, *extras) -> y`` running the layer stack
    as a GPipe schedule over ``mesh.devices``.

    ``layer_apply(layer, x, mask, *extras)`` applies ONE layer module; x:
    (B, T, D); mask: (B, T). B must divide into ``num_microbatches``. The
    first ``batch_extras`` extras have a leading batch axis and are
    micro-sliced with x (a T5 decoder's encoder states and mask); the other
    ``const_extras`` are passed whole to every stage (a shared relative
    position bias). Every input is copied to the device of the stage that
    reads it; the output comes back on x's device.
    """
    devices = mesh.devices
    num_stages, m_count = len(devices), num_microbatches

    def trunk(stacked: StackedLayers, x: torch.Tensor, mask: torch.Tensor, *extras) -> torch.Tensor:
        if len(stacked.blocks) != num_stages:
            raise ValueError(f"{len(stacked.blocks)} blocks for a {num_stages}-stage mesh")
        if len(extras) != batch_extras + const_extras:
            raise ValueError(f"expected {batch_extras} + {const_extras} extras, got {len(extras)}")
        b = x.shape[0]
        if b % m_count != 0:
            raise ValueError(f"batch {b} does not split into {m_count} pipeline micro-batches")
        mb = b // m_count

        def micro_slices(t: torch.Tensor, device) -> list:
            return [c.to(device, non_blocking=True) for c in t.split(mb)]

        # what each stage reads, on its own device: masks[s][m], per_batch[s][i][m], whole[s][i]
        masks = [micro_slices(mask, d) for d in devices]
        per_batch = [[micro_slices(e, d) for e in extras[:batch_extras]] for d in devices]
        whole = [[e.to(d, non_blocking=True) for e in extras[batch_extras:]] for d in devices]
        inbox: list = [None] * num_stages
        outs: list = [None] * m_count
        for t in range(m_count + num_stages - 1):
            handed: list = [None] * num_stages
            for s in range(num_stages):
                m = t - s  # stage s runs micro-batch t - s
                if not 0 <= m < m_count:
                    continue
                h = x[m * mb : (m + 1) * mb].to(devices[0], non_blocking=True) if s == 0 else inbox[s]
                for layer in stacked.blocks[s]:
                    h = layer_apply(layer, h, masks[s][m], *(e[m] for e in per_batch[s]), *whole[s])
                if s + 1 < num_stages:
                    handed[s + 1] = h.to(devices[s + 1], non_blocking=True)
                else:
                    outs[m] = h
            inbox = handed
        return torch.cat(outs).to(x.device)

    return trunk


def opt_layer_apply() -> Callable:
    """``layer_apply`` for ``models.opt.OPTDecoderLayer`` modules: causal +
    padding-mask attention, the training forward without a cache and without
    dropout (no mask source)."""

    def apply(layer, x, mask):
        return layer(x, {"causal": True, "padding_mask": mask})

    return apply


def t5_encoder_layer_apply() -> Callable:
    """``layer_apply`` for ``models.t5.T5EncoderLayer`` modules:
    ``apply(layer, x, mask, rel_bias)``, ``rel_bias`` the (H, S, S)
    relative-position bias computed once from layer 0's shared embedding
    outside the trunk (``const_extras=1``)."""

    def apply(layer, x, mask, rel_bias):
        return layer(x, {"bias": rel_bias, "padding_mask": mask})

    return apply


def t5_decoder_layer_apply() -> Callable:
    """``layer_apply`` for ``models.t5.T5DecoderLayer`` modules:
    ``apply(layer, x, dec_mask, encoder_hidden, enc_mask, rel_bias)``; the
    encoder states and mask are per batch (``batch_extras=2``), the causal
    relative-position bias whole (``const_extras=1``). Each stage projects
    its own layers' cross-attention K/V from the encoder states."""

    def apply(layer, x, dec_mask, encoder_hidden, enc_mask, rel_bias):
        ck, cv = layer.cross_attention.kv(encoder_hidden)
        return layer(x, {"bias": rel_bias, "causal": True, "padding_mask": dec_mask}, ck, cv, enc_mask)

    return apply
