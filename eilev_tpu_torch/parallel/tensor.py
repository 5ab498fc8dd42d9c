"""Tensor parallelism: the layout rule, the collectives, the sharded layers and
the sharded state dict (counterpart of ``eilev_tpu/parallel/mesh.py``'s
``_param_spec``, ``param_shardings`` and ``shard_variables_for_inference``).

JAX places the weights by a rule over parameter names and lets GSPMD carry
the layout through every jit, the KV cache included. PyTorch has no GSPMD,
so the port runs the layout Megatron-style: each rank of the mesh's model
group (``parallel/mesh.py``) holds its slice of every sharded weight, the
towers are built with local heads (their ``tp=`` argument), and the
activations meet in explicit collectives:

- **column-parallel** projections (q/k/v, ``fc1``, ``wi``/``wi_0``/``wi_1``,
  ``gate_proj``/``up_proj``, ``query``/``key``/``value``, ``intermediate``)
  keep the rank's output features, its heads or its block of the FFN; no
  collective;
- **row-parallel** projections (``out_proj``/``o``/``o_proj``/``projection``/
  ``dense``/``output``, ``fc2``/``wo``/``down_proj``) take the rank's input
  features; :class:`RowParallelLinear` sums the partial products with one
  all_reduce and adds the (whole) bias after it;
- **packed QKV** (OPT's and LLaMA's ``qkv_proj``, the ViT's ``qkv``) is
  sliced by heads, not by even thirds: each rank's packed projection is
  ``[q_local | k_local | v_local]``, so the packed attention kernels K1/K2 and
  the decode kernels K3/K4 run unchanged on the local heads. LLaMA's q heads
  ``[r H/tp, (r+1) H/tp)`` go with its kv heads ``[r KVH/tp, ...)``. (JAX
  splits the packed matrix evenly and lets GSPMD gather the activation; the
  layouts differ, the numbers agree.)
- **vocab-parallel** token tables and LM heads (``embed_tokens``, ``shared``,
  ``lm_head``) hold ceil(V / tp) rows a rank, the tail zero-padded as GSPMD
  pads: :class:`VocabParallelEmbedding` looks up the ids of its block and
  all_reduces; :func:`gather_vocab` writes a rank's logits into a zero-filled
  full-vocab buffer and all_reduces it, exact in any dtype (x + 0), so every
  rank holds the same bytes; :func:`vocab_parallel_log_prob` scores targets
  without the gather (classification over (B, C, L, V) logits);
- everything else is whole on every rank: position embeddings, norms, the
  biases of row-parallel layers, T5's relative-bias table (a rank reads its
  heads' columns), the query tokens and the language projection.

A tower whose head count or FFN width the model axis does not divide (the
Q-Former's 12 heads at tp 8) stays whole on every rank (:func:`tower_tp`);
LLaMA requires tp to divide its kv heads. The port vocab-shards its token
tables at any size, where JAX's rule leaves tables of up to 1,024 rows whole.

The only collective is ``all_reduce`` (SUM and MAX) over the model group,
which NCCL runs on the card and gloo runs on the CPU and on CUDA tensors.
The int8 weight modes run under tensor parallelism as JAX lays them out:
the int8 ``w8`` follows its layer's layout, the 1-D scales of a row-parallel
layer stay whole (``ops/quantization.py``: the row-parallel int8 layers take
their scales and their W8A8 row scales as all_reduce MAXes and sum their
int8 products in int32); the int8 KV cache holds the local heads.

Training (Megatron's two conjugate operators, as autograd Functions): the
input of every column-parallel projection goes through :func:`copy_to_model`
(the identity forward; backward, each rank's partial gradient of the
replicated input summed over the model group), and every row-parallel sum
through :meth:`TensorParallel.all_reduce`, which under autograd is the
all_reduce forward and the identity backward (the gradient of a replicated
output is already whole on every rank). The LM heads stay local:
:func:`vocab_parallel_cross_entropy` takes the loss from each rank's vocab
block. :func:`is_model_sharded` tells the clip's global norm which leaves to
sum over the model group, and :func:`unshard_state_dict` gathers the local
dicts back into the full one (checkpoints, export).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..configs import LlamaConfig, OPTConfig, QFormerConfig, T5Config, VideoBlipConfig, VisionConfig
from ..ops.quantization import _Int8Linear

COLUMN = "column"
ROW = "row"
PACKED = "packed"
VOCAB = "vocab"
REPLICATED = "replicated"

# JAX's names (eilev_tpu/parallel/mesh.py:_param_spec); the packed QKV and
# the vocab tables are their own kinds here
_COLUMN_NAMES = frozenset({"q_proj", "k_proj", "v_proj", "fc1", "query", "key", "value", "intermediate", "wi",
                           "wi_0", "wi_1", "q", "k", "v", "gate_proj", "up_proj"})
_PACKED_NAMES = frozenset({"qkv_proj", "qkv"})
_ROW_NAMES = frozenset({"out_proj", "fc2", "o", "projection", "output", "wo", "dense", "o_proj", "down_proj"})
_VOCAB_NAMES = frozenset({"embed_tokens", "shared", "lm_head"})


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    """This process's place on the model axis: ``size`` ranks in ``group``
    (a ``torch.distributed`` process group), this one ``rank``."""

    size: int
    rank: int
    group: Any = None

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` reduced over the model group. Without a graph to build, in
        place (returns ``x``); for an ``x`` that requires grad, a new tensor
        whose gradient passes back unchanged (:class:`_ReduceFromModel`). A
        MAX has no gradient: under autograd it raises ``ValueError``."""
        if torch.is_grad_enabled() and x.requires_grad:
            if op != dist.ReduceOp.SUM:
                raise ValueError("only a SUM over the model group has a gradient: reduce a detached tensor")
            return _ReduceFromModel.apply(x, self.group)
        dist.all_reduce(x, op=op, group=self.group)
        return x

    def block(self, n: int) -> tuple[int, int]:
        """(length, start) of this rank's even block of ``n``."""
        per = n // self.size
        return per, self.rank * per


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward, the gradient all_reduced (SUM) over the
    model group: each rank's column block gives a partial gradient of the
    replicated input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)  # autograd may hold the incoming buffer
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """all_reduce (SUM) over the model group forward, of a copy (autograd
    may have saved the input); the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """``x`` as the input of a column-parallel projection under ``tp``: the
    identity, whose gradient is summed over the model group
    (:class:`_CopyToModel`) where ``x`` requires grad; ``x`` itself without
    ``tp``."""
    if tp is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, tp.group)


def param_layout(name: str) -> str:
    """The layout of the state-dict entry ``name`` under tensor parallelism:
    :data:`COLUMN`, :data:`ROW` (a weight or an int8 ``w8``; the bias and
    the int8 scale of a row-parallel layer are whole), :data:`PACKED`,
    :data:`VOCAB` or :data:`REPLICATED`, by the name of the module that
    holds it."""
    parts = name.split(".")
    module, leaf = (parts[-2] if len(parts) > 1 else ""), parts[-1]
    if module in _VOCAB_NAMES:
        return VOCAB
    if module in _PACKED_NAMES:
        return PACKED
    if module in _COLUMN_NAMES:
        return COLUMN
    if module in _ROW_NAMES:
        return ROW if leaf in ("weight", "w8") else REPLICATED
    return REPLICATED


def _split_dims(config) -> tuple[tuple[int, ...], Optional[tuple[int, int, int]]]:
    """(the dims tp must divide, the packed QKV's (q, k, v) widths or None)."""
    if isinstance(config, (VisionConfig, QFormerConfig)):
        d = config.num_attention_heads * config.head_dim
        return (config.num_attention_heads, config.intermediate_size), (d, d, d)
    if isinstance(config, OPTConfig):
        d = config.hidden_size
        return (config.num_attention_heads, config.ffn_dim), (d, d, d)
    if isinstance(config, LlamaConfig):
        hd = config.head_dim
        kv = config.num_key_value_heads * hd
        return ((config.num_attention_heads, config.num_key_value_heads, config.intermediate_size),
                (config.num_attention_heads * hd, kv, kv))
    if isinstance(config, T5Config):
        return (config.num_heads, config.d_ff), None
    raise TypeError(f"no tensor-parallel layout for {type(config).__name__}")


def tower_tp(tp: Optional[TensorParallel], config) -> Optional[TensorParallel]:
    """``tp`` for a tower of ``config`` when the model axis divides its head
    count and FFN width, else None (the tower stays whole on every rank). A
    LLaMA whose kv heads the model axis does not divide raises
    ``ValueError``."""
    if tp is None or tp.size == 1:
        return None
    dims, _ = _split_dims(config)
    if isinstance(config, LlamaConfig) and config.num_key_value_heads % tp.size:
        raise ValueError(f"tensor parallelism over {tp.size} ranks needs it to divide LLaMA's "
                         f"{config.num_key_value_heads} kv heads")
    return None if any(n % tp.size for n in dims) else tp


def vocab_block(vocab: int, tp: TensorParallel) -> int:
    """Rows of a vocab-parallel table a rank: ceil(vocab / tp.size)."""
    return -(-vocab // tp.size)


class RowParallelLinear(nn.Linear):
    """A row-parallel projection: this rank's (out, in / tp) block of the
    weight, the partial products summed over the model group by one
    all_reduce, then the whole bias added. Computes in its input's dtype,
    as ``models/mixed_precision.MixedLinear``; a bf16 sum is reduced in
    bf16, as GSPMD's is."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *, tp: TensorParallel,
                 device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=dtype)
        self.tp = tp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.tp.all_reduce(F.linear(x, self.weight.to(x.dtype)))
        return y if self.bias is None else y + self.bias.to(y.dtype)


def row_parallel(cls: type, tp: Optional[TensorParallel]):
    """The row-parallel form of the layer class ``cls`` under ``tp``:
    :class:`RowParallelLinear` for a float layer, the int8 layer built with
    ``tp`` (``ops/quantization.py``) for an int8 one; ``cls`` itself without
    ``tp``."""
    if tp is None:
        return cls
    if issubclass(getattr(cls, "func", cls), _Int8Linear):  # a class, or a functools.partial of one
        return functools.partial(cls, tp=tp)
    return lambda *args, **kwargs: RowParallelLinear(*args, tp=tp, **kwargs)


class VocabParallelEmbedding(nn.Embedding):
    """This rank's block of a token table (:func:`vocab_block` rows, the
    tail past the vocabulary zero): ids outside the block look up zeros,
    and the all_reduce over the model group gives every rank every row."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *, tp: TensorParallel, device=None,
                 dtype=None):
        block = vocab_block(num_embeddings, tp)
        super().__init__(block, embedding_dim, device=device, dtype=dtype)
        self.tp, self.vocab_size, self.start = tp, num_embeddings, tp.rank * block

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local = ids - self.start
        inside = (local >= 0) & (local < self.num_embeddings)
        rows = F.embedding(torch.where(inside, local, 0), self.weight)
        return self.tp.all_reduce(torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                                  device=rows.device)))


def vocab_embedding(num_embeddings: int, embedding_dim: int, tp: Optional[TensorParallel], **kw) -> nn.Embedding:
    """A token table: vocab-parallel under ``tp``, else ``nn.Embedding``."""
    if tp is None:
        return nn.Embedding(num_embeddings, embedding_dim, **kw)
    return VocabParallelEmbedding(num_embeddings, embedding_dim, tp=tp, **kw)


def gather_vocab(local: torch.Tensor, tp: TensorParallel, vocab: int) -> torch.Tensor:
    """Every rank's (..., block) logits as the full (..., vocab) ones on every
    rank: each writes its block into a zero-filled buffer, and an all_reduce
    SUM adds the blocks (x + 0 is exact in any dtype)."""
    block = local.shape[-1]
    full = local.new_zeros(*local.shape[:-1], block * tp.size)
    full[..., tp.rank * block:(tp.rank + 1) * block] = local
    full = tp.all_reduce(full)
    return full if full.shape[-1] == vocab else full[..., :vocab].contiguous()


def local_vocab(full: torch.Tensor, tp: TensorParallel, vocab: int) -> torch.Tensor:
    """This rank's (..., block) columns of full-vocab logits (zeros past the
    vocabulary)."""
    block = vocab_block(vocab, tp)
    return F.pad(full, (0, block * tp.size - vocab))[..., tp.rank * block:(tp.rank + 1) * block]


def vocab_parallel_log_prob(local: torch.Tensor, targets: torch.Tensor, tp: TensorParallel,
                            vocab: int) -> torch.Tensor:
    """log_softmax(full logits)[targets] in fp32 from each rank's (..., block)
    logits, without the full tensor: an all_reduce MAX of the row maxima, an
    all_reduce SUM of the local sums of exp, and an all_reduce SUM of the
    target logit, which only its owning rank holds. ``targets`` has the
    logits' leading shape. Differentiable in ``local``: the two sums carry
    the gradient back to each rank's block (the row maximum is a constant
    of the result)."""
    x = local.float()
    block = x.shape[-1]
    start = tp.rank * block
    columns = torch.arange(start, start + block, device=x.device)
    x = x.masked_fill(columns >= vocab, float("-inf"))
    row_max = tp.all_reduce(x.detach().amax(dim=-1), dist.ReduceOp.MAX)
    sum_exp = tp.all_reduce(torch.exp(x - row_max[..., None]).sum(dim=-1))
    at = targets.long() - start
    inside = (at >= 0) & (at < block)
    picked = torch.gather(x, -1, torch.where(inside, at, 0)[..., None])[..., 0]
    target = tp.all_reduce(torch.where(inside, picked, torch.zeros((), device=x.device)))
    return target - row_max - torch.log(sum_exp)


def vocab_parallel_cross_entropy(local: torch.Tensor, labels: torch.Tensor, tp: TensorParallel,
                                 vocab: int) -> torch.Tensor:
    """``models/video_blip.masked_cross_entropy`` of the full logits from
    each rank's (..., block) ones (:func:`vocab_parallel_log_prob`): the
    mean over the positions where ``labels`` != -100, the same on every
    rank, with its gradient to the local logits."""
    valid = labels != -100
    logp = vocab_parallel_log_prob(local, torch.where(valid, labels, torch.zeros_like(labels)), tp, vocab)
    token_loss = -torch.where(valid, logp, torch.zeros_like(logp))
    return token_loss.sum() / valid.sum().clamp(min=1)


# ---------------------------------------------------------------------------
# the sharded state dict
# ---------------------------------------------------------------------------


def _tower_config(name: str, config):
    """The config of the tower that holds ``name``: a VideoBLIP's vision,
    Q-Former or language model (None for the query tokens and the language
    projection, which are whole), or ``config`` itself for a bare LM."""
    if not isinstance(config, VideoBlipConfig):
        return config
    for prefix, tower in (("vision_model.", config.vision_config), ("qformer.", config.qformer_config),
                          ("language_model.", config.text_config)):
        if name.startswith(prefix):
            return tower
    return None


def shard_tensor(name: str, tensor: torch.Tensor, config, tp: Optional[TensorParallel]) -> torch.Tensor:
    """This rank's part of the full ``tensor`` named ``name`` in a tower of
    ``config`` (``tp`` already resolved by :func:`tower_tp`): a slice, or the
    tensor itself where it is whole."""
    kind = param_layout(name)
    if tp is None or kind == REPLICATED:
        return tensor
    if kind == VOCAB:
        vocab = tensor.shape[0]
        block = vocab_block(vocab, tp)
        part = tensor[tp.rank * block:(tp.rank + 1) * block]
        return F.pad(part, (0, 0, 0, block - part.shape[0])) if part.shape[0] < block else part
    if kind == ROW:
        per, start = tp.block(tensor.shape[1])
        return tensor[:, start:start + per]
    if kind == COLUMN:
        per, start = tp.block(tensor.shape[0])
        return tensor[start:start + per]
    _, widths = _split_dims(config)
    pieces = []
    for part in tensor.split(list(widths)):  # q, k, v: each by heads
        per, start = tp.block(part.shape[0])
        pieces.append(part[start:start + per])
    return torch.cat(pieces)


def shard_state_dict(state_dict: Mapping[str, torch.Tensor], config, tp: Optional[TensorParallel]
                     ) -> dict[str, torch.Tensor]:
    """The port's full state dict of a model of ``config`` (a
    ``VideoBlipConfig``, or a bare OPT, LLaMA or T5 config) -> this rank's
    local one under ``tp`` (:class:`TensorParallel`, or None: the dict
    itself). Each tower is sliced by :func:`param_layout` where
    :func:`tower_tp` shards it."""
    if tp is None or tp.size == 1:
        return dict(state_dict)
    out = {}
    for name, tensor in state_dict.items():
        tower = _tower_config(name, config)
        out[name] = tensor if tower is None else shard_tensor(name, tensor, tower, tower_tp(tp, tower))
    return out


def is_model_sharded(name: str, config, tp: Optional[TensorParallel]) -> bool:
    """Whether the state-dict entry ``name`` of a model of ``config`` is a
    slice on the model axis under ``tp`` (its tower sharded and its layout
    not :data:`REPLICATED`); the rest is whole, and the same, on every rank."""
    if tp is None or tp.size == 1:
        return False
    tower = _tower_config(name, config)
    return tower is not None and param_layout(name) != REPLICATED and tower_tp(tp, tower) is not None


def _gather_cat(t: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    """The model group's equal shards of a tensor, concatenated along ``dim``
    in rank order on every rank: each writes its shard into a zero-filled
    buffer and an all_reduce SUM adds them (x + 0 is exact in any dtype)."""
    n = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = n * tp.size
    full = t.new_zeros(shape)
    full.narrow(dim, tp.rank * n, n).copy_(t)
    dist.all_reduce(full, group=tp.group)
    return full


@torch.no_grad()
def unshard_tensor(name: str, local: torch.Tensor, config, tp: Optional[TensorParallel]) -> torch.Tensor:
    """Inverse of :func:`shard_tensor` (a collective over the model group:
    every rank calls it, in the same order): the full tensor ``name`` from
    the ranks' parts. Packed QKV is put back by heads, and a vocab table's
    zero tail dropped."""
    kind = param_layout(name)
    if tp is None or kind == REPLICATED:
        return local
    if kind == ROW:
        return _gather_cat(local, tp, 1)
    full = _gather_cat(local, tp, 0)
    if kind == VOCAB:
        return full[:config.vocab_size]
    if kind == COLUMN:
        return full
    _, widths = _split_dims(config)
    per = [w // tp.size for w in widths]
    ranks = full.split(sum(per))  # each rank's [q | k | v]
    parts = [r.split(per) for r in ranks]
    return torch.cat([torch.cat([p[i] for p in parts]) for i in range(len(per))])


def unshard_state_dict(state_dict: Mapping[str, torch.Tensor], config, tp: Optional[TensorParallel]
                       ) -> dict[str, torch.Tensor]:
    """Inverse of :func:`shard_state_dict`: this rank's local state dict of a
    model of ``config`` under ``tp`` -> the full one, on every rank of the
    model group (a collective: every rank calls it with the same names)."""
    if tp is None or tp.size == 1:
        return dict(state_dict)
    out = {}
    for name, tensor in state_dict.items():
        tower = _tower_config(name, config)
        out[name] = tensor if tower is None else unshard_tensor(name, tensor, tower, tower_tp(tp, tower))
    return out
