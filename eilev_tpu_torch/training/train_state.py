"""Train state, frozen-tower partitioning, the optimizer and the train step
(counterpart of ``eilev_tpu/training/train_state.py``).

The recipe (reference train_v2.py:104-219): freeze the vision tower and the
LM, train the Q-Former, language projection and query tokens,
grad-accumulate to a global batch, AdamW with warmup, fp32 master weights.

PyTorch keeps the weights in the model, so the port's state refers to them
rather than carrying a copy: ``TrainState.trainable`` holds the model's own
trainable parameters (the fp32 masters, by name), and a step updates them in
place. Gradients are taken for the trainable parameters only; they flow
through the frozen LM to the scattered video features. The frozen towers do
not require grad (:func:`freeze_towers`), so the vision tower runs without a
graph.

The optimizer is optax's ``chain(clip_by_global_norm, adamw(schedule))``,
computed as optax computes it, in float32: the global-norm clip has no
epsilon (``clip_grad_norm_`` adds 1e-6, so it is not used); AdamW's epsilon
sits outside the square root, with optax's bias correction; the decoupled
weight decay is added to every leaf (no mask, as in JAX) and scaled by the
schedule with the Adam direction; the schedule is read at the update count
before the update, so a warmup from 0 gives a first step with lr 0. The
optimizer state is a nested dict of tensors, so that ``torch.save`` writes it
and ``torch.load(weights_only=True)`` reads it back.

Data parallelism (a ``parallel.Mesh`` whose process group is up): one
process a replica, each with its rows of the global micro-batch. The loss
is JAX's: the masked mean over the GLOBAL micro-batch, each rank's mean
weighted by its share of the valid labels (the counts are all-reduced
before the forward), and the trainable gradients are summed across the
ranks by one all-reduce a dtype after the micro-batches, not by
``DistributedDataParallel``'s hooks, which attach to ``.backward``. The
dropout masks are the global batch's rows (``ops/dropout.DropoutRng`` with
the rank and world), so N ranks take the step one device takes over the
concatenated batch. With ``zero_shard_opt_state`` (ZeRO-2) each rank keeps
its block of rows of every optimizer moment whose first dimension the
data size divides (:func:`zero_sharded_opt_state`), updates those rows of
the parameters from the all-reduced gradient, whose global norm (the
clip's) is taken whole, and all-gathers them; AdamW is elementwise, so
the step is the replicated one bit for bit.

Tensor parallelism (a mesh with ``model_size`` > 1, the model built with
its ``tp``): the trainable leaves are this rank's shards of the Q-Former
(``parallel/tensor.py``) and whole copies of the rest; the data collectives
above run over the mesh's data group (the ranks of this model rank), so
each shard is summed over its replicas only. The clip's global norm is the
full gradient's: the squared norms of the model-sharded leaves
(``parallel.tensor.is_model_sharded``) are summed over the model group and
each replicated leaf counted once. The moments follow the local shards,
and ZeRO splits each local shard's rows over the data group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..ops.dropout import DropoutRng
from ..parallel.tensor import is_model_sharded

TRAINABLE_PREFIXES = ("query_tokens", "qformer", "language_projection")

Params = dict[str, torch.Tensor]


def partition_params(params: Mapping[str, torch.Tensor]) -> tuple[Params, Params]:
    """Split a name -> tensor map into (trainable, frozen) by top-level
    module, per the reference freeze list (train_v2.py:124-130)."""
    trainable = {k: v for k, v in params.items() if k.split(".")[0] in TRAINABLE_PREFIXES}
    frozen = {k: v for k, v in params.items() if k.split(".")[0] not in TRAINABLE_PREFIXES}
    return trainable, frozen


def merge_params(trainable: Mapping[str, torch.Tensor], frozen: Mapping[str, torch.Tensor]) -> Params:
    return {**frozen, **trainable}


def freeze_towers(model: nn.Module) -> tuple[Params, Params]:
    """Set ``requires_grad`` by the freeze list (the vision tower and the LM
    frozen) and return the model's (trainable, frozen) parameters."""
    trainable, frozen = partition_params(dict(model.named_parameters()))
    for p in trainable.values():
        p.requires_grad_(True)
    for p in frozen.values():
        p.requires_grad_(False)
    return trainable, frozen


class GradientTransformation(NamedTuple):
    """optax's pair: ``init(params) -> state``, ``update(grads, state,
    params, g_norm=None) -> (updates, state)``, over name -> tensor maps.
    ``g_norm`` is the clip's global norm when ``grads`` is a shard of the
    gradient (ZeRO); None takes it from ``grads``."""

    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], tuple[Params, Any]]


@dataclasses.dataclass
class TrainState:
    step: int
    trainable: Params
    opt_state: Any
    tx: GradientTransformation

    @classmethod
    def create(cls, trainable: Mapping[str, torch.Tensor], tx: GradientTransformation) -> "TrainState":
        return cls(step=0, trainable=dict(trainable), opt_state=tx.init(trainable), tx=tx)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Mirrors the HF TrainingArguments subset the reference uses
    (slurm-scripts/train/submit_train_v2.py:22-37: lr 1e-4, warmup 1000 steps,
    AdamW, weight_decay 0.05)."""

    learning_rate: float = 1e-4
    warmup_steps: int = 1000
    total_steps: int = 10000
    weight_decay: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    max_grad_norm: Optional[float] = 1.0  # None: no clip (optax's bare adamw)
    schedule: str = "linear"  # HF Trainer default: linear decay after warmup
    # > 0: keep an exponential moving average of the trainable params in the
    # optimizer state; read it back with ema_params(state). 0 disables.
    ema_decay: float = 0.0


def _linear_schedule(init: float, end: float, steps: int) -> Callable[[int], np.float32]:
    """``optax.linear_schedule`` in float32: constant ``init`` when ``steps``
    <= 0."""
    if steps <= 0:
        return lambda count: np.float32(init)

    def schedule(count: int) -> np.float32:
        frac = np.float32(1) - np.float32(min(max(count, 0), steps)) / np.float32(steps)
        return np.float32(init - end) * frac + np.float32(end)

    return schedule


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], np.float32]:
    """The learning rate at an update count: linear warmup from 0 to
    ``learning_rate`` over ``warmup_steps``, then linear decay to 0 at
    ``total_steps`` (``optax.join_schedules``), or ``constant``."""
    if cfg.schedule == "constant":
        return lambda count: np.float32(cfg.learning_rate)
    if cfg.schedule != "linear":
        raise ValueError(cfg.schedule)
    warmup = _linear_schedule(0.0, cfg.learning_rate, cfg.warmup_steps)
    decay = _linear_schedule(cfg.learning_rate, 0.0, max(cfg.total_steps - cfg.warmup_steps, 1))
    return lambda count: warmup(count) if count < cfg.warmup_steps else decay(count - cfg.warmup_steps)


def global_norm(tree: Mapping[str, torch.Tensor], tp=None, sharded=frozenset()) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (``optax.global_norm``).
    Under ``tp`` (a ``parallel.tensor.TensorParallel``) the leaves named in
    ``sharded`` are this rank's slices of the full gradient: their squares
    are summed over the model group, the other leaves' counted once."""
    if tp is None:
        return torch.sqrt(sum(torch.sum(g * g) for g in tree.values()))
    zero = next(iter(tree.values())).new_zeros((), dtype=torch.float32)
    mine = sum((torch.sum(g * g) for k, g in tree.items() if k in sharded), zero)
    whole = sum((torch.sum(g * g) for k, g in tree.items() if k not in sharded), zero)
    return torch.sqrt(tp.all_reduce(mine) + whole)


def make_optimizer(cfg: OptimizerConfig) -> GradientTransformation:
    """``chain(clip_by_global_norm(max_grad_norm), adamw(schedule, ...))``
    (``adamw`` alone when ``max_grad_norm`` is None), with
    :func:`with_param_ema` when ``ema_decay`` > 0."""
    sched = make_schedule(cfg)
    b1, b2, eps, wd, max_norm = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay, cfg.max_grad_norm

    def init(params: Params) -> dict:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
        }

    def update(grads: Params, state: dict, params: Params, g_norm=None) -> tuple[Params, dict]:
        if max_norm is not None:
            # clip_by_global_norm: no epsilon; a norm below max_norm passes as is
            g_norm = global_norm(grads) if g_norm is None else g_norm
            keep = g_norm < max_norm
            grads = {k: torch.where(keep, g, (g / g_norm.to(g.dtype)) * max_norm) for k, g in grads.items()}
        # scale_by_adam; the float32 scalars are host floats, so that no
        # step copies a scalar to the device
        count = state["count"] + 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in grads.items()}
        nu = {k: (1 - b2) * (g**2) + b2 * state["nu"][k] for k, g in grads.items()}
        # add_decayed_weights, then scale_by_schedule at the count before this update
        step_size = float(-sched(state["count"]))
        updates = {}
        for k in grads:
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps) + wd * params[k]
            updates[k] = step_size * u
        return updates, {"count": count, "mu": mu, "nu": nu}

    tx = GradientTransformation(init, update)
    if cfg.ema_decay:
        tx = with_param_ema(tx, cfg.ema_decay)
    return tx


def with_param_ema(tx: GradientTransformation, decay: float) -> GradientTransformation:
    """Wrap ``tx`` so the optimizer state also carries an exponential moving
    average of the PARAMETERS (ema <- decay * ema + (1 - decay) * new_params
    each step). Living in the optimizer state, the EMA checkpoints and
    restores with it; read it with :func:`ema_params`."""

    def init(params: Params) -> dict:
        return {"inner": tx.init(params), "ema": {k: p.detach().clone() for k, p in params.items()}}

    def update(grads: Params, state: dict, params: Params, g_norm=None) -> tuple[Params, dict]:
        updates, inner = tx.update(grads, state["inner"], params, g_norm)
        ema = {k: decay * e + (1.0 - decay) * (params[k].detach() + updates[k]) for k, e in state["ema"].items()}
        return updates, {"inner": inner, "ema": ema}

    return GradientTransformation(init, update)


def ema_params(state: TrainState) -> Params:
    """The EMA shadow of ``state.trainable`` (needs an optimizer built with
    ``ema_decay > 0``)."""
    if not (isinstance(state.opt_state, dict) and "ema" in state.opt_state):
        raise ValueError("the optimizer was not built with ema_decay > 0")
    return state.opt_state["ema"]


def _model_inputs(batch: Mapping[str, torch.Tensor]) -> dict:
    return {k: batch.get(k) for k in ("input_ids", "attention_mask", "pixel_values", "video_input_mask", "labels")}


def valid_label_counts(labels: torch.Tensor, decoder_only: bool) -> torch.Tensor:
    """The number of labels each micro-batch's loss averages over: labels
    (accum, micro, S) != -100, shifted by one for a decoder-only LM (HF's
    causal loss); (accum,) float32."""
    if decoder_only:
        labels = labels[..., 1:]
    return (labels != -100).flatten(1).sum(1).to(torch.float32)


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensors of nested dicts/lists (with matching ``rest``
    trees); other leaves (the step count) kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return tree


def _sharded(t: torch.Tensor, size: int) -> bool:
    """ZeRO's rule: a leaf whose first dimension ``size`` divides is split
    over the data group along it; the rest stay whole on every rank."""
    return t.ndim >= 1 and t.shape[0] % size == 0


def _rows(t: torch.Tensor, size: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s block of rows of ``t`` (a view), or ``t`` itself
    where :func:`_sharded` keeps it whole."""
    if not _sharded(t, size):
        return t
    n = t.shape[0] // size
    return t.narrow(0, rank * n, n)


def zero_sharded_opt_state(state: TrainState, mesh) -> Any:
    """The ZeRO-2 layout of ``state.opt_state`` on ``mesh``'s data group:
    every moment whose first dimension divides the data size is cut to this
    rank's block of rows (a copy, so the whole one can be freed), the rest
    kept whole (JAX returns the sharding spec of this layout; the port
    returns the state in it). The step of :func:`make_train_step` with
    ``zero_shard_opt_state`` takes it."""
    size, rank = mesh.data_size, mesh.data_rank
    return _tree_map(lambda t: _rows(t, size, rank).clone() if _sharded(t, size) else t, state.opt_state)


def full_opt_state(state: TrainState, mesh) -> Any:
    """Inverse of :func:`zero_sharded_opt_state`: every sharded moment
    all-gathered over the data group to its whole shape (a collective:
    every rank calls it), as a checkpoint holds it. Under tensor
    parallelism the whole shapes are the rank's local shards'."""
    size = mesh.data_size
    if size == 1:
        return state.opt_state
    # the whole shapes, without memory: the optimizer's init on meta tensors
    template = state.tx.init({k: torch.empty_like(p, device="meta") for k, p in state.trainable.items()})

    def gather(t: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
        if not _sharded(whole, size):
            return t
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t.contiguous(), group=mesh.data_group)
        return torch.cat(parts)

    return _tree_map(gather, state.opt_state, template)


def _all_reduce_sum(tensors: list, group=None) -> list:
    """Sum each tensor across the data group ``group`` (None: the default
    group): one all-reduce of the concatenation a dtype."""
    out = list(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, piece in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = piece.view(tensors[i].shape)
    return out


def _all_gather_rows_(params: Mapping[str, torch.Tensor], size: int, rank: int, group=None) -> None:
    """After a ZeRO update of each rank's rows: every sharded parameter's
    blocks all-gathered over the data group ``group`` into it, in place (one
    all-gather a dtype)."""
    by_dtype: dict = {}
    for k, p in params.items():
        if _sharded(p, size):
            by_dtype.setdefault(p.dtype, []).append(k)
    for names in by_dtype.values():
        mine = torch.cat([_rows(params[k], size, rank).reshape(-1) for k in names])
        parts = [torch.empty_like(mine) for _ in range(size)]
        dist.all_gather(parts, mine, group=group)
        sizes = [params[k].numel() // size for k in names]
        for r, part in enumerate(parts):
            for k, piece in zip(names, part.split(sizes)):
                block = _rows(params[k], size, r)
                block.copy_(piece.view(block.shape))


def make_step(
    model: nn.Module,
    loss_fn: Callable[[Mapping[str, torch.Tensor], Any], torch.Tensor],
    *,
    accum_steps: int = 1,
    dropout: bool = True,
    mesh=None,
    zero_shard_opt_state: bool = False,
) -> Callable[[TrainState, Mapping[str, torch.Tensor]], tuple[TrainState, dict]]:
    """The step around a loss: ``loss_fn(micro, dropout_rng) -> loss``, the
    masked mean over this process's rows of one micro-batch. Shared by
    :func:`make_train_step` and ``training/pipeline_step.make_pp_train_step``;
    the data-parallel reductions, the tensor-parallel clip and ZeRO are
    here (see the module's docstring). With ``mesh`` and a process group
    up, the collectives run whatever the group's size (a group of one gives
    the one-device step bit for bit). A mesh with a model axis needs a
    model built with its ``tp`` (``ValueError`` otherwise: its weights would
    be summed over the model group as if they were replicas)."""
    reduce = mesh is not None and dist.is_initialized()
    size, rank = (mesh.data_size, mesh.data_rank) if reduce else (1, 0)
    group = mesh.data_group if reduce else None
    tp = check_tensor_parallel(model, mesh)
    decoder_only = model.config.use_decoder_only_language_model

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]) -> tuple[TrainState, dict]:
        names = list(state.trainable)
        params = [state.trainable[k] for k in names]
        device = params[0].device
        model.train(dropout)
        rng = DropoutRng.seeded(state.step, device, rank, size) if dropout else None
        if reduce:
            # each rank's share of every micro-batch's global valid-label count
            local = valid_label_counts(batch["labels"], decoder_only)
            (total,) = _all_reduce_sum([local], group)
            weights = local / total.clamp(min=1)
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        grad_sum = None
        for i in range(accum_steps):
            loss = loss_fn({k: v[i] for k, v in batch.items()}, rng)
            if reduce:
                loss = loss * weights[i]
            grads = torch.autograd.grad(loss, params)
            loss_sum = loss_sum + loss.detach()
            grad_sum = list(grads) if grad_sum is None else [a + b for a, b in zip(grad_sum, grads)]
        if reduce:
            loss_sum, *grad_sum = _all_reduce_sum([loss_sum, *grad_sum], group)
        inv = 1.0 / accum_steps
        grads = {k: g * inv for k, g in zip(names, grad_sum)}
        g_norm = global_norm(grads, tp, {k for k in names if is_model_sharded(k, model.config, tp)})
        with torch.no_grad():
            if zero_shard_opt_state:
                mine = {k: _rows(p, size, rank) for k, p in state.trainable.items()}
                updates, opt_state = state.tx.update(
                    {k: _rows(g, size, rank) for k, g in grads.items()}, state.opt_state, mine, g_norm)
                for k, p in mine.items():
                    p.add_(updates[k])
                if reduce:
                    _all_gather_rows_(state.trainable, size, rank, group)
            else:
                updates, opt_state = state.tx.update(grads, state.opt_state, state.trainable, g_norm)
                for k, p in state.trainable.items():
                    p.add_(updates[k])
        metrics = {"loss": loss_sum * inv, "grad_norm": g_norm}
        return dataclasses.replace(state, step=state.step + 1, opt_state=opt_state), metrics

    return train_step


def check_tensor_parallel(model: nn.Module, mesh):
    """The model axis of ``mesh`` as ``model`` was built for it: its ``tp``
    (None without a model axis). A mesh with ``model_size`` > 1 and a model
    built without that ``tp`` (or for another rank of it) raises
    ``ValueError``."""
    if mesh is None or mesh.model_size == 1:
        return None
    tp = getattr(model, "tp", None)
    if tp is None or tp.size != mesh.model_size or tp.rank != mesh.model_rank:
        raise ValueError(
            f"the mesh has a model axis of {mesh.model_size} (this process's model rank {mesh.model_rank}) but the "
            f"model was built with tp={tp}: build it with tp=mesh.tp (models.auto.load_model(mesh=mesh)), so that "
            "each rank holds its shard of the weights")
    return tp


def make_train_step(
    model: nn.Module,
    *,
    accum_steps: int = 1,
    loss_key: str = "loss",
    dropout: bool = True,
    mesh=None,
    zero_shard_opt_state: bool = False,
) -> Callable[[TrainState, Mapping[str, torch.Tensor]], tuple[TrainState, dict]]:
    """The train step: ``step(state, batch) -> (state, {"loss", "grad_norm"})``.

    ``batch``: every tensor has a leading micro-batch axis of ``accum_steps``;
    ``pixel_values`` is (accum, videos_per_micro, C, T, H, W). The loss and
    the trainable gradients are summed over the micro-batches and scaled by
    1 / accum_steps; ``grad_norm`` is the global norm before clipping. The
    trainable parameters are updated in place. The frozen weights live in the
    model (the JAX step takes them as an argument).

    With ``dropout`` (the recipe's: its Q-Former trains with its 0.1
    dropouts, and the frozen LM's dropouts are live too, as in JAX) the model
    runs in training mode and its masks come from a generator seeded with the
    step, as JAX's key is ``fold_in(PRNGKey(0), step)``: a resumed run draws
    what an uninterrupted one would. Without, it runs in eval mode.

    ``mesh`` (a ``parallel.Mesh``) makes it the data-parallel step over this
    process's rows of the batch, and ``zero_shard_opt_state`` the ZeRO-2 one
    over a state whose optimizer moments :func:`zero_sharded_opt_state`
    sharded (see the module's docstring).
    """

    def loss_fn(micro: Mapping[str, torch.Tensor], rng) -> torch.Tensor:
        return model(**_model_inputs(micro), dropout_rng=rng)[loss_key]

    return make_step(model, loss_fn, accum_steps=accum_steps, dropout=dropout, mesh=mesh,
                     zero_shard_opt_state=zero_shard_opt_state)


@torch.no_grad()
def eval_step(model: nn.Module, batch: Mapping[str, torch.Tensor], mesh=None) -> torch.Tensor:
    """The loss on one (micro-shaped) batch with dropout off. With ``mesh``
    and a process group up, ``batch`` is this process's rows and the loss is
    the masked mean over the data group's (the counts all-reduced)."""
    was_training = model.training
    model.eval()
    try:
        loss = model(**_model_inputs(batch))["loss"]
    finally:
        model.train(was_training)
    return global_mean(model, loss, batch["labels"], mesh)


def global_mean(model: nn.Module, loss: torch.Tensor, labels: torch.Tensor, mesh) -> torch.Tensor:
    """A rank's masked-mean ``loss`` over its (micro, S) ``labels`` ->
    the masked mean over the data group's (the rank's own without a group)."""
    if mesh is None or not dist.is_initialized():
        return loss
    count = valid_label_counts(labels[None], model.config.use_decoder_only_language_model)[0]
    total_loss, total = _all_reduce_sum([loss.float() * count, count], mesh.data_group)
    return total_loss / total.clamp(min=1)
