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

``zero_sharded_opt_state`` (ZeRO-2) is not ported: it waits with the
port's ``parallel/``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..ops.dropout import DropoutRng

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
    params) -> (updates, state)``, over name -> tensor maps."""

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


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(g * g) for g in tree.values()))


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

    def update(grads: Params, state: dict, params: Params) -> tuple[Params, dict]:
        if max_norm is not None:
            # clip_by_global_norm: no epsilon; a norm below max_norm passes as is
            g_norm = global_norm(grads)
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

    def update(grads: Params, state: dict, params: Params) -> tuple[Params, dict]:
        updates, inner = tx.update(grads, state["inner"], params)
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


def make_train_step(
    model: nn.Module,
    *,
    accum_steps: int = 1,
    loss_key: str = "loss",
    dropout: bool = True,
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
    """

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]) -> tuple[TrainState, dict]:
        names = list(state.trainable)
        params = [state.trainable[k] for k in names]
        device = params[0].device
        model.train(dropout)
        rng = DropoutRng.seeded(state.step, device) if dropout else None
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        grad_sum = None
        for i in range(accum_steps):
            micro = _model_inputs({k: v[i] for k, v in batch.items()})
            loss = model(**micro, dropout_rng=rng)[loss_key]
            grads = torch.autograd.grad(loss, params)
            loss_sum = loss_sum + loss.detach()
            grad_sum = list(grads) if grad_sum is None else [a + b for a, b in zip(grad_sum, grads)]
        inv = 1.0 / accum_steps
        grads = {k: g * inv for k, g in zip(names, grad_sum)}
        with torch.no_grad():
            updates, opt_state = state.tx.update(grads, state.opt_state, state.trainable)
            for k, p in state.trainable.items():
                p.add_(updates[k])
        metrics = {"loss": loss_sum * inv, "grad_norm": global_norm(grads)}
        return dataclasses.replace(state, step=state.step + 1, opt_state=opt_state), metrics

    return train_step


@torch.no_grad()
def eval_step(model: nn.Module, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The loss on one (micro-shaped) batch with dropout off."""
    was_training = model.training
    model.eval()
    try:
        return model(**_model_inputs(batch))["loss"]
    finally:
        model.train(was_training)
