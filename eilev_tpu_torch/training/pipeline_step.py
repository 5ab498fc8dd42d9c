"""Pipeline-parallel train and eval steps (counterpart of ``eilev_tpu/training/pipeline_step.py``).

The LM trunk (the frozen decoder stack: OPT's layers, or T5's encoder and
decoder layers) runs as a GPipe schedule over the mesh's stage devices
(``parallel/pipeline.make_pipeline_trunk``); everything around it (the
vision tower, Q-Former, projection, embeddings, final norms, lm head) runs
on the process's own device (``mesh.device``), as in the plain step. The
trainable gradients (Q-Former, projection, query tokens) flow back through
the trunk and its copies between devices.

As in JAX, the trunk runs the FROZEN LM layers without dropout: on frozen
weights it is a regularisation detail, and it keeps the schedule free of
mask state. The Q-Former's dropout (the trainable part) stays active. The
trunk's layers take the plain attention path, as every training forward
does: the attention kernels have no backward and refuse a graph
(``ops/fused_attention.refuse_grad``).

The port's step conventions hold: the frozen weights live in the model
(the layer modules are grouped into per-stage blocks, not copied), the
trainable ones are updated in place, and data parallelism and ZeRO come
from the shared step (``training/train_state.make_step``): each
data-replica process drives its own stages.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch
from torch import nn

from ..configs import OPTConfig
from ..models.video_blip import masked_cross_entropy, shift_tokens_right
from ..parallel.pipeline import (
    make_pipeline_trunk,
    opt_layer_apply,
    stack_layer_params,
    t5_decoder_layer_apply,
    t5_encoder_layer_apply,
    unstack_layer_params,
)
from .train_state import global_mean, make_step, partition_params

_REL_BIAS = "relative_attention_bias"


def _stacks(config) -> dict:
    """The layer stacks of the LM: key -> (module path under the model, drop_key)."""
    if isinstance(config.text_config, OPTConfig):
        return {"lm": ("language_model.layers", None)}
    return {"enc": ("language_model.encoder.layers", _REL_BIAS),
            "dec": ("language_model.decoder.layers", _REL_BIAS)}


def pp_partition_frozen(model: nn.Module, num_stages: int) -> tuple[dict, dict]:
    """Split the frozen weights into (rest, stacked).

    ``rest`` (name -> tensor) holds every frozen parameter outside the LM
    layer stacks, with T5's layer-0 relative-position bias tables at their
    own names (the bias is computed outside the trunk). ``stacked`` holds
    ``{"lm": ...}`` (OPT) or ``{"enc": ..., "dec": ...}`` (T5)
    :class:`~..parallel.pipeline.StackedLayers` of ``num_stages`` blocks of
    the model's own layer modules, ready for ``shard_stacked``."""
    _, frozen = partition_params(dict(model.named_parameters()))
    stacked, prefixes = {}, []
    for key, (path, drop_key) in _stacks(model.config).items():
        stacked[key] = stack_layer_params(model.get_submodule(path), num_stages, drop_key=drop_key)
        prefixes.append(path + ".")
    rest = {k: v for k, v in frozen.items() if not k.startswith(tuple(prefixes)) or _REL_BIAS in k}
    return rest, stacked


def pp_unpartition_frozen(rest: Mapping[str, torch.Tensor], stacked: dict, config) -> dict:
    """Inverse of :func:`pp_partition_frozen`: the whole frozen name ->
    tensor map (``Trainer.current_params``, checkpoint export)."""
    full = dict(rest)
    for key, (path, _) in _stacks(config).items():
        for i, layer in enumerate(unstack_layer_params(stacked[key])):
            for name, p in layer.named_parameters():
                full.setdefault(f"{path}.{i}.{name}", p)
    return full


def make_pp_forward(model: nn.Module, mesh, *, num_microbatches: int) -> Callable:
    """``forward(stacked, micro, dropout_rng) -> loss`` with the LM trunk(s)
    pipelined over ``mesh.devices``; ``micro`` is one micro-batch of this
    process's rows."""
    cfg = model.config
    is_opt = isinstance(cfg.text_config, OPTConfig)
    if is_opt:
        trunk = make_pipeline_trunk(opt_layer_apply(), mesh, num_microbatches=num_microbatches)
    else:
        enc_trunk = make_pipeline_trunk(t5_encoder_layer_apply(), mesh, num_microbatches=num_microbatches,
                                        const_extras=1)
        dec_trunk = make_pipeline_trunk(t5_decoder_layer_apply(), mesh, num_microbatches=num_microbatches,
                                        batch_extras=2, const_extras=1)

    def forward(stacked: dict, micro: Mapping[str, torch.Tensor], rng) -> torch.Tensor:
        ids, labels = micro["input_ids"], micro["labels"]
        mask = micro.get("attention_mask")
        mask = torch.ones_like(ids, dtype=torch.int32) if mask is None else mask.to(torch.int32)
        embeds = model.embed_and_scatter(ids, micro.get("pixel_values"), micro.get("video_input_mask"),
                                         dropout_rng=rng)
        if is_opt:
            x = trunk(stacked["lm"], model.lm_pre_layers(embeds, mask), mask)
            logits = model.lm_post_layers(x)
            return masked_cross_entropy(logits[:, :-1], labels[:, 1:])
        tcfg = cfg.text_config
        enc_bias = model.t5_encoder_rel_bias(embeds.shape[1])
        enc_h = model.t5_encoder_post(enc_trunk(stacked["enc"], embeds, mask, enc_bias))
        dec_ids = shift_tokens_right(labels, tcfg.pad_token_id, tcfg.decoder_start_token_id)
        dec_mask = torch.ones_like(dec_ids, dtype=torch.int32)
        dec_bias = model.t5_decoder_rel_bias(dec_ids.shape[1])
        hd = dec_trunk(stacked["dec"], model.lm_embed(dec_ids), dec_mask, enc_h, mask, dec_bias)
        return masked_cross_entropy(model.t5_decoder_post(hd), labels)

    return forward


def make_pp_train_step(
    model: nn.Module,
    mesh,
    stacked: dict,
    *,
    num_microbatches: int,
    accum_steps: int = 1,
    dropout: bool = True,
    zero_shard_opt_state: bool = False,
) -> Callable:
    """The pipeline-parallel ``train_state.make_train_step``: ``step(state,
    batch) -> (state, {"loss", "grad_norm"})`` over ``stacked`` (from
    :func:`pp_partition_frozen`, placed by ``shard_stacked``). With a
    process group up it is also the data-parallel (and ZeRO) step over the
    data group of ``mesh``."""
    forward = make_pp_forward(model, mesh, num_microbatches=num_microbatches)
    return make_step(model, lambda micro, rng: forward(stacked, micro, rng), accum_steps=accum_steps,
                     dropout=dropout, mesh=mesh, zero_shard_opt_state=zero_shard_opt_state)


def make_pp_eval_step(model: nn.Module, mesh, stacked: dict, *, num_microbatches: int) -> Callable:
    """``eval(batch) -> loss`` with the trunk pipelined, dropout off; the
    masked mean over the data group's rows."""
    forward = make_pp_forward(model, mesh, num_microbatches=num_microbatches)

    @torch.no_grad()
    def eval_step(batch: Mapping[str, Any]) -> torch.Tensor:
        was_training = model.training
        model.eval()
        try:
            loss = forward(stacked, batch, None)
        finally:
            model.train(was_training)
        return global_mean(model, loss, batch["labels"], mesh)

    return eval_step

