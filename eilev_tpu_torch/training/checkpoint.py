"""Native training checkpoints (counterpart of ``eilev_tpu/training/checkpoint.py``,
its orbax part).

A checkpoint is the directory ``<ckpt_dir>/<step>/`` holding one
``checkpoint.pt``: ``{step, trainable, opt_state}`` and, when there is one,
the best-eval snapshot (``best_loss``, ``best_trainable``) that
``load_best_model_at_end`` needs after a preemption. The frozen towers never
change, so only the trainable subtree is written. It is written with
``torch.save`` into a temporary directory that is then renamed, so a
directory named by a step is always whole, and read with
``torch.load(weights_only=True)``: the payload is tensors, dicts and numbers
only.

Under data and tensor parallelism the world's rank 0 writes, and what it
writes is the whole state: :func:`whole_state` (every rank takes part)
all-gathers the optimizer moments ZeRO sharded over the data group
(``train_state.full_opt_state``) and then the trainable leaves, moments and
best snapshot that tensor parallelism sliced over the model group
(``parallel/tensor.unshard_state_dict``). So a checkpoint does not depend on
the mesh it was written on: :func:`restore_checkpoint` reads the whole
state and, given a mesh with a model axis, cuts each leaf to the rank's
slice (``parallel/tensor.shard_state_dict``), and
``train_state.zero_sharded_opt_state`` cuts the moments to the rows of the
data group that restores it, of any size, one device included.

Interchange with the HF ecosystem goes through safetensors:
``models/convert.load_hf_checkpoint`` imports, and :func:`export_hf_safetensors`
writes the exact inverse mapping (:func:`hf_state_dict`) as fp32, so a
trained model goes back to the torch reference and to either package's
``load_model``.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Mapping, Optional

import torch
from torch import nn

from ..configs import OPTConfig, T5Config, VideoBlipConfig
from ..models.convert import T5_ATTENTION_NAMES, T5_DECODER_PARTS, T5_ENCODER_PARTS
from ..models.safetensors_io import save_file
from ..parallel.distributed import is_primary
from ..parallel.tensor import shard_state_dict, unshard_state_dict
from .train_state import TrainState, full_opt_state

CHECKPOINT_FILE = "checkpoint.pt"


def _to(tree: Any, device) -> Any:
    """Every tensor of a nested dict/list copied to ``device`` (a fresh copy
    even where it is already there: a snapshot)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def _payload(state: TrainState, best: Optional[tuple]) -> dict:
    """The host snapshot of what a checkpoint holds."""
    payload = {
        "step": int(state.step),
        "trainable": _to(state.trainable, "cpu"),
        "opt_state": _to(state.opt_state, "cpu"),
    }
    if best is not None:
        best_loss, best_trainable = best
        payload["best_loss"] = float(best_loss)
        payload["best_trainable"] = _to(best_trainable, "cpu")
    return payload


def _write(ckpt_dir: str, payload: dict) -> str:
    path = os.path.join(os.path.abspath(ckpt_dir), str(payload["step"]))
    tmp = os.path.join(os.path.abspath(ckpt_dir), f".{payload['step']}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, CHECKPOINT_FILE))
    shutil.rmtree(path, ignore_errors=True)  # a save of the same step replaces it
    os.replace(tmp, path)
    return path


def _by_name(fn, tree: Any, names) -> Any:
    """``fn(name, tensor)`` over every tensor of ``tree`` held under a key in
    ``names`` (the trainable leaves, the moments, the EMA); the rest kept."""
    if isinstance(tree, dict):
        return {k: fn(k, v) if k in names and isinstance(v, torch.Tensor) else _by_name(fn, v, names)
                for k, v in tree.items()}
    return tree


def _zero_sharded(state: TrainState) -> bool:
    """Whether a moment of ``state`` holds fewer rows than its parameter
    (ZeRO's layout)."""
    found = []
    _by_name(lambda k, t: found.append(t.shape != state.trainable[k].shape), state.opt_state, state.trainable)
    return any(found)


def whole_state(state: TrainState, mesh, config, best: Optional[tuple] = None) -> tuple[TrainState, Optional[tuple]]:
    """``(state, best)`` as a checkpoint holds them, whole, on every rank: the
    ZeRO rows all-gathered over the data group, then the tensor-parallel
    slices over the model group (a collective: every rank calls it).
    ``config`` is the model's (its towers' layouts); ``best`` is
    (best_eval_loss, best_trainable) or None."""
    if mesh is None:
        return state, best
    if mesh.data_size > 1 and _zero_sharded(state):
        state = dataclasses.replace(state, opt_state=full_opt_state(state, mesh))
    tp = mesh.tp
    if tp is None:
        return state, best
    names = set(state.trainable)

    def gather(name, t):
        return unshard_state_dict({name: t}, config, tp)[name]

    state = dataclasses.replace(state, trainable=unshard_state_dict(state.trainable, config, tp),
                                opt_state=_by_name(gather, state.opt_state, names))
    if best is not None:
        best = (best[0], unshard_state_dict(best[1], config, tp))
    return state, best


def save_checkpoint(
    ckpt_dir: str, state: TrainState, *, keep: int = 3, best: Optional[tuple] = None, mesh=None,
    config: Optional[VideoBlipConfig] = None,
) -> str:
    """Save {step, trainable, opt_state} under ckpt_dir/<step>; prune to the
    ``keep`` newest (reference recipe: save_total_limit 3).

    ``best`` = (best_eval_loss, best_trainable) persists the
    load_best_model_at_end snapshot so it survives preemption. With a
    ``mesh`` (a ``parallel.Mesh``; ``config``, the model's, under a model
    axis) every rank calls it: the whole state is gathered
    (:func:`whole_state`) and the world's rank 0 writes it. Returns the
    directory's path."""
    state, best = whole_state(state, mesh, config, best)
    if mesh is not None and not is_primary():
        return os.path.join(os.path.abspath(ckpt_dir), str(int(state.step)))
    path = _write(ckpt_dir, _payload(state, best))
    _prune(ckpt_dir, keep)
    return path


class AsyncCheckpointWriter:
    """Checkpoint saves that overlap training compute: ``save`` snapshots the
    state to the host (a copy, so the next step may update the parameters in
    place) and writes it on a background thread. One save is in flight at a
    time: the next ``save`` (or ``wait``) waits for the last, and raises what
    it raised. ``close`` waits and stops the thread."""

    def __init__(self) -> None:
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None

    def save(
        self, ckpt_dir: str, state: TrainState, *, keep: int = 3, best: Optional[tuple] = None
    ) -> str:
        self.wait()
        payload = _payload(state, best)
        path = os.path.join(os.path.abspath(ckpt_dir), str(payload["step"]))

        def write() -> None:
            _write(ckpt_dir, payload)
            _prune(ckpt_dir, keep)

        self._pending = self._pool.submit(write)
        return path

    def wait(self) -> None:
        """Block until the in-flight save (if any) is written and pruned."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir) if d.isdigit()]
    if not steps:
        return None
    return os.path.join(os.path.abspath(ckpt_dir), str(max(steps)))


def restore_checkpoint(path: str, state: TrainState, *, with_best: bool = False, mesh=None,
                       config: Optional[VideoBlipConfig] = None):
    """Restore into ``state``: the trainable parameters are overwritten in
    place (they are the model's), the optimizer state is moved to their
    device. Returns the new state; with ``with_best`` ``(state, best)``,
    where best is (best_eval_loss, best_trainable) if the checkpoint carries
    one, else None. Under a ``mesh`` with a model axis (``config``, the
    model's) every leaf of the whole checkpoint is cut to this rank's slice
    first; the moments come back whole on the data axis (ZeRO cuts them with
    ``train_state.zero_sharded_opt_state``)."""
    payload = torch.load(os.path.join(path, CHECKPOINT_FILE), map_location="cpu", weights_only=True)
    tp = None if mesh is None else mesh.tp
    if tp is not None:
        names = set(payload["trainable"])

        def cut(name, t):
            return shard_state_dict({name: t}, config, tp)[name]

        payload["trainable"] = shard_state_dict(payload["trainable"], config, tp)
        payload["opt_state"] = _by_name(cut, payload["opt_state"], names)
        if "best_trainable" in payload:
            payload["best_trainable"] = shard_state_dict(payload["best_trainable"], config, tp)
    saved = payload["trainable"]
    if set(saved) != set(state.trainable):
        raise ValueError(
            f"checkpoint {path} holds other trainable parameters: "
            f"{sorted(set(saved) ^ set(state.trainable))[:5]} ..."
        )
    device = next(iter(state.trainable.values())).device
    with torch.no_grad():
        for k, p in state.trainable.items():
            p.copy_(saved[k])
    new_state = TrainState(
        step=int(payload["step"]), trainable=state.trainable,
        opt_state=_to(payload["opt_state"], device), tx=state.tx,
    )
    if not with_best:
        return new_state
    best = None
    if "best_trainable" in payload:
        best = (float(payload["best_loss"]), _to(payload["best_trainable"], device))
    return new_state, best


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(s)), ignore_errors=True)


# ---------------------------------------------------------------------------
# HF safetensors export (inverse of models/convert.py:convert_videoblip)
# ---------------------------------------------------------------------------


def _put(out: dict, sd: Mapping[str, torch.Tensor], ours: str, hf: str) -> None:
    """``ours.weight`` (and ``ours.bias`` where there is one) -> ``hf.*``."""
    out[f"{hf}.weight"] = sd[f"{ours}.weight"]
    if f"{ours}.bias" in sd:
        out[f"{hf}.bias"] = sd[f"{ours}.bias"]


def hf_state_dict(model: nn.Module, config: VideoBlipConfig) -> dict[str, torch.Tensor]:
    """A port ``VideoBlipForConditionalGeneration`` -> the HF
    ``VideoBlipForConditionalGeneration`` tensor names, each tensor as the
    model holds it (views where the layout allows). The model must hold
    float weights: a quantized one raises ``ValueError``. A tensor-parallel
    model's slices are gathered first (a collective over its model group)."""
    sd = model.state_dict()
    if getattr(model, "tp", None) is not None:
        sd = unshard_state_dict(sd, config, model.tp)
    if any(k.endswith(".w8") for k in sd):
        raise ValueError("hf_state_dict needs float weights: export the model before quantizing it")
    out: dict[str, torch.Tensor] = {}
    qd = config.qformer_config.hidden_size
    out["query_tokens"] = sd["query_tokens"].reshape(1, config.num_query_tokens, qd)

    vis, p = "vision_model.vision.", config.vision_config.patch_size
    kernel = sd[vis + "embeddings.patch_kernel"]  # (3*p*p, D)
    d = kernel.shape[1]
    out["vision_model.embeddings.patch_embedding.weight"] = kernel.reshape(3, p, p, d).permute(3, 0, 1, 2)
    out["vision_model.embeddings.patch_embedding.bias"] = sd[vis + "embeddings.patch_bias"]
    out["vision_model.embeddings.class_embedding"] = sd[vis + "embeddings.class_embedding"].reshape(1, 1, d)
    out["vision_model.embeddings.position_embedding"] = sd[vis + "embeddings.position_embedding"][None]
    _put(out, sd, vis + "post_layernorm", "vision_model.post_layernorm")
    for i in range(config.vision_config.num_hidden_layers):
        for name in ("layer_norm1", "layer_norm2", "self_attn.qkv", "self_attn.projection", "mlp.fc1", "mlp.fc2"):
            _put(out, sd, f"{vis}layers.{i}.{name}", f"vision_model.encoder.layers.{i}.{name}")

    _put(out, sd, "qformer.layernorm", "qformer.layernorm")
    freq = config.qformer_config.cross_attention_frequency
    for i in range(config.qformer_config.num_hidden_layers):
        ours, hf = f"qformer.layers.{i}.", f"qformer.encoder.layer.{i}."
        for blk in ["attention"] + (["crossattention"] if i % freq == 0 else []):
            for name in ("attention.query", "attention.key", "attention.value", "output.dense"):
                _put(out, sd, f"{ours}{blk}.{name}", f"{hf}{blk}.{name}")
            _put(out, sd, f"{ours}{blk}.output.layer_norm", f"{hf}{blk}.output.LayerNorm")
        _put(out, sd, ours + "ffn_query.intermediate", hf + "intermediate_query.dense")
        _put(out, sd, ours + "ffn_query.output", hf + "output_query.dense")
        _put(out, sd, ours + "ffn_query.layer_norm", hf + "output_query.LayerNorm")

    _put(out, sd, "language_projection", "language_projection")

    if isinstance(config.text_config, OPTConfig):
        _put_opt(out, sd, config.text_config)
    else:
        _put_t5(out, sd, config.text_config)
    return out


def _put_opt(out: dict, sd: Mapping[str, torch.Tensor], tcfg: OPTConfig) -> None:
    lm, base = "language_model.", "language_model.model.decoder."
    out[base + "embed_tokens.weight"] = sd[lm + "embed_tokens.weight"]
    out["language_model.lm_head.weight"] = out[base + "embed_tokens.weight"]
    out[base + "embed_positions.weight"] = sd[lm + "embed_positions.weight"]
    if tcfg.word_embed_proj_dim != tcfg.hidden_size:
        _put(out, sd, lm + "project_in", base + "project_in")
        _put(out, sd, lm + "project_out", base + "project_out")
    if tcfg.do_layer_norm_before:
        _put(out, sd, lm + "final_norm", base + "final_layer_norm")
    d = tcfg.hidden_size
    for i in range(tcfg.num_hidden_layers):
        ours, hf = f"{lm}layers.{i}.", f"{base}layers.{i}."
        # the packed qkv projection splits back into HF's three
        qkv_w, qkv_b = sd[ours + "self_attn.qkv_proj.weight"], sd[ours + "self_attn.qkv_proj.bias"]
        for j, proj in enumerate(("q_proj", "k_proj", "v_proj")):
            out[f"{hf}self_attn.{proj}.weight"] = qkv_w[j * d : (j + 1) * d]
            out[f"{hf}self_attn.{proj}.bias"] = qkv_b[j * d : (j + 1) * d]
        for name in ("self_attn.out_proj", "self_attn_layer_norm", "final_layer_norm", "fc1", "fc2"):
            _put(out, sd, ours + name, hf + name)


def _put_t5(out: dict, sd: Mapping[str, torch.Tensor], tcfg: T5Config) -> None:
    """The inverse of ``models/convert.py:convert_t5``, with ``shared`` also
    written as both stacks' ``embed_tokens``, as HF saves it."""
    base = "language_model."
    out[base + "shared.weight"] = sd[base + "shared.weight"]
    out[base + "encoder.embed_tokens.weight"] = out[base + "shared.weight"]
    out[base + "decoder.embed_tokens.weight"] = out[base + "shared.weight"]
    if not tcfg.tie_word_embeddings:
        out[base + "lm_head.weight"] = sd[base + "lm_head.weight"]
    ff = ("wi_0", "wi_1", "wo") if tcfg.is_gated_act else ("wi", "wo")
    for stack, n_layers, parts in (("encoder", tcfg.num_layers, T5_ENCODER_PARTS),
                                   ("decoder", tcfg.num_decoder_layers, T5_DECODER_PARTS)):
        out[f"{base}{stack}.final_layer_norm.weight"] = sd[f"{base}{stack}.final_layer_norm.weight"]
        for i in range(n_layers):
            for hf_part, ours in parts:
                hf, src = f"{base}{stack}.block.{i}.{hf_part}.", f"{base}{stack}.layers.{i}.{ours}."
                out[hf + "layer_norm.weight"] = sd[src + "layer_norm.weight"]
                if ours == "ff":
                    for name in ff:
                        out[f"{hf}DenseReluDense.{name}.weight"] = sd[f"{src}{name}.weight"]
                    continue
                att = f"{hf}{T5_ATTENTION_NAMES[ours]}."
                for name in ("q", "k", "v", "o", "relative_attention_bias"):
                    if f"{src}attention.{name}.weight" in sd:
                        out[f"{att}{name}.weight"] = sd[f"{src}attention.{name}.weight"]


def export_hf_safetensors(model: nn.Module, config: VideoBlipConfig, path: str,
                          dtype: torch.dtype = torch.float32) -> str:
    """Write ``<path>/model.safetensors`` (``dtype``, fp32 by default,
    contiguous; the tied ``lm_head`` written out as HF saves it) loadable by
    the torch reference and by both packages' ``load_model`` once a
    ``config.json`` sits beside it. Returns the file's path. A
    tensor-parallel model is gathered whole (every rank of the process group
    calls it) and the world's rank 0 writes it."""
    sharded = getattr(model, "tp", None) is not None
    sd = {k: v.detach().to(dtype).contiguous() for k, v in hf_state_dict(model, config).items()}
    f = os.path.join(path, "model.safetensors")
    if not sharded or is_primary():
        os.makedirs(path, exist_ok=True)
        save_file(sd, f)
    return f
