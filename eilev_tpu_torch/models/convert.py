"""Weights into the port's ``state_dict`` (counterpart of ``eilev_tpu/models/convert.py``).

Two sources: a flax parameter tree of the JAX package, and an HF checkpoint's
state dict: a whole ``VideoBlipForConditionalGeneration`` (``Blip2``-shaped,
such as kpyu/eilev-blip2-opt-2.7b), or the decoder-only LMs that
``generation/text_lm.TextLM`` loads.

The port's modules carry the flax module names, so the flax mapping is by rule:

- ``layers_<i>`` -> ``layers.<i>`` (an ``nn.ModuleList``);
- Dense ``kernel`` (in, out) -> ``weight`` (out, in);
- LayerNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``;
- an int8 layer's dict (one that holds ``w8``, from ``quantize_lm_params`` and
  its siblings) -> ``Int8Dense``/``Int8W8A8Dense``: ``w8`` (in, out) is
  transposed and its ``scale`` keeps its name;
- every other leaf (biases, ``patch_kernel``, ``query_tokens``, ...) keeps its
  name and layout.

The input is the flax ``params`` tree as nested dicts of numpy arrays, which is
what ``jax.tree.map(np.asarray, params)`` gives; no jax is needed here.

:func:`convert_llama` and :func:`convert_opt` map an HF ``LlamaForCausalLM``
or ``OPTForCausalLM`` state dict straight onto the port's LM state dict, with
q/k/v concatenated into ``qkv_proj`` along the output dim (the JAX
converters' packing); :func:`llama_config_from_hf` and
:func:`opt_config_from_hf` read the HF ``config.json`` dict.

:func:`convert_videoblip` maps a whole HF VideoBLIP state dict straight onto
the port's names (no flax tree between): HF and the port both keep Linear
weights (out, in); the vision patch conv (D, 3, p, p) becomes the unfold
layout (3*p*p, D); ``query_tokens`` (1, Q, D) becomes (Q, D). Keys the
query-only path never reads (the Q-Former's text-path FFN, the tied
``lm_head``) are left. :func:`load_hf_checkpoint` reads a ``save_pretrained``
directory through ``models/safetensors_io.py``, one tensor at a time onto
the device. :func:`convert_t5` maps HF's T5 names (``encoder.block.<i>.layer.<j>``)
onto the port's, which are the flax module's (``encoder.layers.<i>.self_attention``,
``ff``, and in the decoder ``cross_attention``); the ``embed_tokens`` copies of
``shared`` are left.
"""

from __future__ import annotations

import re
from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..configs import LlamaConfig, OPTConfig, T5Config, VideoBlipConfig
from .safetensors_io import SafetensorsDirectory

_LAYER = re.compile(r"^layers_(\d+)$")
_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def flax_to_state_dict(tree: Mapping[str, Any], prefix: str = "") -> dict[str, torch.Tensor]:
    """Map any flax sub-tree onto the matching port module's ``state_dict``."""
    out: dict[str, torch.Tensor] = {}
    int8_layer = "w8" in tree
    for name, value in tree.items():
        if isinstance(value, Mapping):
            m = _LAYER.match(name)
            part = f"layers.{m.group(1)}" if m else name
            out.update(flax_to_state_dict(value, f"{prefix}{part}."))
            continue
        arr = np.asarray(value)
        if name in ("kernel", "w8"):
            arr = arr.T
        if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: numpy has no torch bridge for it
            tensor = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            tensor = torch.from_numpy(np.array(arr))  # own, writable copy
        # an int8 layer's per-channel scale is not a LayerNorm scale
        key = name if int8_layer else _LEAF.get(name, name)
        out[prefix + key] = tensor.contiguous()
    return out


def params_from_jax(params: Mapping[str, Any], config) -> dict[str, torch.Tensor]:
    """The flax ``VideoBlipForConditionalGeneration`` params (OPT or T5 text
    config), the ``{"language_model": ...}`` tree of the text-only module
    ``generation/text_lm._TextOnlyModule`` (OPT or LLaMA text config), a
    ``TextEncoder``/``CrossEncoderModel`` tree (an ``eval.encoder.EncoderConfig``)
    or a ``VideoMAEForVideoClassification`` tree (a ``models.videomae.VideoMAEConfig``)
    -> the port's state dict. The port's modules carry the flax names, so this is
    :func:`flax_to_state_dict`'s rule for every family."""
    from ..eval.encoder import EncoderConfig
    from .videomae import VideoMAEConfig

    if isinstance(config, (EncoderConfig, VideoMAEConfig)):
        return flax_to_state_dict(params)
    if not isinstance(config.text_config, (OPTConfig, LlamaConfig, T5Config)):
        raise NotImplementedError(f"no port of the {type(config.text_config).__name__} language model")
    return flax_to_state_dict(params)


def state_dict_to_flax(module: torch.nn.Module) -> dict[str, Any]:
    """:func:`flax_to_state_dict`'s inverse for a port module whose names are
    the flax module's: nested dicts of numpy arrays (``layers.<i>`` ->
    ``layers_<i>``; an ``nn.Linear`` weight -> its transpose as ``kernel``,
    an ``nn.LayerNorm`` weight -> ``scale``, an ``nn.Embedding`` weight ->
    ``embedding``; every other parameter keeps its name and layout)."""
    leaf = {torch.nn.Linear: "kernel", torch.nn.LayerNorm: "scale", torch.nn.Embedding: "embedding"}
    tree: dict[str, Any] = {}
    for mod_name, mod in module.named_modules():
        path: list[str] = []
        for part in mod_name.split(".") if mod_name else []:
            if part.isdigit() and path and path[-1] == "layers":
                path[-1] = f"layers_{part}"
            else:
                path.append(part)
        for name, param in mod.named_parameters(recurse=False):
            arr = param.detach().cpu().numpy()
            kind = next((v for k, v in leaf.items() if isinstance(mod, k)), None)
            if name == "weight" and kind is not None:
                name, arr = kind, (arr.T if kind == "kernel" else arr)
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[name] = np.ascontiguousarray(arr)
    return tree


def _cat_qkv(sd: Mapping[str, torch.Tensor], prefix: str, bias: bool) -> dict[str, torch.Tensor]:
    """HF q/k/v projections -> the packed ``qkv_proj`` (output dim first)."""
    names = [f"{prefix}self_attn.{n}_proj" for n in ("q", "k", "v")]
    out = {f"{prefix}self_attn.qkv_proj.weight": torch.cat([sd[f"{n}.weight"] for n in names])}
    if bias:
        out[f"{prefix}self_attn.qkv_proj.bias"] = torch.cat([sd[f"{n}.bias"] for n in names])
    return out


def convert_llama(sd: Mapping[str, torch.Tensor], config: LlamaConfig) -> dict[str, torch.Tensor]:
    """HF ``LlamaForCausalLM`` state dict -> the port's ``LlamaForCausalLM`` state dict."""
    out = {
        "embed_tokens.weight": sd["model.embed_tokens.weight"],
        "norm.weight": sd["model.norm.weight"],
    }
    if not config.tie_word_embeddings:
        out["lm_head.weight"] = sd["lm_head.weight"]
    for i in range(config.num_hidden_layers):
        hf, ours = f"model.layers.{i}.", f"layers.{i}."
        for key, val in _cat_qkv(sd, hf, bias=False).items():
            out[ours + key[len(hf):]] = val
        for name in ("self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj",
                     "input_layernorm", "post_attention_layernorm"):
            out[f"{ours}{name}.weight"] = sd[f"{hf}{name}.weight"]
    return out


def convert_opt(sd: Mapping[str, torch.Tensor], config: OPTConfig) -> dict[str, torch.Tensor]:
    """HF ``OPTForCausalLM`` state dict -> the port's ``OPTForCausalLM`` state dict
    (its ``lm_head`` is tied to ``embed_tokens``)."""
    dec = "model.decoder."
    out = {
        "embed_tokens.weight": sd[dec + "embed_tokens.weight"],
        "embed_positions.weight": sd[dec + "embed_positions.weight"],
    }
    if config.word_embed_proj_dim != config.hidden_size:
        out["project_in.weight"] = sd[dec + "project_in.weight"]
        out["project_out.weight"] = sd[dec + "project_out.weight"]
    if config.do_layer_norm_before:
        for leaf in ("weight", "bias"):
            out[f"final_norm.{leaf}"] = sd[f"{dec}final_layer_norm.{leaf}"]
    for i in range(config.num_hidden_layers):
        hf, ours = f"{dec}layers.{i}.", f"layers.{i}."
        for key, val in _cat_qkv(sd, hf, bias=True).items():
            out[ours + key[len(hf):]] = val
        for name in ("self_attn.out_proj", "self_attn_layer_norm", "final_layer_norm", "fc1", "fc2"):
            for leaf in ("weight", "bias"):
                out[f"{ours}{name}.{leaf}"] = sd[f"{hf}{name}.{leaf}"]
    return out


def llama_config_from_hf(hf: Mapping[str, Any]) -> LlamaConfig:
    """:class:`LlamaConfig` from an HF ``config.json`` dict."""
    eos = hf.get("eos_token_id", 2)
    if isinstance(eos, list):  # llama-3 style lists
        eos = eos[0]
    return LlamaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf.get("max_position_embeddings", 4096),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        rope_theta=hf.get("rope_theta", 10000.0),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        bos_token_id=hf.get("bos_token_id", 1),
        eos_token_id=eos,
        pad_token_id=hf.get("pad_token_id") or 0,
    )


def opt_config_from_hf(hf: Mapping[str, Any]) -> OPTConfig:
    """:class:`OPTConfig` from an HF ``config.json`` dict (the fields ``TextLM`` reads)."""
    return OPTConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        ffn_dim=hf["ffn_dim"],
        max_position_embeddings=hf["max_position_embeddings"],
        word_embed_proj_dim=hf.get("word_embed_proj_dim", hf["hidden_size"]),
        do_layer_norm_before=hf.get("do_layer_norm_before", True),
        activation_function=hf.get("activation_function", "relu"),
        bos_token_id=hf.get("bos_token_id", 2),
        eos_token_id=hf.get("eos_token_id", 2),
        pad_token_id=hf.get("pad_token_id", 1),
    )


class _Prefixed(Mapping):
    """``sd`` seen under ``prefix``: ``view[k]`` is ``sd[prefix + k]``."""

    def __init__(self, sd: Mapping[str, torch.Tensor], prefix: str):
        self.sd, self.prefix = sd, prefix

    def __getitem__(self, key: str) -> torch.Tensor:
        return self.sd[self.prefix + key]

    def __contains__(self, key: object) -> bool:
        return isinstance(key, str) and (self.prefix + key) in self.sd

    def __iter__(self):
        n = len(self.prefix)
        return (k[n:] for k in self.sd if k.startswith(self.prefix))

    def __len__(self) -> int:
        return sum(1 for _ in self)


def _param(out: dict, sd: Mapping[str, torch.Tensor], src: str, dst: str) -> None:
    """``src.weight`` (and ``src.bias`` where the checkpoint has one) -> ``dst.*``."""
    out[f"{dst}.weight"] = sd[f"{src}.weight"]
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = sd[f"{src}.bias"]


def _under(prefix: str, sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {prefix + k: v for k, v in sd.items()}


def convert_vision(sd: Mapping[str, torch.Tensor], num_layers: int) -> dict[str, torch.Tensor]:
    """``vision_model.*`` of an HF Blip2 checkpoint -> the port's ``VisionModel``."""
    p = sd["embeddings.patch_embedding.weight"]  # (D, 3, p, p)
    d = p.shape[0]
    out = {
        # (D,3,p,p) -> (3,p,p,D) -> (3*p*p, D): the unfold layout (channel-major
        # within a patch) of VisionEmbeddings
        "embeddings.patch_kernel": p.permute(1, 2, 3, 0).reshape(-1, d).contiguous(),
        "embeddings.patch_bias": sd["embeddings.patch_embedding.bias"],
        "embeddings.class_embedding": sd["embeddings.class_embedding"].reshape(d),
        "embeddings.position_embedding": sd["embeddings.position_embedding"].reshape(-1, d),
    }
    _param(out, sd, "post_layernorm", "post_layernorm")
    for i in range(num_layers):
        hf, ours = f"encoder.layers.{i}.", f"layers.{i}."
        for name in ("layer_norm1", "layer_norm2", "self_attn.qkv", "self_attn.projection", "mlp.fc1", "mlp.fc2"):
            _param(out, sd, hf + name, ours + name)
    return out


def convert_qformer(
    sd: Mapping[str, torch.Tensor], num_layers: int, cross_attention_frequency: int
) -> dict[str, torch.Tensor]:
    """``qformer.*`` -> the port's query-only ``QFormerModel``: layer i carries
    cross-attention where ``i % cross_attention_frequency == 0``."""
    out: dict[str, torch.Tensor] = {}
    _param(out, sd, "layernorm", "layernorm")
    for i in range(num_layers):
        hf, ours = f"encoder.layer.{i}.", f"layers.{i}."
        blocks = ["attention"] + (["crossattention"] if i % cross_attention_frequency == 0 else [])
        for blk in blocks:
            for name in ("attention.query", "attention.key", "attention.value", "output.dense"):
                _param(out, sd, f"{hf}{blk}.{name}", f"{ours}{blk}.{name}")
            _param(out, sd, f"{hf}{blk}.output.LayerNorm", f"{ours}{blk}.output.layer_norm")
        _param(out, sd, hf + "intermediate_query.dense", ours + "ffn_query.intermediate")
        _param(out, sd, hf + "output_query.dense", ours + "ffn_query.output")
        _param(out, sd, hf + "output_query.LayerNorm", ours + "ffn_query.layer_norm")
    return out


#: (HF block sub-layer, the port's module) of a T5 encoder and decoder layer
T5_ENCODER_PARTS = (("layer.0", "self_attention"), ("layer.1", "ff"))
T5_DECODER_PARTS = (("layer.0", "self_attention"), ("layer.1", "cross_attention"), ("layer.2", "ff"))
T5_ATTENTION_NAMES = {"self_attention": "SelfAttention", "cross_attention": "EncDecAttention"}


def convert_t5(sd: Mapping[str, torch.Tensor], config: T5Config) -> dict[str, torch.Tensor]:
    """HF ``T5ForConditionalGeneration`` state dict -> the port's
    ``T5ForConditionalGeneration`` state dict (each sub-layer's RMS norm
    ``layer_norm``, its attention's ``q``/``k``/``v``/``o`` and layer 0's
    ``relative_attention_bias``, the FFN's ``wi_0``/``wi_1`` or ``wi``, and
    ``wo``)."""
    out = {"shared.weight": sd["shared.weight"]}
    if not config.tie_word_embeddings:
        out["lm_head.weight"] = sd["lm_head.weight"]
    ff = ("wi_0", "wi_1", "wo") if config.is_gated_act else ("wi", "wo")
    for stack, n_layers, parts in (("encoder", config.num_layers, T5_ENCODER_PARTS),
                                   ("decoder", config.num_decoder_layers, T5_DECODER_PARTS)):
        out[f"{stack}.final_layer_norm.weight"] = sd[f"{stack}.final_layer_norm.weight"]
        for i in range(n_layers):
            for hf_part, ours in parts:
                hf, dst = f"{stack}.block.{i}.{hf_part}.", f"{stack}.layers.{i}.{ours}."
                out[dst + "layer_norm.weight"] = sd[hf + "layer_norm.weight"]
                if ours == "ff":
                    for name in ff:
                        out[f"{dst}{name}.weight"] = sd[f"{hf}DenseReluDense.{name}.weight"]
                    continue
                att = f"{hf}{T5_ATTENTION_NAMES[ours]}."
                names = ["q", "k", "v", "o"]
                if f"{att}relative_attention_bias.weight" in sd:
                    names.append("relative_attention_bias")
                for name in names:
                    out[f"{dst}attention.{name}.weight"] = sd[f"{att}{name}.weight"]
    return out


def convert_videoblip(state_dict: Mapping[str, torch.Tensor], config: VideoBlipConfig) -> dict[str, torch.Tensor]:
    """A full HF ``VideoBlipForConditionalGeneration`` state dict -> the
    port's ``VideoBlipForConditionalGeneration`` state dict. Each HF tensor is
    looked up once, so a lazy mapping (``safetensors_io.TensorView``) reads
    the checkpoint one tensor at a time."""
    q, qd = config.num_query_tokens, config.qformer_config.hidden_size
    out = {"query_tokens": state_dict["query_tokens"].reshape(q, qd)}
    out.update(_under("vision_model.vision.", convert_vision(
        _Prefixed(state_dict, "vision_model."), config.vision_config.num_hidden_layers)))
    out.update(_under("qformer.", convert_qformer(
        _Prefixed(state_dict, "qformer."), config.qformer_config.num_hidden_layers,
        config.qformer_config.cross_attention_frequency)))
    _param(out, state_dict, "language_projection", "language_projection")
    convert_lm = convert_opt if isinstance(config.text_config, OPTConfig) else convert_t5
    out.update(_under("language_model.", convert_lm(_Prefixed(state_dict, "language_model."), config.text_config)))
    return out


def load_hf_checkpoint(
    path: str, config: VideoBlipConfig, *, dtype: Optional[torch.dtype] = None, device="cpu"
) -> dict[str, torch.Tensor]:
    """A ``save_pretrained`` directory (its ``*.safetensors``, one file or
    shards) -> the port's state dict on ``device``, every floating-point
    tensor cast to ``dtype`` (default: as stored). Raises
    ``FileNotFoundError`` when the directory holds no ``*.safetensors``."""
    with SafetensorsDirectory(path) as files:
        return convert_videoblip(files.view(dtype=dtype, device=device), config)
