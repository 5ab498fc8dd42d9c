"""Weights into the port's ``state_dict`` (counterpart of ``eilev_tpu/models/convert.py``).

Two sources: a flax parameter tree of the JAX package, and an HF checkpoint's
state dict for the decoder-only LMs that ``generation/text_lm.TextLM`` loads.

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
:func:`opt_config_from_hf` read the HF ``config.json`` dict. Loading a whole
VideoBLIP HF checkpoint is not ported yet.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from ..configs import LlamaConfig, OPTConfig, VideoBlipConfig

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


def params_from_jax(params: Mapping[str, Any], config: VideoBlipConfig) -> dict[str, torch.Tensor]:
    """The flax ``VideoBlipForConditionalGeneration`` params (OPT text config),
    or the ``{"language_model": ...}`` tree of the text-only module
    ``generation/text_lm._TextOnlyModule`` (OPT or LLaMA text config) -> the
    port's state dict."""
    if not isinstance(config.text_config, (OPTConfig, LlamaConfig)):
        raise NotImplementedError("only the OPT and LLaMA language models are ported")
    return flax_to_state_dict(params)


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
