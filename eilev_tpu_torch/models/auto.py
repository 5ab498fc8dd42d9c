"""Model loading: HF ``save_pretrained`` directories -> (model, config)
(counterpart of ``eilev_tpu/models/auto.py``).

Reads the checkpoint layout of the original EILeV (``config.json`` +
``*.safetensors``, e.g. kpyu/eilev-blip2-opt-2.7b downloaded locally) into a
port ``VideoBlipForConditionalGeneration``. PyTorch modules hold their own
weights, so there is no params tree: :func:`load_model` returns the model,
on the card unless the caller asks for another device, and its config.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import torch

from ..configs import OPTConfig, QFormerConfig, T5Config, VideoBlipConfig, VisionConfig
from ..configs import replace as cfg_replace
from ..ops.quantization import quantize_model_
from .convert import load_hf_checkpoint
from .video_blip import VideoBlipForConditionalGeneration
from .video_blip_v1 import VideoBlipV1ForConditionalGeneration


def config_from_hf_dict(cfg: dict) -> VideoBlipConfig:
    """Translate an HF Blip2Config dict (config.json) into VideoBlipConfig."""
    v = cfg["vision_config"]
    q = cfg["qformer_config"]
    t = cfg["text_config"]
    vision = VisionConfig(
        hidden_size=v.get("hidden_size", 1408),
        intermediate_size=v.get("intermediate_size", 6144),
        num_hidden_layers=v.get("num_hidden_layers", 39),
        num_attention_heads=v.get("num_attention_heads", 16),
        image_size=v.get("image_size", 224),
        patch_size=v.get("patch_size", 14),
        layer_norm_eps=v.get("layer_norm_eps", 1e-6),
        qkv_bias=v.get("qkv_bias", True),
        hidden_act=v.get("hidden_act", "gelu"),
    )
    qformer = QFormerConfig(
        hidden_size=q.get("hidden_size", 768),
        num_hidden_layers=q.get("num_hidden_layers", 12),
        num_attention_heads=q.get("num_attention_heads", 12),
        intermediate_size=q.get("intermediate_size", 3072),
        cross_attention_frequency=q.get("cross_attention_frequency", 2),
        encoder_hidden_size=q.get("encoder_hidden_size", 1408),
        layer_norm_eps=q.get("layer_norm_eps", 1e-12),
        hidden_act=q.get("hidden_act", "gelu"),
    )
    model_type = t.get("model_type", "opt")
    text: Any
    if model_type == "opt":
        text = OPTConfig(
            vocab_size=t.get("vocab_size", 50272),
            hidden_size=t.get("hidden_size", 2560),
            num_hidden_layers=t.get("num_hidden_layers", 32),
            num_attention_heads=t.get("num_attention_heads", 32),
            ffn_dim=t.get("ffn_dim", 10240),
            max_position_embeddings=t.get("max_position_embeddings", 2048),
            word_embed_proj_dim=t.get("word_embed_proj_dim", t.get("hidden_size", 2560)),
            do_layer_norm_before=t.get("do_layer_norm_before", True),
            activation_function=t.get("activation_function", "relu"),
            bos_token_id=t.get("bos_token_id", 2),
            eos_token_id=t.get("eos_token_id", 2),
            pad_token_id=t.get("pad_token_id", 1),
        )
    elif model_type == "t5":
        ff_proj = t.get("feed_forward_proj", "gated-gelu")
        gated = ff_proj.startswith("gated-")
        act = ff_proj.split("-")[-1]
        text = T5Config(
            vocab_size=t.get("vocab_size", 32128),
            d_model=t.get("d_model", 2048),
            d_kv=t.get("d_kv", 64),
            d_ff=t.get("d_ff", 5120),
            num_layers=t.get("num_layers", 24),
            num_decoder_layers=t.get("num_decoder_layers", t.get("num_layers", 24)),
            num_heads=t.get("num_heads", 32),
            relative_attention_num_buckets=t.get("relative_attention_num_buckets", 32),
            relative_attention_max_distance=t.get("relative_attention_max_distance", 128),
            layer_norm_epsilon=t.get("layer_norm_epsilon", 1e-6),
            is_gated_act=gated,
            dense_act_fn="gelu_new" if act == "gelu" and gated else act,
            tie_word_embeddings=t.get("tie_word_embeddings", False),
            pad_token_id=t.get("pad_token_id", 0),
            eos_token_id=t.get("eos_token_id", 1),
            decoder_start_token_id=t.get("decoder_start_token_id", 0),
        )
    else:
        raise ValueError(f"unsupported text model type: {model_type}")
    return VideoBlipConfig(
        vision_config=vision,
        qformer_config=qformer,
        text_config=text,
        num_query_tokens=cfg.get("num_query_tokens", 32),
    )


def load_model(
    path: str,
    *,
    version: str = "v2",
    dtype: torch.dtype = torch.float32,
    param_dtype: Optional[torch.dtype] = None,
    int8_lm: bool = False,
    int8_kv: bool = False,
    int8_vision: bool = False,
    int8_qformer: bool = False,
    w8a8_prefill: bool = False,
    remat: bool = False,
    device="cuda",
) -> tuple[VideoBlipForConditionalGeneration, VideoBlipConfig]:
    """Load a save_pretrained dir -> (model on ``device``, config).

    ``dtype`` is the compute dtype. ``param_dtype`` is that of every stored
    weight: ``None`` keeps each as the checkpoint holds it (fp32 for the
    published EILeV checkpoints), and the layers cast them to ``dtype`` at
    use, as the JAX CLIs' ``load_model(dtype=bf16)`` computes in bf16 over
    fp32 parameters; ``param_dtype=torch.bfloat16`` stores bf16 weights, half
    the memory and the weight stream, the layout of a model built in bf16.
    The weights are read one tensor at a time straight onto ``device``, into
    a model built on the meta device, so the card holds one copy of them.

    The serving modes quantize the loaded model in place
    (``ops/quantization.quantize_model_``), as JAX quantizes the loaded
    params: ``int8_lm`` (weight-only int8 LM matmuls), ``int8_kv`` (an int8
    KV cache, read by kernel K4), ``int8_vision`` and ``int8_qformer`` (W8A8
    matmuls), ``w8a8_prefill`` (requires ``int8_lm``: the LM's prefill
    matmuls W8A8). None is bit-parity with bf16; all are off by default.
    ``remat`` sets per-layer rematerialization of the LM trunk (training).
    Any other ``version`` than ``"v2"`` builds the v1 model, as in JAX (video features prepended,
    ``models/video_blip_v1.py``) over the same weights. OPT and T5 (flan-t5)
    checkpoints load; ``int8_lm``/``int8_kv`` take OPT only, as in JAX. The
    model comes back in eval mode with no parameter requiring grad (the
    Trainer sets its own).
    """
    with open(os.path.join(path, "config.json")) as f:
        config = config_from_hf_dict(json.load(f))
    if w8a8_prefill and not int8_lm:
        raise ValueError("w8a8_prefill requires int8_lm (shared int8 weights)")
    if (int8_lm or int8_kv) and not isinstance(config.text_config, OPTConfig):
        raise ValueError("int8_lm/int8_kv currently support OPT-family LMs only")
    if remat:
        config = cfg_replace(config, text_config=dataclasses.replace(config.text_config, remat=True))
    state = load_hf_checkpoint(path, config, dtype=param_dtype, device=device)
    table = "embed_tokens" if isinstance(config.text_config, OPTConfig) else "shared"
    stored = state[f"language_model.{table}.weight"].dtype  # the weights' dtype after the load
    cls = VideoBlipForConditionalGeneration if version == "v2" else VideoBlipV1ForConditionalGeneration
    model = cls(config, device="meta", dtype=dtype, param_dtype=stored)
    model.load_state_dict(state, strict=True, assign=True)
    del state
    model.eval().requires_grad_(False)
    if int8_lm or int8_kv or int8_vision or int8_qformer:
        quantize_model_(model, int8_lm=int8_lm, int8_kv=int8_kv, int8_vision=int8_vision,
                        int8_qformer=int8_qformer, w8a8_prefill=w8a8_prefill)
    return model, model.config


def load_tokenizer(path: str):
    """HF tokenizer from a local directory (tokenizers are pure host-side;
    this needs the ``transformers`` package)."""
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path)
