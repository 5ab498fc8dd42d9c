"""Shared setup of the port's checkpoint and CLI tests
(tests/test_torch_hf_checkpoint.py, tests/test_torch_cli.py): a tiny HF
``save_pretrained`` directory written by the JAX package's own exporter,
``eilev_tpu.training.checkpoint.export_hf_safetensors``, with a
``config.json`` written here and the offline tokenizer of
``tests/util_tokenizer.py``."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from eilev_tpu.models.auto import config_from_hf_dict
from eilev_tpu.models.video_blip import VideoBlipForConditionalGeneration as JVB
from eilev_tpu.training.checkpoint import export_hf_safetensors

from ._torch_port import random_params
from .util_tokenizer import build_tiny_tokenizer

VOCAB = 384  # the tiny tokenizer's

# an HF Blip2Config dict at tiny widths: the Q-Former's cross-attention on
# layer 0 of 2 (frequency 2), OPT with the tokenizer's vocabulary
HF_CONFIG = {
    "model_type": "blip-2",
    "num_query_tokens": 4,
    "vision_config": {
        "hidden_size": 16, "intermediate_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
        "image_size": 16, "patch_size": 8, "layer_norm_eps": 1e-6, "qkv_bias": True,
    },
    "qformer_config": {
        "hidden_size": 16, "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 32,
        "cross_attention_frequency": 2, "encoder_hidden_size": 16, "layer_norm_eps": 1e-12,
    },
    "text_config": {
        "model_type": "opt", "vocab_size": VOCAB, "hidden_size": 16, "num_hidden_layers": 2,
        "num_attention_heads": 2, "ffn_dim": 32, "max_position_embeddings": 128, "word_embed_proj_dim": 16,
        "bos_token_id": 2, "eos_token_id": 2, "pad_token_id": 1,
    },
}


def hf_config(**text) -> dict:
    """HF_CONFIG with ``text`` merged into its text_config."""
    cfg = copy.deepcopy(HF_CONFIG)
    cfg["text_config"].update(text)
    return cfg


def write_checkpoint(path: str, hf: dict = HF_CONFIG, seed: int = 7, tokenizer: bool = False) -> dict:
    """Random numpy weights for the JAX model of ``hf``, exported by the JAX
    package into ``path`` with ``hf`` as config.json (and the tiny tokenizer
    when asked). Returns the numpy params."""
    cfg = config_from_hf_dict(hf)
    q = cfg.num_query_tokens
    ids = jnp.asarray([[2] + [1] * q + [4, 5]])
    vim = jnp.zeros_like(ids).at[:, 1 : 1 + q].set(1)
    img = cfg.vision_config.image_size
    params = random_params(JVB(cfg), seed, input_ids=ids, pixel_values=jnp.zeros((1, 3, 2, img, img)),
                           video_input_mask=vim)
    params = jax.tree.map(np.asarray, params)
    os.makedirs(path, exist_ok=True)
    export_hf_safetensors(params, cfg, path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    if tokenizer:
        build_tiny_tokenizer(path, vocab_size=VOCAB)
    return params
