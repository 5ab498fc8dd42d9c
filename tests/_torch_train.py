"""Shared setup of the port's training tests (tests/test_torch_train_step.py,
test_torch_remat.py, test_torch_trainer.py): a tiny_config VideoBLIP-OPT in
both packages on the same numpy weights, and static-shape batches with a
leading micro-batch axis, as the JAX training tests build them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from eilev_tpu import configs
from eilev_tpu.models import VideoBlipForConditionalGeneration as JVB
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.models import VideoBlipForConditionalGeneration, params_from_jax
from eilev_tpu_torch.training import freeze_towers

from ._torch_port import random_params

SEQ = 16


def tiny_batch(cfg, accum, micro_b, seed=0, seq=SEQ, padded=True):
    """numpy batch: every array (accum, micro, ...); one video per sample at
    positions 1..1+Q; labels -100 on the video slots (and on the padding,
    the last 3 positions of the last row, when ``padded``)."""
    rng = np.random.default_rng(seed)
    img, q, b = cfg.vision_config.image_size, cfg.num_query_tokens, accum * micro_b
    pixel = rng.normal(size=(b, 3, 2, img, img)).astype(np.float32)
    ids = rng.integers(4, cfg.text_config.vocab_size, size=(b, seq))
    vim = np.zeros((b, seq), np.int64)
    vim[:, 1 : 1 + q] = 1
    mask = np.ones((b, seq), np.int64)
    if padded:
        mask[-1, -3:] = 0
        ids[-1, -3:] = 1
    labels = np.where(vim.astype(bool) | (mask == 0), -100, ids)

    def r(x):
        return x.reshape(accum, micro_b, *x.shape[1:])

    return {"input_ids": r(ids), "attention_mask": r(mask), "labels": r(labels),
            "video_input_mask": r(vim), "pixel_values": r(pixel)}


def jax_setup(seed=3, remat=False):
    """(jax config, JAX model, numpy params) at tiny_config (OPT)."""
    cfg = configs.tiny_config(text_model="opt")
    if remat:
        cfg = configs.replace(cfg, text_config=dataclasses.replace(cfg.text_config, remat=True))
    model = JVB(cfg)
    b = {k: v[0] for k, v in tiny_batch(cfg, 1, 2).items()}
    params = random_params(model, seed, input_ids=jnp.asarray(b["input_ids"]),
                           pixel_values=jnp.asarray(b["pixel_values"]),
                           video_input_mask=jnp.asarray(b["video_input_mask"]))
    return cfg, model, jax.tree.map(np.asarray, params)


def port_model(params, remat=False, dtype=None, trainable_dtype=None):
    """The port model on the CPU with ``params`` (numpy flax tree), its
    towers frozen."""
    cfg = tconfigs.tiny_config(text_model="opt")
    if remat:
        cfg = tconfigs.replace(cfg, text_config=dataclasses.replace(cfg.text_config, remat=True))
    model = VideoBlipForConditionalGeneration(cfg, device="cpu", dtype=dtype, trainable_dtype=trainable_dtype)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    freeze_towers(model)
    return model


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def micro(batch, i=0):
    return {k: v[i] for k, v in batch.items()}
