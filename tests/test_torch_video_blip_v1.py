"""Port vs JAX: the v1 model (``models/video_blip_v1.py``: one video a
sample, its features prepended to the text) at tiny_config in fp32: the
forward's logits and loss (HF Blip2's, over the last ``labels.shape[1]``
logits) at atol 1e-4, and greedy ``generate`` (the mask extended with ones
over the prepended features) token-identical to ``eilev_tpu``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu import configs
from eilev_tpu.generation import GenerationConfig as JGenerationConfig
from eilev_tpu.generation import generate as jgenerate
from eilev_tpu.models.video_blip_v1 import VideoBlipV1ForConditionalGeneration as JV1
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.generation import GenerationConfig, generate
from eilev_tpu_torch.models import params_from_jax
from eilev_tpu_torch.models.video_blip_v1 import VideoBlipV1ForConditionalGeneration

from ._torch_port import random_params, to_np


@pytest.fixture(scope="module")
def v1():
    cfg = configs.tiny_config(layers=2)
    rng = np.random.default_rng(4)
    b, t, s = 2, 2, 9
    img = cfg.vision_config.image_size
    pixel = rng.normal(size=(b, 3, t, img, img)).astype(np.float32)
    ids = rng.integers(4, cfg.text_config.vocab_size, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    ids[1, :2], mask[1, :2] = 1, 0  # left padding
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    jmodel = JV1(cfg)
    params = random_params(jmodel, 8, input_ids=jnp.asarray(ids), pixel_values=jnp.asarray(pixel), std=0.5)
    tcfg = tconfigs.tiny_config(layers=2)
    model = VideoBlipV1ForConditionalGeneration(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tcfg), strict=True)
    return jmodel, params, model.eval(), ids, mask, labels, pixel


def test_v1_forward_and_loss_match_jax(v1):
    jmodel, params, model, ids, mask, labels, pixel = v1
    ref = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixel),
                       labels=jnp.asarray(labels))
    with torch.no_grad():
        ours = model(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(pixel),
                     labels=torch.from_numpy(labels))
    assert ours["logits"].shape[1] == ids.shape[1] + model.config.num_query_tokens
    np.testing.assert_allclose(to_np(ours["logits"]), to_np(ref["logits"]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(ours["loss"]), float(ref["loss"]), atol=1e-5, rtol=0)


def test_v1_greedy_generate_matches_jax(v1):
    jmodel, params, model, ids, mask, _, pixel = v1
    ref = jgenerate(jmodel, {"params": params}, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                    pixel_values=jnp.asarray(pixel),
                    generation_config=JGenerationConfig(max_new_tokens=8, pad_token_id=1, eos_token_id=(-1,)))
    ours = generate(model, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                    pixel_values=torch.from_numpy(pixel),
                    generation_config=GenerationConfig(max_new_tokens=8, pad_token_id=1, eos_token_id=(-1,)))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
