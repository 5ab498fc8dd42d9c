"""Port vs JAX: the vision tower (models/vision.py) at tiny_config, fp32, atol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu import configs
from eilev_tpu.models.vision import VideoVisionModel as JVideoVision
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.models.vision import VideoVisionModel

from ._torch_port import load_port, random_params, to_np


@pytest.mark.parametrize("heads,image_size,patch_size", [(2, 16, 8), (4, 24, 4)])
def test_video_vision_model_matches_flax(heads, image_size, patch_size):
    vcfg = configs.tiny_config(heads=heads, image_size=image_size, patch_size=patch_size).vision_config
    v, t = 3, 2
    pixel = np.random.default_rng(0).normal(size=(v, 3, t, image_size, image_size)).astype(np.float32)
    jmodel = JVideoVision(vcfg)
    params = random_params(jmodel, 1, jnp.asarray(pixel))
    ref_hidden, ref_pooled = jmodel.apply({"params": params}, jnp.asarray(pixel))

    tcfg = tconfigs.tiny_config(heads=heads, image_size=image_size, patch_size=patch_size).vision_config
    ours = load_port(VideoVisionModel(tcfg), params)
    with torch.no_grad():
        hidden, pooled = ours(torch.from_numpy(pixel))
    seq = (image_size // patch_size) ** 2 + 1
    assert tuple(hidden.shape) == (v, t * seq, vcfg.hidden_size)
    assert tuple(pooled.shape) == (v, t, vcfg.hidden_size)
    np.testing.assert_allclose(to_np(hidden), to_np(ref_hidden), atol=1e-4, rtol=0)
    np.testing.assert_allclose(to_np(pooled), to_np(ref_pooled), atol=1e-4, rtol=0)
