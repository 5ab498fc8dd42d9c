"""Port vs JAX: the whole greedy-narration slice at tiny_config in fp32.

uint8 frames -> process_videos -> encode_videos -> scatter into the prompt ->
OPT prefill (kernel K2's plain twin) -> greedy decode on the stacked cache.
Tokens must be identical to ``eilev_tpu.generation.generate`` for 2
datapoints x 2 videos, with one row stopping early on eos.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu import configs
from eilev_tpu.generation import GenerationConfig as JGenerationConfig
from eilev_tpu.generation import generate as jgenerate
from eilev_tpu.models.video_blip import VideoBlipForConditionalGeneration as JVB
from eilev_tpu.ops.preprocess import process_videos as jprocess
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.generation import GenerationConfig, generate
from eilev_tpu_torch.models import VideoBlipForConditionalGeneration, params_from_jax
from eilev_tpu_torch.ops.preprocess import process_videos

from ._torch_port import random_params

MAX_NEW = 8


@pytest.fixture(scope="module")
def slice_setup():
    cfg = configs.tiny_config()
    img = cfg.vision_config.image_size
    rng = np.random.default_rng(11)
    b, v_per, frames_raw, t, s = 2, 2, 5, 2, 16
    frames = rng.integers(0, 256, size=(b * v_per, 3, frames_raw, 20, 20), dtype=np.uint8)
    ids = rng.integers(4, cfg.text_config.vocab_size, size=(b, s)).astype(np.int32)
    ids[:, 0] = 2  # bos
    mask = np.ones((b, s), np.int32)
    ids[1, :2], mask[1, :2] = 1, 0  # left padding, as the eval scripts batch
    vim = np.zeros((b, s), np.int32)
    vim[:, 3 : 3 + v_per * cfg.num_query_tokens] = 1
    jmodel = JVB(cfg)
    params = random_params(
        jmodel, 12, input_ids=jnp.asarray(ids),
        pixel_values=jnp.zeros((b * v_per, 3, t, img, img)), video_input_mask=jnp.asarray(vim),
    )
    tcfg = tconfigs.tiny_config()
    model = VideoBlipForConditionalGeneration(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tcfg), strict=True)
    return cfg, jmodel, params, model.eval(), frames, ids, mask, vim, t


def _jax_tokens(setup, eos, features=False, **kw):
    cfg, jmodel, params, _, frames, ids, mask, vim, t = setup
    img = cfg.vision_config.image_size
    pixel = jprocess(jnp.asarray(frames), num_frames=t, height=img, width=img)
    if features:
        kw["video_features"] = jmodel.apply({"params": params}, pixel, method=JVB.encode_videos)
    return np.asarray(
        jgenerate(
            jmodel, {"params": params},
            input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
            pixel_values=pixel, video_input_mask=jnp.asarray(vim),
            generation_config=JGenerationConfig(
                max_new_tokens=MAX_NEW, pad_token_id=1, eos_token_id=eos
            ),
            **kw,
        )
    )


def _port_tokens(setup, eos, features=False, **kw):
    cfg, _, _, model, frames, ids, mask, vim, t = setup
    img = cfg.vision_config.image_size
    pixel = process_videos(torch.from_numpy(frames), num_frames=t, height=img, width=img)
    if features:
        with torch.inference_mode():
            kw["video_features"] = model.encode_videos(pixel)
    return generate(
        model,
        input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
        pixel_values=pixel, video_input_mask=torch.from_numpy(vim),
        generation_config=GenerationConfig(max_new_tokens=MAX_NEW, pad_token_id=1, eos_token_id=eos),
        **kw,
    ).numpy()


def test_greedy_tokens_identical_with_early_eos(slice_setup):
    # probe with an eos no row emits, then stop row 0 early on its 3rd token
    probe = _jax_tokens(slice_setup, (-1,))
    np.testing.assert_array_equal(_port_tokens(slice_setup, (-1,)), probe)
    eos = int(probe[0, 2])
    ref = _jax_tokens(slice_setup, (eos,))
    ours = _port_tokens(slice_setup, (eos,))
    assert ours.shape == ref.shape == (2, MAX_NEW)
    np.testing.assert_array_equal(ours, ref)
    first = int(np.where(ours[0] == eos)[0][0])
    assert first <= 2 and (ours[0, first + 1 :] == 1).all()


@pytest.mark.parametrize("mode", ["video_features", "vision_chunks"])
def test_precomputed_features_and_chunked_vision_match_jax(slice_setup, mode):
    """``generate(video_features=...)`` (each package's own ``encode_videos``
    output, which takes precedence over the pixels) and
    ``generate(vision_chunks=2)`` over the 4 videos: tokens identical to JAX's
    ``generate`` with the same arguments, and to the pixel path."""
    kw = {"features": True} if mode == "video_features" else {"vision_chunks": 2}
    ref = _jax_tokens(slice_setup, (-1,), **kw)
    ours = _port_tokens(slice_setup, (-1,), **kw)
    assert ours.shape == (2, MAX_NEW)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, _port_tokens(slice_setup, (-1,)))


def test_vision_chunks_must_divide_the_videos(slice_setup):
    with pytest.raises(ValueError, match="must divide the number of videos"):
        _port_tokens(slice_setup, (-1,), vision_chunks=3)


def test_default_eos_is_the_text_configs(slice_setup):
    ref = _jax_tokens(slice_setup, None)
    np.testing.assert_array_equal(_port_tokens(slice_setup, None), ref)


@pytest.mark.parametrize(
    "gen_kwargs,call_kwargs",
    [
        ({"penalty_alpha": 0.6, "top_k": 4}, {}),
        ({}, {"draft": "prompt_lookup"}),
        ({}, {"draft_layers": 1}),
    ],
)
def test_unported_modes_raise(slice_setup, gen_kwargs, call_kwargs):
    """Contrastive search and both speculative modes are ported (they no
    longer raise): the slice's tokens equal JAX's ``generate`` with the same
    arguments, and a T5 text config, still unported, raises."""
    cfg, jmodel, params, model, frames, ids, mask, vim, t = slice_setup
    img = cfg.vision_config.image_size
    ref = jgenerate(
        jmodel, {"params": params}, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        pixel_values=jprocess(jnp.asarray(frames), num_frames=t, height=img, width=img),
        video_input_mask=jnp.asarray(vim),
        generation_config=JGenerationConfig(max_new_tokens=MAX_NEW, pad_token_id=1, **gen_kwargs), **call_kwargs,
    )
    ours = generate(
        model, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
        pixel_values=process_videos(torch.from_numpy(frames), num_frames=t, height=img, width=img),
        video_input_mask=torch.from_numpy(vim),
        generation_config=GenerationConfig(max_new_tokens=MAX_NEW, pad_token_id=1, **gen_kwargs), **call_kwargs,
    )
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    t5 = tconfigs.replace(model.config, text_config=tconfigs.tiny_config(text_model="t5").text_config)
    with pytest.raises(NotImplementedError, match="T5Config"):
        generate(SimpleNamespace(config=t5), input_ids=torch.from_numpy(ids))


def test_greedy_rejects_num_return_sequences(slice_setup):
    with pytest.raises(ValueError, match="num_return_sequences"):
        generate(
            slice_setup[3], input_ids=torch.from_numpy(slice_setup[5]),
            generation_config=GenerationConfig(num_return_sequences=2),
        )
