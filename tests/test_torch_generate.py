"""Port vs JAX: the whole greedy-narration slice at tiny_config in fp32.

uint8 frames -> process_videos -> encode_videos -> scatter into the prompt ->
OPT prefill (kernel K2's plain twin) -> greedy decode on the stacked cache.
Tokens must be identical to ``eilev_tpu.generation.generate`` for 2
datapoints x 2 videos, with one row stopping early on eos.
"""

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


@pytest.fixture(scope="module")
def t5_pair(slice_setup):
    """A T5 VideoBLIP in both packages on the same numpy weights, for the
    slice's prompts (its towers' widths are the OPT slice's)."""
    ids, vim = slice_setup[5], slice_setup[7]
    cfg = configs.tiny_config(text_model="t5")
    jmodel = JVB(cfg)
    params = random_params(jmodel, 13, input_ids=jnp.asarray(ids), pixel_values=jnp.zeros((4, 3, 2, 16, 16)),
                           video_input_mask=jnp.asarray(vim), decoder_input_ids=jnp.zeros((2, 1), jnp.int32))
    tcfg = tconfigs.tiny_config(text_model="t5")
    model = VideoBlipForConditionalGeneration(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tcfg), strict=True)
    return jmodel, params, model.eval()


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
def test_unported_modes_raise(slice_setup, t5_pair, gen_kwargs, call_kwargs):
    """Contrastive search and both speculative modes are ported (they no
    longer raise): the slice's tokens equal JAX's ``generate`` with the same
    arguments; and so does a T5 VideoBLIP's call (JAX's T5 greedy, which the
    drafts leave alone; contrastive search refused by both, as it is
    decoder-only)."""
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
    jt5, params5, t5 = t5_pair
    gen = dict(max_new_tokens=MAX_NEW, pad_token_id=0, **gen_kwargs)
    jcall = lambda: jgenerate(  # noqa: E731
        jt5, {"params": params5}, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        pixel_values=jprocess(jnp.asarray(frames), num_frames=t, height=img, width=img),
        video_input_mask=jnp.asarray(vim), generation_config=JGenerationConfig(**gen), **call_kwargs)
    call = lambda: generate(  # noqa: E731
        t5, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
        pixel_values=process_videos(torch.from_numpy(frames), num_frames=t, height=img, width=img),
        video_input_mask=torch.from_numpy(vim), generation_config=GenerationConfig(**gen), **call_kwargs)
    if "penalty_alpha" in gen_kwargs:
        for run in (jcall, call):
            with pytest.raises(NotImplementedError, match="decoder-only"):
                run()
        return
    ref5, ours5 = np.asarray(jcall()), call().numpy()
    assert ours5.shape == (2, 1 + MAX_NEW)
    np.testing.assert_array_equal(ours5, ref5)


def test_greedy_rejects_num_return_sequences(slice_setup):
    with pytest.raises(ValueError, match="num_return_sequences"):
        generate(
            slice_setup[3], input_ids=torch.from_numpy(slice_setup[5]),
            generation_config=GenerationConfig(num_return_sequences=2),
        )
