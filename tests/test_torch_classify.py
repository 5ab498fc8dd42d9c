"""Port vs JAX: shared-prefix class scoring and ``classify`` at tiny_config.

The inputs are those of ``tests/generation/test_generate_parity.py``'s
``opt_setup`` (2 datapoints x 2 videos, 20 prompt tokens, row 0 left-padded
by 3), with random weights drawn from numpy and loaded into both packages.
Tolerances: fp32 atol 1e-4 on logits and mean log-likelihoods (the two
packages sum in other orders over a depth-2 model); 1e-5 where the port is
held against itself (chunked classes, precomputed video features); bf16
atol = rtol = 2e-2 on the rows that are finite.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu import configs
from eilev_tpu.generation import classify as jclassify
from eilev_tpu.generation.classify import _prefill_prompt as jprefill
from eilev_tpu.models.video_blip import VideoBlipForConditionalGeneration as JVB
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.generation import classify
from eilev_tpu_torch.generation.classify import _prefill_prompt
from eilev_tpu_torch.models import VideoBlipForConditionalGeneration, params_from_jax

from ._torch_port import random_params, to_np

ATOL = 1e-4
C, L = 5, 3


def _int8_kv(cfg):
    return configs.replace(cfg, text_config=configs.replace(cfg.text_config, int8_kv_cache=True))


def _port(params, tcfg, dtype=torch.float32):
    model = VideoBlipForConditionalGeneration(tcfg, device="cpu", dtype=dtype)
    model.load_state_dict(params_from_jax(params, tcfg), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def setup():
    cfg = configs.tiny_config()
    rng = np.random.default_rng(7)
    b, v_per, t, s = 2, 2, 2, 20
    img = cfg.vision_config.image_size
    pixel = rng.normal(size=(b * v_per, 3, t, img, img)).astype(np.float32)
    ids = rng.integers(4, cfg.text_config.vocab_size, size=(b, s))
    mask = np.ones((b, s), np.int64)
    ids[0, :3] = 1  # left padding on row 0, like the eval scripts
    mask[0, :3] = 0
    vim = np.zeros((b, s), np.int64)
    vim[:, 4 : 4 + v_per * cfg.num_query_tokens] = 1
    class_ids = rng.integers(4, cfg.text_config.vocab_size, size=(C, L))
    class_mask = np.ones((C, L), np.int64)
    class_mask[1, 2:] = 0  # right-padded classes
    class_mask[3, 1:] = 0
    class_ids[class_mask == 0] = 1
    jmodel = JVB(cfg)
    params = random_params(
        jmodel, 21, input_ids=jnp.asarray(ids), pixel_values=jnp.asarray(pixel),
        video_input_mask=jnp.asarray(vim),
    )
    params = jax.tree.map(np.asarray, params)
    return SimpleNamespace(
        cfg=cfg, jmodel=jmodel, params=params, model=_port(params, tconfigs.tiny_config()),
        ids=ids, mask=mask, pixel=pixel, vim=vim, class_ids=class_ids, class_mask=class_mask,
    )


def _jax_ll(st, jmodel=None, **kw):
    return np.asarray(jclassify(
        jmodel or st.jmodel, {"params": st.params},
        prompt_input_ids=jnp.asarray(st.ids), class_input_ids=jnp.asarray(st.class_ids),
        prompt_attention_mask=jnp.asarray(st.mask), pixel_values=jnp.asarray(st.pixel),
        prompt_video_input_mask=jnp.asarray(st.vim), class_attention_mask=jnp.asarray(st.class_mask),
        **kw,
    ), np.float32)


def _port_ll(st, model=None, pixel_dtype=torch.float32, **kw):
    if "video_features" not in kw:
        kw["pixel_values"] = torch.from_numpy(st.pixel).to(pixel_dtype)
    return classify(
        model or st.model,
        prompt_input_ids=torch.from_numpy(st.ids), class_input_ids=torch.from_numpy(st.class_ids),
        prompt_attention_mask=torch.from_numpy(st.mask), prompt_video_input_mask=torch.from_numpy(st.vim),
        class_attention_mask=torch.from_numpy(st.class_mask), **kw,
    )


def test_score_with_prefix_matches_flax(setup):
    st = setup
    _, jcache = jprefill(
        st.jmodel, {"params": st.params}, jnp.asarray(st.ids), jnp.asarray(st.mask),
        jnp.asarray(st.pixel), jnp.asarray(st.vim),
    )
    cls_embeds = np.random.default_rng(3).normal(
        size=(2, C, L, st.cfg.text_config.word_embed_proj_dim)).astype(np.float32)
    cls_mask = np.ascontiguousarray(np.broadcast_to(st.class_mask, (2, C, L)))
    ref = st.jmodel.apply(
        {"params": st.params}, jnp.asarray(cls_embeds), jnp.asarray(cls_mask), jcache,
        method=JVB.lm_score_with_prefix,
    )
    _, ref_hidden = st.jmodel.apply(
        {"params": st.params}, jnp.asarray(cls_embeds), jnp.asarray(cls_mask), jcache,
        method=lambda m, *a: m.language_model.score_with_prefix(*a, return_hidden=True),
    )
    with torch.inference_mode():
        _, cache = _prefill_prompt(
            st.model, torch.from_numpy(st.ids), torch.from_numpy(st.mask),
            torch.from_numpy(st.pixel), torch.from_numpy(st.vim),
        )
        before = {k: v.clone() for k, v in cache.items() if isinstance(v, torch.Tensor)}
        ours = st.model.lm_score_with_prefix(torch.from_numpy(cls_embeds), torch.from_numpy(cls_mask), cache)
        _, hidden = st.model.language_model.score_with_prefix(
            torch.from_numpy(cls_embeds), torch.from_numpy(cls_mask), cache, return_hidden=True)
    assert tuple(ours.shape) == (2, C, L, st.cfg.text_config.vocab_size)
    np.testing.assert_allclose(to_np(ours), to_np(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(to_np(hidden), to_np(ref_hidden), atol=ATOL, rtol=0)
    # the shared prompt cache is read, never written
    for k, v in before.items():
        assert torch.equal(cache[k], v), k


def test_classify_matches_jax(setup):
    ref = _jax_ll(setup)
    ours = _port_ll(setup)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (2, C)
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(ours.numpy().argmax(-1), ref.argmax(-1))


def test_class_batches_match_unchunked(setup):
    whole = _port_ll(setup)
    torch.testing.assert_close(_port_ll(setup, class_batch_size=2), whole, atol=1e-5, rtol=0)


def test_int8_kv_classify_matches_jax(setup):
    st = setup
    ref = _jax_ll(st, JVB(_int8_kv(st.cfg)))
    ours = _port_ll(st, _port(st.params, _int8_kv(tconfigs.tiny_config())))
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(ours.numpy().argmax(-1), ref.argmax(-1))
    # the int8 prompt cache is a real change: the scores move off the fp32 ones
    assert not np.allclose(ours.numpy(), _port_ll(st).numpy(), atol=1e-7, rtol=0)


def test_video_features_match_pixels(setup):
    st = setup
    with torch.inference_mode():
        feats = st.model.encode_videos(torch.from_numpy(st.pixel))
    torch.testing.assert_close(_port_ll(st, video_features=feats), _port_ll(st), atol=1e-5, rtol=0)


def test_bf16_left_padded_rows_are_nan_as_in_jax(setup):
    """The reference behaviour the port keeps: in bf16 the prefill's mask value
    finfo(float32).min is -inf, so the left-padded query rows of row 0 are NaN
    from layer 1, their k/v in the prompt cache are NaN from layer 2, and the
    additive prefix bias carries the NaN into every class score of row 0."""
    st = setup
    ref = _jax_ll(st, JVB(st.cfg, dtype=jnp.bfloat16))
    ours = _port_ll(st, _port(st.params, tconfigs.tiny_config(), torch.bfloat16), pixel_dtype=torch.bfloat16)
    ours = ours.numpy()
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    assert np.isnan(ref[0]).all() and np.isfinite(ref[1]).all()
    np.testing.assert_allclose(ours[1], ref[1], atol=2e-2, rtol=2e-2)


def test_seq2seq_classify_is_not_ported(setup):
    """Seq2seq classify is ported: on the same prompts and classes a T5
    VideoBLIP scores (B, C) mean log-likelihoods within 1e-4 of JAX's, its
    classes over the shared encoder states; precomputed video features give
    the pixel path's scores."""
    st = setup
    cfg = configs.tiny_config(text_model="t5")
    jmodel = JVB(cfg)
    params = jax.tree.map(np.asarray, random_params(
        jmodel, 22, input_ids=jnp.asarray(st.ids), pixel_values=jnp.asarray(st.pixel),
        video_input_mask=jnp.asarray(st.vim), decoder_input_ids=jnp.zeros((2, L), jnp.int32)))
    t5 = SimpleNamespace(**{**vars(st), "jmodel": jmodel, "params": params,
                            "model": _port(params, tconfigs.tiny_config(text_model="t5"))})
    ours, ref = _port_ll(t5), _jax_ll(t5)
    assert ours.shape == (2, C) and np.isfinite(ref).all()
    np.testing.assert_allclose(to_np(ours), ref, atol=ATOL, rtol=0)
    with torch.inference_mode():
        feats = t5.model.encode_videos(torch.from_numpy(st.pixel))
    torch.testing.assert_close(_port_ll(t5, video_features=feats), ours, atol=1e-5, rtol=0)
