"""Port vs JAX: OPT (models/opt.py), the top-level model (models/video_blip.py)
and the converter (models/convert.py), at tiny_config in fp32, atol 1e-4.

Covers the no-cache forward, the fresh prefill into the stacked KV cache
(kernel K2's plain twin on the CPU) and one-token decode steps, held against
the JAX cache entry by entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu import configs
from eilev_tpu.models import opt as jopt
from eilev_tpu.models.video_blip import VideoBlipForConditionalGeneration as JVB
from eilev_tpu.models.video_blip import scatter_video_features as j_scatter
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.models import (
    VideoBlipForConditionalGeneration,
    init_cache,
    opt_position_ids,
    params_from_jax,
    scatter_video_features,
)
from eilev_tpu_torch.models.opt import OPTForCausalLM

from ._torch_port import load_port, random_params, to_np

ATOL = 1e-4


def _opt_pair(proj_dim=None, layers=2):
    def cfg(mod):
        c = mod.tiny_config(layers=layers).text_config
        return mod.replace(c, word_embed_proj_dim=proj_dim) if proj_dim else c

    jcfg, tcfg = cfg(configs), cfg(tconfigs)
    b, s = 2, 7
    rng = np.random.default_rng(3)
    embeds = rng.normal(size=(b, s, jcfg.word_embed_proj_dim)).astype(np.float32)
    jmodel = jopt.OPTForCausalLM(jcfg)
    params = random_params(jmodel, 4, jnp.asarray(embeds))
    return jcfg, jmodel, params, load_port(OPTForCausalLM(tcfg), params), embeds


def _left_padded_mask(b, s):
    mask = np.ones((b, s), np.int32)
    mask[0, :2] = 0
    return mask


def test_opt_position_ids():
    mask = _left_padded_mask(2, 6)
    np.testing.assert_array_equal(
        opt_position_ids(torch.from_numpy(mask)).numpy(),
        np.asarray(jopt.opt_position_ids(jnp.asarray(mask))),
    )


@pytest.mark.parametrize("proj_dim", [None, 8])
def test_opt_forward_no_cache(proj_dim):
    _, jmodel, params, ours, embeds = _opt_pair(proj_dim)
    mask = _left_padded_mask(*embeds.shape[:2])
    ref, _ = jmodel.apply({"params": params}, jnp.asarray(embeds), attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        logits, cache = ours(torch.from_numpy(embeds), attention_mask=torch.from_numpy(mask))
    assert cache is None
    np.testing.assert_allclose(to_np(logits), to_np(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("proj_dim", [None, 8])
def test_opt_prefill_and_decode_match_jax_cache(proj_dim):
    jcfg, jmodel, params, ours, embeds = _opt_pair(proj_dim)
    b, s, _ = embeds.shape
    mask = _left_padded_mask(b, s)
    max_len = s + 3
    jcache = jopt.init_cache(jcfg, b, max_len)
    tcache = init_cache(ours.config, b, max_len)
    steps = [(embeds, mask)]
    rng = np.random.default_rng(5)
    for _ in range(3):
        steps.append((rng.normal(size=(b, 1, embeds.shape[2])).astype(np.float32),
                      np.ones((b, 1), np.int32)))
    for x, m in steps:
        ref, jcache = jmodel.apply(
            {"params": params}, jnp.asarray(x), attention_mask=jnp.asarray(m), cache=jcache
        )
        with torch.no_grad():
            logits, tcache = ours(torch.from_numpy(x), attention_mask=torch.from_numpy(m), cache=tcache)
        np.testing.assert_allclose(to_np(logits), to_np(ref), atol=ATOL, rtol=0)
        assert tcache["index"] == int(jcache["index"])
        np.testing.assert_array_equal(tcache["mask"].numpy(), np.asarray(jcache["mask"]))
        np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(to_np(tcache[key]), to_np(jcache[key]), atol=ATOL, rtol=0)


def test_opt_unported_modes_raise():
    tcfg = tconfigs.tiny_config().text_config
    # the int8 serving modes are ported and build, and so is remat, the
    # training option (tests/test_torch_remat.py)
    for flags in ({"quantize_matmuls": True}, {"int8_kv_cache": True},
                  {"quantize_matmuls": True, "w8a8_prefill": True}, {"remat": True}):
        OPTForCausalLM(tconfigs.replace(tcfg, **flags))
    model = OPTForCausalLM(tcfg)
    x = torch.zeros(1, 3, tcfg.hidden_size)
    cache = init_cache(tcfg, 1, 8)
    with torch.no_grad():
        model(x, cache_append=True)  # no cache: the flag has nothing to append to
        model(x, cache=cache)
        with pytest.raises(NotImplementedError):  # multi-token write into a filled cache
            model(x, cache=cache)
        # the speculative verify append is ported (tests/test_torch_cache_append.py)
        logits, _ = model(x, cache=cache, cache_append=True)
    assert logits.shape == (1, 3, tcfg.vocab_size) and cache["index"] == 6
    # shared-prefix class scoring is ported (tests/test_torch_classify.py): it
    # reads the filled cache and returns (B, C, L, vocab) logits
    with torch.no_grad():
        logits = model.score_with_prefix(
            torch.zeros(1, 2, 2, tcfg.word_embed_proj_dim), torch.ones(1, 2, 2), cache)
    assert tuple(logits.shape) == (1, 2, 2, tcfg.vocab_size)


def test_scatter_video_features_matches_jax():
    rng = np.random.default_rng(6)
    embeds = rng.normal(size=(2, 9, 4)).astype(np.float32)
    vim = np.zeros((2, 9), np.int32)
    vim[0, 1:4] = 1
    vim[1, 5:8] = 1
    feats = rng.normal(size=(6, 4)).astype(np.float32)
    ref = j_scatter(jnp.asarray(embeds), jnp.asarray(vim), jnp.asarray(feats))
    ours = scatter_video_features(torch.from_numpy(embeds), torch.from_numpy(vim), torch.from_numpy(feats))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def _videoblip_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    b, v_per, t, s = 2, 2, 2, 14
    img = cfg.vision_config.image_size
    pixel = rng.normal(size=(b * v_per, 3, t, img, img)).astype(np.float32)
    ids = rng.integers(4, cfg.text_config.vocab_size, size=(b, s)).astype(np.int32)
    vim = np.zeros((b, s), np.int32)
    vim[:, 1 : 1 + v_per * cfg.num_query_tokens] = 1
    return pixel, ids, vim


def test_params_from_jax_full_model_forward():
    cfg = configs.tiny_config()
    pixel, ids, vim = _videoblip_inputs(cfg, 7)
    jmodel = JVB(cfg)
    params = random_params(
        jmodel, 8, input_ids=jnp.asarray(ids), pixel_values=jnp.asarray(pixel),
        video_input_mask=jnp.asarray(vim),
    )
    ref = jmodel.apply(
        {"params": params}, jnp.asarray(ids), pixel_values=jnp.asarray(pixel),
        video_input_mask=jnp.asarray(vim),
    )["logits"]
    ref_feats = jmodel.apply({"params": params}, jnp.asarray(pixel), method=JVB.encode_videos)

    tcfg = tconfigs.tiny_config()
    ours = VideoBlipForConditionalGeneration(tcfg, device="cpu")
    sd = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    assert set(sd) == set(ours.state_dict())
    ours.load_state_dict(sd, strict=True)
    with torch.no_grad():
        feats = ours.encode_videos(torch.from_numpy(pixel))
        embeds = ours.embed_and_scatter(
            torch.from_numpy(ids), torch.from_numpy(pixel), torch.from_numpy(vim)
        )
        logits, _ = ours.lm_forward(embeds)
    np.testing.assert_allclose(to_np(feats), to_np(ref_feats), atol=ATOL, rtol=0)
    np.testing.assert_allclose(to_np(logits), to_np(ref), atol=ATOL, rtol=0)


def test_t5_text_config_is_not_ported():
    """The T5 text config is ported: params_from_jax fills the port's T5
    VideoBLIP exactly, and its training forward (decoder inputs shifted from
    the labels, -100 -> pad) gives JAX's logits and loss."""
    cfg = configs.tiny_config(text_model="t5")
    pixel, ids, vim = _videoblip_inputs(cfg, 9)
    labels = np.random.default_rng(10).integers(2, cfg.text_config.vocab_size, size=(2, 4)).astype(np.int32)
    labels[1, -1] = -100
    jmodel = JVB(cfg)
    params = random_params(jmodel, 11, input_ids=jnp.asarray(ids), pixel_values=jnp.asarray(pixel),
                           video_input_mask=jnp.asarray(vim), labels=jnp.asarray(labels))
    ref = jmodel.apply({"params": params}, jnp.asarray(ids), pixel_values=jnp.asarray(pixel),
                       video_input_mask=jnp.asarray(vim), labels=jnp.asarray(labels))
    tcfg = tconfigs.tiny_config(text_model="t5")
    ours = VideoBlipForConditionalGeneration(tcfg, device="cpu")
    sd = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    assert set(sd) == set(ours.state_dict())
    ours.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = ours.eval()(torch.from_numpy(ids), pixel_values=torch.from_numpy(pixel),
                   video_input_mask=torch.from_numpy(vim), labels=torch.from_numpy(labels))
    assert out["logits"].shape == (2, 4, cfg.text_config.vocab_size)
    np.testing.assert_allclose(to_np(out["logits"]), to_np(ref["logits"]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(out["loss"]), float(ref["loss"]), rtol=1e-5)


def test_narration_model_defaults_to_the_card():
    """The entry point builds on ``cuda`` unless asked for the CPU, as ``TextLM``
    does; read from the signature, so no GPU is needed."""
    import inspect

    from eilev_tpu_torch.generation.text_lm import TextLM

    for entry in (VideoBlipForConditionalGeneration.__init__, TextLM.__init__):
        assert inspect.signature(entry).parameters["device"].default == "cuda"
