"""Port vs JAX: LLaMA (models/llama.py) at a tiny GQA geometry (4 heads over
2 kv heads, hd 8) in fp32, atol 1e-4, with left padding.

Covers the position ids, rope, RMSNorm, the attention module and the decoder
layer, and LlamaForCausalLM without cache, with a fresh prefill into the
stacked cache and with one-token decode steps (held against the JAX cache
entry by entry), under both attention implementations: ``xla`` (the plain
path) and ``flash`` (K5's twin here, the Pallas kernel in interpret mode in
JAX). The default implementation is restored after each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu import configs as jconfigs
from eilev_tpu.generation import GenerationConfig as JGenerationConfig
from eilev_tpu.generation.decoding import _greedy_sample_decoder_only as j_greedy
from eilev_tpu.generation.text_lm import _TextOnlyModule as JTextOnly
from eilev_tpu.models import llama as jl
from eilev_tpu.models import opt as jopt
from eilev_tpu.ops.attention import set_default_attention_impl as jset_impl
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.generation import GenerationConfig
from eilev_tpu_torch.generation.decoding import _greedy_sample_decoder_only
from eilev_tpu_torch.generation.text_lm import _TextOnlyModule
from eilev_tpu_torch.models import init_cache, params_from_jax
from eilev_tpu_torch.models import llama as tl
from eilev_tpu_torch.ops.attention import set_default_attention_impl as tset_impl

from ._torch_port import load_port, random_params, to_np

ATOL = 1e-4
B, S = 2, 9


def _cfg(mod, **kw):
    return mod.LlamaConfig(
        vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=64, max_position_embeddings=128, **kw,
    )


@pytest.fixture(params=["xla", "flash"])
def impl(request):
    jset_impl(request.param)
    tset_impl(request.param)
    yield request.param
    jset_impl("auto")
    tset_impl("auto")


def _mask(b=B, s=S):
    mask = np.ones((b, s), np.int32)
    mask[1, :3] = 0  # left padding
    return mask


def _embeds(seed, b=B, s=S, d=32):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)


def _rope_inputs(mask, head_dim=8):
    pos = jl.llama_position_ids(jnp.asarray(mask))
    cos, sin = jl.rope_cos_sin(pos, head_dim, 10000.0)
    return np.array(cos), np.array(sin)


def test_position_ids_and_rope():
    mask = _mask()
    np.testing.assert_array_equal(
        tl.llama_position_ids(torch.from_numpy(mask)).numpy(),
        np.asarray(jl.llama_position_ids(jnp.asarray(mask))),
    )
    pos = np.array([[0, 1, 5, 127], [1, 1, 2, 3]], np.int32)
    jcos, jsin = jl.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    tcos, tsin = tl.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=1e-5, rtol=0)
    x = np.random.default_rng(0).normal(size=(2, 4, 3, 16)).astype(np.float32)
    ref = jl.apply_rope(jnp.asarray(x), jcos, jsin)
    ours = tl.apply_rope(torch.from_numpy(x), tcos, tsin)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    """fp32 statistics; an fp32 weight times the bf16 rows promotes and is
    cast back, as in the flax module."""
    x = _embeds(1)
    jmod = jl.LlamaRMSNorm(1e-5, dtype=getattr(jnp, dtype))
    params = random_params(jmod, 2, jnp.asarray(x))
    ref = jmod.apply({"params": params}, jnp.asarray(x, getattr(jnp, dtype)))
    ours = load_port(tl.LlamaRMSNorm(32, 1e-5), params)
    with torch.no_grad():
        out = ours(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    tol = ATOL if dtype == "float32" else 1e-2
    np.testing.assert_allclose(to_np(out), to_np(np.asarray(ref.astype(jnp.float32))), atol=tol, rtol=0)


@pytest.mark.parametrize("module", ["attention", "layer"])
def test_attention_and_layer_no_cache(impl, module):
    jcfg, tcfg = _cfg(jconfigs), _cfg(tconfigs)
    x, mask = _embeds(3), _mask()
    cos, sin = _rope_inputs(mask)
    jattn = {"causal": True, "padding_mask": jnp.asarray(mask)}
    tattn = {"causal": True, "padding_mask": torch.from_numpy(mask)}
    if module == "attention":
        jmod, tmod = jl.LlamaAttention(jcfg), tl.LlamaAttention(tcfg)
    else:
        jmod, tmod = jl.LlamaDecoderLayer(jcfg), tl.LlamaDecoderLayer(tcfg)
    args = (jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), jattn)
    params = random_params(jmod, 4, *args)
    ref, _ = jmod.apply({"params": params}, *args)
    ours = load_port(tmod, params)
    with torch.no_grad():
        out = ours(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin), tattn)
    np.testing.assert_allclose(to_np(out), to_np(ref), atol=ATOL, rtol=0)


def _lm_pair(tie=False, **flags):
    jcfg, tcfg = _cfg(jconfigs, tie_word_embeddings=tie, **flags), _cfg(tconfigs, tie_word_embeddings=tie, **flags)
    jmodel = jl.LlamaForCausalLM(jcfg)
    ids = jnp.zeros((B, S), jnp.int32)
    # touch embed_tokens too: an untied model's __call__ never does
    params = random_params(
        jmodel, 5, ids, method=lambda m, i: (m.embed(i), m(m.embed(i)))
    )
    return jcfg, jmodel, params, load_port(tl.LlamaForCausalLM(tcfg), params)


@pytest.mark.parametrize("tie", [False, True])
def test_causal_lm_no_cache(impl, tie):
    _, jmodel, params, ours = _lm_pair(tie)
    x, mask = _embeds(6), _mask()
    ref, _ = jmodel.apply({"params": params}, jnp.asarray(x), attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        logits, cache = ours(torch.from_numpy(x), attention_mask=torch.from_numpy(mask))
    assert cache is None
    np.testing.assert_allclose(to_np(logits), to_np(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("int8_kv", [False, True])
def test_causal_lm_prefill_and_decode_match_jax_cache(impl, int8_kv):
    jcfg, jmodel, params, ours = _lm_pair(int8_kv_cache=int8_kv)
    x, mask = _embeds(7), _mask()
    max_len = S + 3
    jcache = jopt.init_cache(jcfg, B, max_len)
    tcache = init_cache(ours.config, B, max_len)
    steps = [(x, mask)]
    rng = np.random.default_rng(8)
    for _ in range(3):
        steps.append((rng.normal(size=(B, 1, 32)).astype(np.float32), np.ones((B, 1), np.int32)))
    for xs, ms in steps:
        ref, jcache = jmodel.apply(
            {"params": params}, jnp.asarray(xs), attention_mask=jnp.asarray(ms), cache=jcache
        )
        with torch.no_grad():
            logits, tcache = ours(torch.from_numpy(xs), attention_mask=torch.from_numpy(ms), cache=tcache)
        np.testing.assert_allclose(to_np(logits), to_np(ref), atol=ATOL, rtol=0)
        assert tcache["index"] == int(jcache["index"])
        np.testing.assert_array_equal(tcache["mask"].numpy(), np.asarray(jcache["mask"]))
        np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(to_np(tcache[key]), to_np(jcache[key]), atol=ATOL, rtol=0)
            if int8_kv:
                np.testing.assert_allclose(
                    to_np(tcache[f"{key}_scale"]), to_np(jcache[f"{key}_scale"]), atol=1e-5, rtol=1e-2)


def test_unported_modes_raise():
    model = tl.LlamaForCausalLM(_cfg(tconfigs))
    x = torch.zeros(1, 3, 32)
    cache = init_cache(model.config, 1, 8)
    with torch.no_grad():
        model(x, cache_append=True)  # no cache: the flag has nothing to append to
        model(x, cache=cache)
        with pytest.raises(NotImplementedError):  # multi-token write into a filled cache
            model(x, cache=cache)
        # the speculative verify append is ported (tests/test_torch_cache_append.py)
        logits, _ = model(x, cache=cache, cache_append=True)
    assert logits.shape == (1, 3, 96) and cache["index"] == 6


def test_text_only_module_greedy_matches_jax(impl):
    """The slice as a whole on random weights: flax params -> params_from_jax
    -> the port's text-only module; the same greedy tokens as JAX."""
    jcfg, tcfg = _cfg(jconfigs), _cfg(tconfigs)
    jmod = JTextOnly(jconfigs.VideoBlipConfig(text_config=jcfg))
    ids = np.random.default_rng(9).integers(3, 96, size=(B, S)).astype(np.int32)
    mask = _mask()
    params = random_params(
        jmod, 10, jnp.asarray(ids),
        method=lambda m, i: (m.embed_and_scatter(i), m.lm_forward(m.embed_and_scatter(i))),
    )
    variables = {"params": params}
    gen = dict(max_new_tokens=6, pad_token_id=0, eos_token_id=())
    embeds = jmod.apply(variables, jnp.asarray(ids), method=JTextOnly.embed_and_scatter)
    ref = j_greedy(jmod, variables, embeds, jnp.asarray(mask), JGenerationConfig(**gen), jax.random.PRNGKey(0))

    tcfg_vb = tconfigs.VideoBlipConfig(text_config=tcfg)
    ours = _TextOnlyModule(tcfg_vb).eval()
    ours.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tcfg_vb), strict=True)
    with torch.no_grad():
        tokens = _greedy_sample_decoder_only(
            ours, ours.embed_and_scatter(torch.from_numpy(ids)), torch.from_numpy(mask),
            GenerationConfig(**gen),
        )
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref))
