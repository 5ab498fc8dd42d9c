"""Port vs JAX: multi-token cache appends (``cache_append=True``, the
speculative verify pass) and ``with_hidden`` of OPT and LLaMA, at tiny
geometries in fp32, atol 1e-4.

A prompt (row 0 left-padded) is prefilled into the stacked cache, one
decode step follows, then a 3-token block is appended: the logits and the
cache (mask, pos, index, k/v and the int8 scales) are held against the JAX
module's functional update entry by entry, over a model-dtype cache and an
int8 one; a decode step after the append checks the state it leaves. In the
port alone, the append equals the same tokens fed as one-token steps.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu import configs as jconfigs
from eilev_tpu.models import llama as jl
from eilev_tpu.models import opt as jopt
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.models import init_cache
from eilev_tpu_torch.models import llama as tl
from eilev_tpu_torch.models.opt import OPTForCausalLM

from ._torch_port import load_port, random_params, to_np

ATOL = 1e-4
B, S, SLOTS, BLOCK = 2, 7, 16, 3


def _opt_cfg(mod, int8_kv):
    c = mod.tiny_config(layers=3).text_config
    return dataclasses.replace(c, word_embed_proj_dim=8, int8_kv_cache=int8_kv)


def _llama_cfg(mod, int8_kv):
    return mod.LlamaConfig(
        vocab_size=96, hidden_size=32, num_hidden_layers=3, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=64, max_position_embeddings=128, int8_kv_cache=int8_kv,
    )


def _inputs(d):
    rng = np.random.default_rng(5)
    prompt = rng.normal(size=(B, S, d)).astype(np.float32)
    step = rng.normal(size=(B, 1, d)).astype(np.float32)
    block = rng.normal(size=(B, BLOCK, d)).astype(np.float32)
    after = rng.normal(size=(B, 1, d)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[0, :2] = 0  # left padding
    return prompt, mask, step, block, after


def _pair(family, int8_kv):
    if family == "opt":
        jcfg, tcfg = _opt_cfg(jconfigs, int8_kv), _opt_cfg(tconfigs, int8_kv)
        jmodel, d = jopt.OPTForCausalLM(jcfg), jcfg.word_embed_proj_dim
        params = random_params(jmodel, 4, jnp.zeros((1, 3, d)))
        return jcfg, jmodel, params, load_port(OPTForCausalLM(tcfg), params), d
    jcfg, tcfg = _llama_cfg(jconfigs, int8_kv), _llama_cfg(tconfigs, int8_kv)
    jmodel = jl.LlamaForCausalLM(jcfg)

    def init_all(mdl):
        return mdl(mdl.embed(jnp.zeros((1, 4), jnp.int32)))

    params = random_params(jmodel, 4, method=init_all)
    return jcfg, jmodel, params, load_port(tl.LlamaForCausalLM(tcfg), params), jcfg.hidden_size


def _assert_cache(tcache, jcache, int8_kv):
    assert tcache["index"] == int(jcache["index"])
    np.testing.assert_array_equal(tcache["mask"].numpy(), np.asarray(jcache["mask"]))
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(to_np(tcache[key]), to_np(jcache[key]), atol=ATOL, rtol=0)
        if int8_kv:
            np.testing.assert_allclose(
                to_np(tcache[f"{key}_scale"]), to_np(jcache[f"{key}_scale"]), atol=1e-5, rtol=1e-2)


@pytest.mark.parametrize("int8_kv", [False, True], ids=["model-dtype cache", "int8 KV"])
@pytest.mark.parametrize("family", ["opt", "llama"])
def test_cache_append_matches_jax(family, int8_kv):
    jcfg, jmodel, params, ours, d = _pair(family, int8_kv)
    prompt, mask, step, block, after = _inputs(d)
    jcache = jopt.init_cache(jcfg, B, SLOTS, jnp.float32)
    tcache = init_cache(ours.config, B, SLOTS)
    variables = {"params": params}
    with torch.no_grad():
        for x, m, append in ((prompt, mask, False), (step, None, False), (block, None, True),
                             (after, None, False)):
            kw = {} if m is None else {"attention_mask": m}
            ref, jcache = jmodel.apply(variables, jnp.asarray(x), cache=jcache, cache_append=append,
                                       **{k: jnp.asarray(v) for k, v in kw.items()})
            logits, tcache = ours(torch.from_numpy(x), cache=tcache, cache_append=append,
                                  **{k: torch.from_numpy(v) for k, v in kw.items()})
            np.testing.assert_allclose(to_np(logits), to_np(ref), atol=ATOL, rtol=0)
            _assert_cache(tcache, jcache, int8_kv)
    assert tcache["index"] == S + 1 + BLOCK + 1


@pytest.mark.parametrize("family", ["opt", "llama"])
def test_cache_append_equals_one_token_steps(family):
    """A gamma+1-token append gives the logits, cache state and k/v rows of
    gamma+1 one-token steps (the JAX test's bar, 2e-5)."""
    _, _, _, ours, d = _pair(family, False)
    prompt, mask, _, block, _ = _inputs(d)
    caches = []
    with torch.no_grad():
        for stepwise in (True, False):
            cache = init_cache(ours.config, B, SLOTS)
            ours(torch.from_numpy(prompt), attention_mask=torch.from_numpy(mask), cache=cache)
            if stepwise:
                steps = [ours(torch.from_numpy(block[:, j : j + 1]), cache=cache)[0][:, 0] for j in range(BLOCK)]
                step_logits = torch.stack(steps, dim=1)
            else:
                blk_logits, _ = ours(torch.from_numpy(block), cache=cache, cache_append=True)
            caches.append(cache)
    torch.testing.assert_close(blk_logits, step_logits, atol=2e-5, rtol=2e-5)
    stepped, appended = caches
    assert appended["index"] == stepped["index"] == S + BLOCK
    for key in ("mask", "pos"):
        assert torch.equal(appended[key], stepped[key]), key
    for key in ("k", "v"):
        torch.testing.assert_close(appended[key], stepped[key], atol=2e-5, rtol=2e-5)


def test_multi_token_write_into_a_filled_cache_needs_cache_append():
    _, _, _, ours, d = _pair("opt", False)
    prompt, mask, _, block, _ = _inputs(d)
    cache = init_cache(ours.config, B, SLOTS)
    with torch.no_grad():
        ours(torch.from_numpy(prompt), attention_mask=torch.from_numpy(mask), cache=cache)
        with pytest.raises(NotImplementedError, match="cache_append"):
            ours(torch.from_numpy(block), cache=cache)


@pytest.mark.parametrize("cached", [False, True], ids=["no cache", "prefill and step"])
def test_opt_with_hidden_matches_jax(cached):
    """``with_hidden=True``: (logits, hidden, cache), hidden the final norm and
    out-projection's output (HF ``hidden_states[-1]``), against JAX."""
    jcfg, jmodel, params, ours, d = _pair("opt", False)
    prompt, mask, step, _, _ = _inputs(d)
    variables = {"params": params}
    jcache = jopt.init_cache(jcfg, B, SLOTS, jnp.float32) if cached else None
    tcache = init_cache(ours.config, B, SLOTS) if cached else None
    feeds = ((prompt, mask), (step, np.ones((B, 1), np.int32))) if cached else ((prompt, mask),)
    with torch.no_grad():
        for x, m in feeds:
            ref_logits, ref_hidden, jcache = jmodel.apply(
                variables, jnp.asarray(x), attention_mask=jnp.asarray(m), cache=jcache, with_hidden=True)
            logits, hidden, tcache = ours(torch.from_numpy(x), attention_mask=torch.from_numpy(m), cache=tcache,
                                          with_hidden=True)
            assert hidden.shape == (B, x.shape[1], d)
            np.testing.assert_allclose(to_np(hidden), to_np(ref_hidden), atol=ATOL, rtol=0)
            np.testing.assert_allclose(to_np(logits), to_np(ref_logits), atol=ATOL, rtol=0)
