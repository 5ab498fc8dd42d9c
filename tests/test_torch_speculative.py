"""Port vs JAX: self-draft speculative greedy decoding
(``generation/speculative.py``), at a 4-layer tiny VideoBLIP-OPT and a
4-layer tiny LLaMA in fp32.

The tokens of ``generate(draft_layers=N, draft_tokens=gamma)`` must equal
JAX's with the same arguments and the plain greedy tokens of both packages
(the guarantee is structural: the verify pass recomputes the target's
argmax). The self-draft shares the target's parameters. Every guard of the
speculative dispatch raises the error type JAX raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu.configs import LlamaConfig as JLlamaConfig
from eilev_tpu.generation import GenerationConfig as JGenerationConfig
from eilev_tpu.generation.speculative import make_self_draft as j_make_self_draft
from eilev_tpu.generation.speculative import speculative_greedy_decode as j_spec
from eilev_tpu.models import opt as jopt
from eilev_tpu.models.llama import LlamaForCausalLM as JLlama
from eilev_tpu_torch.configs import LlamaConfig
from eilev_tpu_torch.generation import GenerationConfig
from eilev_tpu_torch.generation.speculative import make_self_draft, speculative_greedy_decode
from eilev_tpu_torch.models import init_cache
from eilev_tpu_torch.models.llama import LlamaForCausalLM

from ._torch_port import load_port, random_params
from ._torch_spec import jax_tokens, port_tokens, tiny_world

MAX_NEW = 10


@pytest.fixture(scope="module")
def world():
    w = tiny_world()
    w.greedy = jax_tokens(w, dict(max_new_tokens=MAX_NEW))
    return w


def test_plain_greedy_matches_jax_and_varies(world):
    ours = port_tokens(world, dict(max_new_tokens=MAX_NEW))
    np.testing.assert_array_equal(ours, world.greedy)
    # the weights give text that changes token to token, so drafts both
    # land and miss
    assert all(len(set(row.tolist())) >= 3 for row in ours)


@pytest.mark.parametrize("draft_layers,gamma", [(1, 3), (2, 2), (4, 4)])
def test_self_draft_tokens_identical_to_jax(world, draft_layers, gamma):
    gen = dict(max_new_tokens=MAX_NEW)
    kw = dict(draft_layers=draft_layers, draft_tokens=gamma)
    ref = jax_tokens(world, gen, **kw)
    ours = port_tokens(world, gen, **kw)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, world.greedy)


def test_self_draft_respects_eos(world):
    """A broad eos set ends rows early: the pad-after-eos contract holds
    through the block emissions, and the tokens are JAX's."""
    gen = dict(max_new_tokens=12, eos_token_id=tuple(range(0, world.cfg.text_config.vocab_size, 3)))
    ref = jax_tokens(world, gen, draft_layers=2, draft_tokens=3)
    ours = port_tokens(world, gen, draft_layers=2, draft_tokens=3)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, port_tokens(world, gen))
    assert (ours == world.pad).any(), "no row ended early: the eos set misses"


def test_self_draft_shares_the_targets_parameters(world):
    lm = world.model.language_model
    draft = make_self_draft(lm, 2)
    assert type(draft) is type(lm) and draft.config.num_hidden_layers == 2 and len(draft.layers) == 2
    assert lm.config.num_hidden_layers == 4 and len(lm.layers) == 4
    target = {id(p) for p in lm.parameters()}
    assert all(id(p) in target for p in draft.parameters())
    assert draft.layers[1] is lm.layers[1] and draft.embed_tokens is lm.embed_tokens
    # its own stacked cache, over its own layers
    assert init_cache(draft.config, 2, 8)["k"].shape[0] == 2


def _llama():
    kw = dict(vocab_size=96, hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
              num_key_value_heads=2, intermediate_size=64, max_position_embeddings=128)
    jcfg, tcfg = JLlamaConfig(**kw), LlamaConfig(**kw)
    jmodel = JLlama(jcfg)

    def init_all(mdl):
        return mdl(mdl.embed(jnp.zeros((1, 4), jnp.int32)))

    params = random_params(jmodel, 7, method=init_all, std=0.5)
    return jcfg, jmodel, params, load_port(LlamaForCausalLM(tcfg), params)


def test_llama_self_draft_matches_jax_and_stepwise_greedy():
    """LLaMA (4 heads over 2 kv heads): the port's speculative_greedy_decode
    at (1, 3) and (4, 2) against JAX's on the same weights and embeddings,
    and against the port's own stepwise greedy; row 1 left-padded."""
    jcfg, jmodel, params, ours = _llama()
    rng = np.random.default_rng(7)
    ids = rng.integers(3, jcfg.vocab_size, size=(2, 9)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, :2] = 0
    max_new, eos = 8, (jcfg.vocab_size + 5,)
    jembeds = jmodel.apply({"params": params}, jnp.asarray(ids), method=JLlama.embed)
    with torch.no_grad():
        embeds = ours.embed(torch.from_numpy(ids))
        cache = init_cache(ours.config, 2, ids.shape[1] + max_new)
        logits, _ = ours(embeds, attention_mask=torch.from_numpy(mask), cache=cache)
        toks = []
        for _ in range(max_new):
            tok = logits[:, -1].argmax(-1)
            toks.append(tok)
            logits, _ = ours(ours.embed(tok[:, None]), cache=cache)
    plain = torch.stack(toks, 1).numpy()
    for draft_layers, gamma in [(1, 3), (4, 2)]:
        draft, dparams = j_make_self_draft(jcfg, params, draft_layers, None)
        ref = np.asarray(j_spec(
            JLlama(jcfg), params, type(draft)(draft.config), dparams, jembeds, jnp.asarray(mask),
            JGenerationConfig(max_new_tokens=max_new, pad_token_id=0, eos_token_id=eos), gamma=gamma))
        got = speculative_greedy_decode(
            ours, make_self_draft(ours, draft_layers), embeds, torch.from_numpy(mask),
            GenerationConfig(max_new_tokens=max_new, pad_token_id=0, eos_token_id=eos), gamma=gamma).numpy()
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, plain)


GUARDS = [
    # (generation config knobs, generate arguments, the error JAX raises)
    (dict(penalty_alpha=0.6, top_k=4), dict(draft_layers=1), NotImplementedError),
    (dict(penalty_alpha=0.6, top_k=4), dict(draft="prompt_lookup"), NotImplementedError),
    (dict(repetition_penalty=1.2), dict(draft_layers=1), NotImplementedError),
    (dict(repetition_penalty=1.2), dict(draft="prompt_lookup"), NotImplementedError),
    (dict(do_sample=True, num_return_sequences=2), dict(draft="prompt_lookup"), NotImplementedError),
    (dict(), dict(draft="tree_attention"), ValueError),
]


@pytest.mark.parametrize("gen,kw,error", GUARDS)
def test_guards_raise_what_jax_raises(world, gen, kw, error):
    gen = dict(max_new_tokens=4, **gen)
    with pytest.raises(error):
        jax_tokens(world, gen, **kw)
    with pytest.raises(error):
        port_tokens(world, gen, **kw)


def test_greedy_only_asserts(world):
    lm = world.model.language_model
    embeds = torch.zeros(1, 3, lm.config.word_embed_proj_dim)
    with pytest.raises(AssertionError, match="greedy only"):
        speculative_greedy_decode(lm, make_self_draft(lm, 1), embeds, torch.ones(1, 3, dtype=torch.int32),
                                  GenerationConfig(do_sample=True, pad_token_id=1))
    with pytest.raises(AssertionError):
        j_spec(jopt.OPTForCausalLM(world.cfg.text_config), world.params["language_model"],
               jopt.OPTForCausalLM(world.cfg.text_config), world.params["language_model"],
               jnp.zeros((1, 3, 16)), jnp.ones((1, 3), jnp.int32),
               JGenerationConfig(do_sample=True, pad_token_id=1))


def test_draft_layers_with_sampling_is_the_plain_sampling_loop(world):
    """``draft_layers`` with ``do_sample`` falls through to the plain
    sampling loop, as in JAX: the same draws from the same generator."""
    gen = dict(max_new_tokens=6, do_sample=True, temperature=1.5)
    a = port_tokens(world, gen, draft_layers=2, generator=torch.Generator().manual_seed(4))
    b = port_tokens(world, gen, generator=torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(a, b)
