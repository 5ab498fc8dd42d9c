"""Port vs JAX: model-free prompt-lookup speculative greedy decoding
(``generation/speculative.py``) at the 4-layer tiny VideoBLIP-OPT, fp32.

The tokens of ``generate(draft="prompt_lookup")`` equal JAX's on the
default corpus (input ids with padding and video slots masked), a random
corpus (every draft rejected) and an echo corpus holding the target's own
future text (most drafts accepted), also over an int8 KV cache and with an
early eos; ``return_stats`` gives JAX's tokens and verify passes; the
matcher ``lookup_drafts_rows`` and ``build_lookup_corpus`` return exactly
JAX's integers, out-of-vocabulary and -1 corpus entries included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu.generation import GenerationConfig as JGenerationConfig
from eilev_tpu.generation.speculative import build_lookup_corpus as j_corpus
from eilev_tpu.generation.speculative import lookup_drafts_rows as j_lookup
from eilev_tpu.generation.speculative import prompt_lookup_greedy_decode as j_pld
from eilev_tpu.models.opt import OPTForCausalLM as JOPT
from eilev_tpu.models.video_blip import VideoBlipForConditionalGeneration as JVB
from eilev_tpu_torch.generation import GenerationConfig
from eilev_tpu_torch.generation.speculative import (
    build_lookup_corpus,
    lookup_drafts_rows,
    prompt_lookup_greedy_decode,
)

from ._torch_spec import jax_inputs, jax_tokens, port_inputs, port_tokens, tiny_world

MAX_NEW = 12


@pytest.fixture(scope="module")
def world():
    w = tiny_world()
    w.greedy = jax_tokens(w, dict(max_new_tokens=MAX_NEW))
    w.corpus = np.asarray(j_corpus(jnp.asarray(w.ids), jnp.asarray(w.mask), jnp.asarray(w.vim)))
    return w


@pytest.mark.parametrize("gamma,match_len", [(4, 3), (8, 2), (2, 1)])
def test_default_corpus_token_identical_to_jax(world, gamma, match_len):
    kw = dict(draft="prompt_lookup", draft_tokens=gamma, draft_match_len=match_len)
    ours = port_tokens(world, dict(max_new_tokens=MAX_NEW), **kw)
    np.testing.assert_array_equal(ours, jax_tokens(world, dict(max_new_tokens=MAX_NEW), **kw))
    np.testing.assert_array_equal(ours, world.greedy)


def _corpora(world):
    garbage = np.random.default_rng(5).integers(4, world.cfg.text_config.vocab_size, size=world.ids.shape)
    echo = np.concatenate([world.corpus, world.greedy], axis=1)  # like a 17th shot
    return {"random": garbage.astype(np.int32), "echo": echo.astype(np.int32)}


@pytest.mark.parametrize("corpus", ["random", "echo"])
def test_given_corpus_token_identical_to_jax(world, corpus):
    c = _corpora(world)[corpus]
    gen = dict(max_new_tokens=MAX_NEW)
    ref = jax_tokens(world, gen, draft="prompt_lookup", draft_tokens=8, lookup_corpus=jnp.asarray(c))
    ours = port_tokens(world, gen, draft="prompt_lookup", draft_tokens=8, lookup_corpus=torch.from_numpy(c))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, world.greedy)


def test_stats_equal_jax(world):
    """``return_stats``: (tokens emitted, verify passes) equal JAX's on the
    echo and the random corpus; the echo corpus advances more than 1.5
    tokens a pass."""
    tcfg = world.cfg.text_config
    gcfg = dict(max_new_tokens=MAX_NEW, pad_token_id=world.pad, eos_token_id=(tcfg.eos_token_id,))
    jembeds = world.jmodel.apply({"params": world.params}, *(jax_inputs(world)[k] for k in (
        "input_ids", "pixel_values", "video_input_mask")), method=JVB.embed_and_scatter)
    inputs = port_inputs(world)
    with torch.inference_mode():
        embeds = world.model.embed_and_scatter(inputs["input_ids"], inputs["pixel_values"],
                                               inputs["video_input_mask"])
    stats = {}
    for name, c in _corpora(world).items():
        ref, (n_ref, it_ref) = j_pld(JOPT(tcfg), world.params["language_model"], jnp.asarray(c), jembeds,
                                     jnp.asarray(world.mask), JGenerationConfig(**gcfg), gamma=8,
                                     return_stats=True)
        ours, (n, it) = prompt_lookup_greedy_decode(
            world.model.language_model, torch.from_numpy(c), embeds, inputs["attention_mask"],
            GenerationConfig(**gcfg), gamma=8, return_stats=True)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        assert (n, it) == (int(n_ref), int(it_ref)), name
        stats[name] = n / it
    assert stats["echo"] > 1.5, stats


def test_int8_kv_composes(world):
    """Prompt lookup over an int8 KV cache: JAX's tokens, and the port's own
    int8 plain greedy (the rollback only moves mask, pos and index; the
    quantized rows and scales stay behind the mask)."""
    w8 = tiny_world(int8_kv=True)
    gen = dict(max_new_tokens=8)
    ours = port_tokens(w8, gen, draft="prompt_lookup")
    np.testing.assert_array_equal(ours, jax_tokens(w8, gen, draft="prompt_lookup"))
    np.testing.assert_array_equal(ours, port_tokens(w8, gen))


def test_eos_early_stop(world):
    """eos = the third greedy token of row 0: the rows stop as JAX's do."""
    eos = int(world.greedy[0, 2])
    gen = dict(max_new_tokens=10, eos_token_id=(eos,))
    ours = port_tokens(world, gen, draft="prompt_lookup")
    np.testing.assert_array_equal(ours, jax_tokens(world, gen, draft="prompt_lookup"))
    np.testing.assert_array_equal(ours, port_tokens(world, gen))
    assert (ours[0, 3:] == world.pad).all()


def test_build_lookup_corpus_equals_jax(world):
    ids = np.asarray([[5, 6, 7, 8]], np.int32)
    mask, vim = np.asarray([[0, 1, 1, 1]]), np.asarray([[0, 0, 1, 0]])
    ours = build_lookup_corpus(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(vim))
    np.testing.assert_array_equal(ours.numpy(), [[-1, 6, -1, 8]])
    ours = build_lookup_corpus(*(torch.from_numpy(x) for x in (world.ids, world.mask, world.vim)))
    np.testing.assert_array_equal(ours.numpy(), world.corpus)
    np.testing.assert_array_equal(build_lookup_corpus(torch.from_numpy(world.ids)).numpy(), world.ids)


@pytest.mark.parametrize("gamma,match_len", [(4, 3), (8, 2), (3, 1)])
def test_lookup_drafts_rows_equals_jax(gamma, match_len):
    """Random corpora over a small alphabet (so n-grams repeat), with -1
    holes and ids past a vocabulary of 6, rows ending at different places
    (down to fewer tokens than the n-gram): the same drafts as JAX's, to the
    integer."""
    rng = np.random.default_rng(gamma * 10 + match_len)
    for trial in range(8):
        corpus = rng.integers(0, 8, size=(5, 40)).astype(np.int32)
        corpus[rng.random(corpus.shape) < 0.1] = -1
        end = rng.integers(1, 30, size=5).astype(np.int32)
        end[0] = 1 + trial % 3
        ref = j_lookup(jnp.asarray(corpus), jnp.asarray(end), gamma, match_len, pad=1, vocab=6)
        ours = lookup_drafts_rows(torch.from_numpy(corpus), torch.from_numpy(end), gamma, match_len, pad=1,
                                  vocab=6)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        assert ((ours.numpy() >= 0) & (ours.numpy() < 6)).all()  # never out of the vocabulary
        ref = j_lookup(jnp.asarray(corpus), jnp.asarray(end), gamma, match_len, pad=1)
        ours = lookup_drafts_rows(torch.from_numpy(corpus), torch.from_numpy(end), gamma, match_len, pad=1)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
