"""Port vs JAX: contrastive search and streaming generation
(``generation/decoding.py``) at the 4-layer tiny VideoBLIP-OPT, fp32.

- ``lm_candidates`` (k one-token candidates over the shared read-only
  cache) and ``lm_forward_hidden`` against the flax methods (atol 1e-4);
  the candidates leave the cache as they found it.
- Contrastive search (penalty_alpha 0.6, top_k 4) at batch 1 and 2: the
  tokens of JAX's ``generate``.
- ``generate_stream`` greedy at chunks 1, 3 and 4: the concatenation equals
  JAX's and the port's ``generate``; sampling equals the port's
  ``generate`` with the same generator; every guard raises what JAX's does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu.generation import GenerationConfig as JGenerationConfig
from eilev_tpu.generation import generate_stream as j_stream
from eilev_tpu.models import opt as jopt
from eilev_tpu.models.video_blip import VideoBlipForConditionalGeneration as JVB
from eilev_tpu_torch.generation import GenerationConfig, generate_stream
from eilev_tpu_torch.models import init_cache

from ._torch_port import to_np
from ._torch_spec import jax_inputs, jax_tokens, port_inputs, port_tokens, tiny_world

CONTRASTIVE = dict(penalty_alpha=0.6, top_k=4)


@pytest.fixture(scope="module")
def world():
    return tiny_world()


def test_lm_candidates_and_hidden_match_jax(world):
    """Prefill with hidden states, one step, then k = 4 candidates over the
    cache: logits and hidden states against the flax methods at 1e-4."""
    variables = {"params": world.params}
    jin, tin = jax_inputs(world), port_inputs(world)
    jembeds = world.jmodel.apply(variables, jin["input_ids"], jin["pixel_values"], jin["video_input_mask"],
                                 method=JVB.embed_and_scatter)
    b, s = world.ids.shape
    jcache = jopt.init_cache(world.cfg.text_config, b, s + 4, jnp.float32)
    tcache = init_cache(world.tcfg.text_config, b, s + 4)
    cand = np.random.default_rng(2).integers(4, world.cfg.text_config.vocab_size, size=(b, 4)).astype(np.int32)
    step = np.asarray([[7], [9]], np.int32)
    with torch.inference_mode():
        tembeds = world.model.embed_and_scatter(tin["input_ids"], tin["pixel_values"], tin["video_input_mask"])
        for x_j, x_t, m in ((jembeds, tembeds, world.mask), (None, None, np.ones((b, 1), np.int32))):
            if x_j is None:
                x_j = world.jmodel.apply(variables, jnp.asarray(step), method=JVB.lm_embed)
                x_t = world.model.lm_embed(torch.from_numpy(step))
            ref_logits, ref_hidden, jcache = world.jmodel.apply(
                variables, x_j, attention_mask=jnp.asarray(m), cache=jcache, method=JVB.lm_forward_hidden)
            logits, hidden, tcache = world.model.lm_forward_hidden(x_t, attention_mask=torch.from_numpy(m),
                                                                   cache=tcache)
            np.testing.assert_allclose(to_np(hidden), to_np(ref_hidden), atol=1e-4, rtol=0)
            np.testing.assert_allclose(to_np(logits), to_np(ref_logits), atol=1e-4, rtol=0)
        before = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in tcache.items()}
        ref = world.jmodel.apply(variables, world.jmodel.apply(variables, jnp.asarray(cand), method=JVB.lm_embed),
                                 jcache, method=JVB.lm_candidates)
        ours = world.model.lm_candidates(world.model.lm_embed(torch.from_numpy(cand)), tcache)
    for got, want in zip(ours, ref):
        assert got.shape[:2] == (b, 4)
        np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-4, rtol=0)
    assert all(torch.equal(tcache[k], v) if torch.is_tensor(v) else tcache[k] == v for k, v in before.items())


@pytest.mark.parametrize("rows", [slice(1, 2), slice(0, 2)], ids=["batch 1", "batch 2"])
def test_contrastive_search_matches_jax(world, rows):
    gen = dict(max_new_tokens=10, **CONTRASTIVE)
    ours = port_tokens(world, gen, rows)
    np.testing.assert_array_equal(ours, jax_tokens(world, gen, rows))
    # not greedy's tokens: the degeneration penalty changes the choice
    assert not np.array_equal(ours, port_tokens(world, dict(max_new_tokens=10), rows))


def test_contrastive_search_early_eos_matches_jax(world):
    probe = port_tokens(world, dict(max_new_tokens=10, **CONTRASTIVE))
    gen = dict(max_new_tokens=10, eos_token_id=(int(probe[0, 2]),), **CONTRASTIVE)
    ours = port_tokens(world, gen)
    np.testing.assert_array_equal(ours, jax_tokens(world, gen))
    assert (ours[0, 3:] == world.pad).all()


@pytest.mark.parametrize("chunk", [1, 3, 4])
def test_stream_greedy_matches_generate(world, chunk):
    gen = dict(max_new_tokens=10)
    chunks = list(generate_stream(world.model, generation_config=GenerationConfig(pad_token_id=world.pad, **gen),
                                  chunk_tokens=chunk, **port_inputs(world)))
    assert all(c.shape[1] <= chunk for c in chunks)
    streamed = torch.cat(chunks, dim=1).numpy()
    np.testing.assert_array_equal(streamed, jax_tokens(world, gen))
    np.testing.assert_array_equal(streamed, port_tokens(world, gen))


def test_stream_stops_once_every_row_is_done(world):
    """eos = both rows' first greedy tokens: one chunk, all pad after."""
    greedy = port_tokens(world, dict(max_new_tokens=10))
    gen = GenerationConfig(max_new_tokens=10, pad_token_id=world.pad, eos_token_id=tuple(greedy[:, 0].tolist()))
    chunks = list(generate_stream(world.model, generation_config=gen, chunk_tokens=3, **port_inputs(world)))
    assert len(chunks) == 1 and (chunks[0][:, 1:] == world.pad).all()


def test_stream_sampling_matches_generate(world):
    gen = GenerationConfig(max_new_tokens=8, pad_token_id=world.pad, do_sample=True, temperature=0.9, top_k=8)
    streamed = torch.cat(list(generate_stream(
        world.model, generation_config=gen, generator=torch.Generator().manual_seed(7), chunk_tokens=3,
        **port_inputs(world))), dim=1).numpy()
    ref = port_tokens(world, dict(max_new_tokens=8, do_sample=True, temperature=0.9, top_k=8),
                      generator=torch.Generator().manual_seed(7))
    n = min(streamed.shape[1], ref.shape[1])
    np.testing.assert_array_equal(streamed[:, :n], ref[:, :n])


@pytest.mark.parametrize("knobs", [
    dict(num_beams=5),
    dict(repetition_penalty=1.2),
    dict(do_sample=True, num_return_sequences=2),
    CONTRASTIVE,
    dict(min_length=30),
], ids=["beam", "processor", "nrs", "contrastive", "min_length"])
def test_stream_guards_raise_what_jax_raises(world, knobs):
    with pytest.raises(NotImplementedError):
        next(j_stream(world.jmodel, {"params": world.params},
                      generation_config=JGenerationConfig(pad_token_id=world.pad, **knobs), **jax_inputs(world)))
    with pytest.raises(NotImplementedError):
        next(generate_stream(world.model, generation_config=GenerationConfig(pad_token_id=world.pad, **knobs),
                             **port_inputs(world)))
