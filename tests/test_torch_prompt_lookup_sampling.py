"""Prompt-lookup speculative SAMPLING in the port
(``generation/speculative.prompt_lookup_sample_decode``), at the 4-layer
tiny VideoBLIP-OPT in fp32.

Its draws come from a ``torch.Generator``, so it cannot be bit-identical to
JAX's ``jax.random`` stream; it is held as JAX's own test holds it
(``tests/generation/test_prompt_lookup_sampling.py``):
- at a point mass (temperature 1e-7) it emits exactly the greedy tokens of
  the port's and of JAX's prompt lookup;
- its per-(row, position) marginals match the port's plain sampling loop
  within JAX's bar (total variation < 0.10 at 1,200 draws, top_k 4);
- the pad-after-eos contract, the dispatch, the processor guard, the
  warpers over the (B, gamma + 1, V) verify logits, and the same tokens
  twice for the same seed.
"""

import numpy as np
import pytest
import torch

from eilev_tpu_torch.generation import GenerationConfig
from eilev_tpu_torch.generation.decoding import _greedy_sample_decoder_only, _seeded_noise
from eilev_tpu_torch.generation.speculative import build_lookup_corpus, prompt_lookup_sample_decode

from ._torch_spec import jax_tokens, port_inputs, port_tokens, tiny_world


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Hundreds of runs of tiny ops: one intra-op thread a test worker beats
    a pool contended by the other workers. Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world():
    w = tiny_world()
    inputs = port_inputs(w)
    with torch.inference_mode():
        w.embeds = w.model.embed_and_scatter(inputs["input_ids"], inputs["pixel_values"], inputs["video_input_mask"])
    w.tmask = inputs["attention_mask"]
    w.tcorpus = build_lookup_corpus(inputs["input_ids"], inputs["attention_mask"], inputs["video_input_mask"])
    return w


def test_point_mass_equals_greedy(world):
    """temperature -> 0 makes the warped distribution a point mass at the
    argmax: speculative sampling emits the greedy tokens, those of JAX's
    greedy prompt lookup and of the port's plain greedy."""
    greedy = jax_tokens(world, dict(max_new_tokens=10), draft="prompt_lookup", draft_tokens=4, draft_match_len=2)
    np.testing.assert_array_equal(port_tokens(world, dict(max_new_tokens=10)), greedy)
    for seed in (0, 7):
        sampled = port_tokens(
            world, dict(max_new_tokens=10, do_sample=True, temperature=1e-7),
            draft="prompt_lookup", draft_tokens=4, draft_match_len=2, generator=torch.Generator().manual_seed(seed),
        )
        np.testing.assert_array_equal(sampled, greedy)


def _marginals(tokens: np.ndarray, vocab: int) -> dict:
    """tokens: (N, B, L) -> the empirical distribution at each (row, position)."""
    return {(b, pos): np.bincount(tokens[:, b, pos], minlength=vocab) / tokens.shape[0]
            for b in range(tokens.shape[1]) for pos in range(tokens.shape[2])}


def _draw(world, gen_cfg, copies, runs, plain, spec):
    """``runs`` seeded runs of the plain sampling loop and of speculative
    sampling over ``copies`` copies of the batch, into ``plain`` and ``spec``."""
    embeds = world.embeds.repeat(copies, 1, 1)
    mask, corpus = world.tmask.repeat(copies, 1), world.tcorpus.repeat(copies, 1)
    for seed in range(runs):
        noise = _seeded_noise(torch.Generator().manual_seed(seed), embeds.device)
        plain.append(_greedy_sample_decoder_only(world.model, embeds, mask, gen_cfg, noise))
        spec.append(prompt_lookup_sample_decode(
            world.model.language_model, corpus, embeds, mask, gen_cfg,
            torch.Generator().manual_seed(10_000 + seed), gamma=3, match_len=2))


def test_marginals_match_the_plain_sampling_loop(world):
    """1,200 draws of each of the 2 rows (10 copies of the batch a run, 60
    seeded runs) from the plain loop and from speculative sampling (gamma
    3, match 2): the per-(row, position) marginals within total variation
    0.10, JAX's bar. top_k 4 bounds the support (noise floor ~0.04)."""
    tcfg = world.tcfg.text_config
    gen_cfg = GenerationConfig(max_new_tokens=3, pad_token_id=world.pad, eos_token_id=(), do_sample=True,
                               temperature=1.3, top_k=4)
    copies, runs = 10, 60
    plain, spec = [], []
    with torch.inference_mode():
        _draw(world, gen_cfg, copies, runs, plain, spec)

    def draws(outs):  # (runs * copies, 2, 3)
        return torch.stack(outs).view(runs * copies, 2, 3).numpy()

    mp, ms = _marginals(draws(plain), tcfg.vocab_size), _marginals(draws(spec), tcfg.vocab_size)
    for key in mp:
        tv = 0.5 * np.abs(mp[key] - ms[key]).sum()
        assert tv < 0.10, f"(row, pos)={key}: TV={tv:.3f}"


def test_eos_pad_contract_and_same_seed_same_tokens(world):
    """Wherever an eos is emitted every later position is pad; the same
    seed gives the same tokens twice; every token is in the vocabulary."""
    gen_cfg = GenerationConfig(max_new_tokens=8, pad_token_id=world.pad, eos_token_id=(5, 9), do_sample=True,
                               temperature=3.0)
    lm, saw_eos = world.model.language_model, False
    for seed in range(40):
        outs = [prompt_lookup_sample_decode(lm, world.tcorpus, world.embeds, world.tmask, gen_cfg,
                                            torch.Generator().manual_seed(seed), gamma=3, match_len=2).numpy()
                for _ in range(2)]
        np.testing.assert_array_equal(outs[0], outs[1])
        assert ((outs[0] >= 0) & (outs[0] < lm.config.vocab_size)).all()
        for row in outs[0]:
            eos_pos = np.where((row == 5) | (row == 9))[0]
            if eos_pos.size:
                saw_eos = True
                assert np.all(row[eos_pos[0] + 1 :] == world.pad)
    assert saw_eos, "temperature 3.0 over 40 seeds never emitted eos: bad setup"


def test_dispatch_processor_guard_and_3d_warpers(world):
    """generate(draft="prompt_lookup", do_sample=True) routes here (JAX's
    shape); typical_p and min_p warp the (B, gamma + 1, V) verify logits; a
    logits processor raises NotImplementedError, as in JAX."""
    gen = dict(max_new_tokens=6, do_sample=True, temperature=1.5)
    out = port_tokens(world, gen, draft="prompt_lookup", generator=torch.Generator().manual_seed(3))
    assert out.shape == (2, 6)
    out = port_tokens(world, dict(gen, typical_p=0.9, min_p=0.01), draft="prompt_lookup",
                      generator=torch.Generator().manual_seed(7))
    assert out.shape == (2, 6)
    with pytest.raises(NotImplementedError):
        port_tokens(world, dict(gen, repetition_penalty=1.2), draft="prompt_lookup")
    with pytest.raises(AssertionError, match="greedy"):
        prompt_lookup_sample_decode(world.model.language_model, world.tcorpus, world.embeds, world.tmask,
                                    GenerationConfig(max_new_tokens=2, pad_token_id=world.pad),
                                    torch.Generator())
