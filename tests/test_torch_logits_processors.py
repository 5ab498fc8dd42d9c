"""Port vs JAX: the sampling warpers, the logits processors and token
selection (``eilev_tpu_torch/generation/logits.py`` against
``eilev_tpu/generation/decoding.py``) on the same seeded fp32 logits.

- every warper and ``_warp_logits`` (min_keep 1 and 2) equal to JAX's;
- ``_process_scores`` equal to JAX's for each processor alone and for a
  combination, on pad-filled histories at every fill level (to 1e-6 where
  a log-softmax sums in another order);
- ``_select_token`` given JAX's ``jax.random.gumbel(key, shape)`` picks
  ``jax.random.categorical(key, warped)``;
- ``_top_k`` breaks ties lowest index first, as ``jax.lax.top_k``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu.generation import GenerationConfig as JGenerationConfig
from eilev_tpu.generation import decoding as jdec
from eilev_tpu_torch.generation import GenerationConfig
from eilev_tpu_torch.generation import logits as tlog

VOCAB = 64
PAD = 1


def _logits(seed=0, rows=6):
    return np.random.default_rng(seed).normal(scale=3.0, size=(rows, VOCAB)).astype(np.float32)


def _equal(ours, ref):
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


WARPERS = [
    ("_filter_top_k", 5), ("_filter_top_k", 1), ("_filter_top_p", 0.8), ("_filter_top_p", 0.3),
    ("_filter_min_p", 0.1), ("_filter_typical", 0.7), ("_filter_epsilon", 0.02), ("_filter_eta", 0.05),
]


@pytest.mark.parametrize("min_keep", [1, 2])
@pytest.mark.parametrize("name,param", WARPERS)
def test_warper_matches_jax(name, param, min_keep):
    x = _logits(1)
    _equal(getattr(tlog, name)(torch.from_numpy(x), param, min_keep),
           getattr(jdec, name)(jnp.asarray(x), param, min_keep))


@pytest.mark.parametrize("min_keep", [1, 2])
def test_warp_logits_chain_matches_jax(min_keep):
    knobs = dict(do_sample=True, temperature=0.7, top_k=20, top_p=0.9, min_p=0.02, typical_p=0.95,
                 epsilon_cutoff=1e-3, eta_cutoff=1e-3)
    x = _logits(2)
    _equal(tlog._warp_logits(torch.from_numpy(x), GenerationConfig(**knobs), min_keep),
           jdec._warp_logits(jnp.asarray(x), JGenerationConfig(**knobs), min_keep))


def _histories(rows=6, length=10):
    """Pad-filled-later histories over a 6-token alphabet, so n-grams and
    bad-word prefixes repeat."""
    return np.random.default_rng(3).integers(0, 6, size=(rows, length)).astype(np.int64)


PROCESSORS = {
    "sequence_bias": dict(sequence_bias=(((3,), 2.0), ((2, 4), -1.5), ((1, 2, 3), 0.7))),
    "repetition_penalty": dict(repetition_penalty=1.3),
    "no_repeat_ngram_2": dict(no_repeat_ngram_size=2),
    "no_repeat_ngram_3": dict(no_repeat_ngram_size=3),
    "bad_words_ids": dict(bad_words_ids=((5,), (2, 4), (7,), (0, 1, 2))),
    "min_new_tokens": dict(min_new_tokens=5),
    "forced_bos": dict(forced_bos_token_id=3),
    "forced_eos": dict(forced_eos_token_id=(7, 9)),
    "remove_invalid_values": dict(remove_invalid_values=True),
    "exponential_decay": dict(exponential_decay_length_penalty=(2, 1.5)),
    "suppress_tokens": dict(suppress_tokens=(4, 9)),
    "begin_suppress_tokens": dict(begin_suppress_tokens=(4, 11)),
    "renormalize_logits": dict(renormalize_logits=True),
    "combination": dict(sequence_bias=(((2, 4), -1.5),), repetition_penalty=1.2, no_repeat_ngram_size=2,
                        bad_words_ids=((0, 1),), min_new_tokens=3, remove_invalid_values=True,
                        exponential_decay_length_penalty=(1, 1.2), suppress_tokens=(9,),
                        begin_suppress_tokens=(4,), renormalize_logits=True),
}


@pytest.mark.parametrize("name", list(PROCESSORS))
def test_process_scores_matches_jax(name):
    knobs = dict(PROCESSORS[name], max_new_tokens=10, eos_token_id=(7, 0), pad_token_id=PAD)
    x = _logits(4)
    x[0, 5], x[1, 2], x[2, 8] = np.nan, np.inf, -np.inf  # for remove_invalid_values
    full = _histories()
    for n in range(full.shape[1] + 1):  # every fill level, the rest pad
        hist = full.copy()
        hist[:, n:] = PAD
        ours = tlog._process_scores(torch.from_numpy(x), GenerationConfig(**knobs), torch.from_numpy(hist), n, n)
        ref = jdec._process_scores(jnp.asarray(x), JGenerationConfig(**knobs), jnp.asarray(hist, jnp.int32),
                                   jnp.int32(n), jnp.int32(n))
        # exact but for the fp32 sums of a log-softmax (renormalize_logits):
        # 1e-6, a few ulps of the log-probs; inf and NaN positions must match
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6,
                                   err_msg=f"{name} at n_valid={n}")


@pytest.mark.parametrize("knobs", [dict(temperature=0.7, top_p=0.9), dict(top_k=5), dict(min_p=0.05, top_k=0)])
def test_select_token_is_jax_categorical_given_its_gumbel(knobs):
    cfg = dict(knobs, do_sample=True)
    x = _logits(5, rows=32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        ref = jax.random.categorical(key, jdec._warp_logits(jnp.asarray(x), JGenerationConfig(**cfg)), axis=-1)

        def noise(like, key=key):
            return torch.from_numpy(np.array(jax.random.gumbel(key, tuple(like.shape), jnp.float32)))

        ours = tlog._select_token(torch.from_numpy(x), GenerationConfig(**cfg), noise)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    greedy = tlog._select_token(torch.from_numpy(x), GenerationConfig(), None)
    np.testing.assert_array_equal(greedy.numpy(), np.argmax(x, axis=-1))


def test_top_k_breaks_ties_lowest_index_first():
    x = np.array([[0.5, 2.0, 2.0, -np.inf, 2.0, 0.5, -np.inf, -np.inf],
                  [-np.inf] * 8, [1.0, 1.0, 1.0, 1.0, 3.0, 1.0, 1.0, 1.0]], np.float32)
    for k in (1, 3, 5, 8):
        values, indices = tlog._top_k(torch.from_numpy(x), k)
        ref_values, ref_indices = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(values.numpy(), np.asarray(ref_values))
        np.testing.assert_array_equal(indices.numpy(), np.asarray(ref_indices))
    assert tlog._top_k(torch.from_numpy(x), 3)[1].tolist()[0] == [1, 2, 4]


def test_gumbel_noise_is_finite_and_seeded():
    noise = tlog.gumbel_noise(torch.Generator().manual_seed(0))
    like = torch.zeros(64, 1000)
    a = noise(like)
    assert a.shape == like.shape and a.dtype == torch.float32 and bool(torch.isfinite(a).all())
    # standard Gumbel: mean 0.5772 (Euler's gamma), variance pi^2 / 6
    assert abs(a.mean().item() - 0.5772) < 0.02 and abs(a.var().item() - np.pi**2 / 6) < 0.05
    torch.testing.assert_close(tlog.gumbel_noise(torch.Generator().manual_seed(0))(like), a, atol=0, rtol=0)
    bf16 = noise(like.to(torch.bfloat16))
    assert bf16.dtype == torch.bfloat16 and bool(torch.isfinite(bf16).all())


def test_processors_leave_scores_unwritten():
    x = torch.from_numpy(_logits(6))
    before = x.clone()
    cfg = dataclasses.replace(GenerationConfig(**PROCESSORS["combination"]), eos_token_id=(7,))
    tlog._process_scores(x, cfg, torch.from_numpy(_histories()), 5, 5)
    torch.testing.assert_close(x, before, atol=0, rtol=0)
