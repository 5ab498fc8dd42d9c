"""Port vs JAX: TextLM's beam search, sampling and logits processors on the
tiny HF LLaMA (GQA) and OPT checkpoints of ``tests/test_torch_text_lm.py``,
in fp32.

- Beam (3 beams, length_penalty -1, and ``num_return_sequences`` 2) and
  greedy with processors: the same texts from ``TextLM.generate`` as from
  ``eilev_tpu.generation.text_lm.TextLM.generate``, and the same beam tokens
  from ``_beam_search_decoder_only``.
- Sampling (with ``num_return_sequences`` 2) and beam_sample: tokens
  identical to JAX's loops when the port's noise replays JAX's key splits;
  ``TextLM.generate`` with one ``torch.Generator`` seed gives the same texts
  twice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu.generation import GenerationConfig as JGenerationConfig
from eilev_tpu.generation import decoding as jdec
from eilev_tpu.generation.text_lm import TextLM as JTextLM
from eilev_tpu_torch.generation import GenerationConfig, TextLM
from eilev_tpu_torch.generation import decoding as tdec

from .test_torch_sampling import replay
from .test_torch_text_lm import PROMPTS, _batch, llama_checkpoint, opt_checkpoint  # noqa: F401  (fixtures)

MAX_NEW = 8


@pytest.fixture(scope="module")
def pairs(llama_checkpoint, opt_checkpoint):  # noqa: F811
    """(JAX TextLM, port TextLM) on each checkpoint."""
    return {family: (JTextLM(path, dtype=jnp.float32), TextLM(path, dtype=torch.float32, device="cpu"))
            for family, path in (("llama", llama_checkpoint), ("opt", opt_checkpoint))}


def _gen(jlm, **knobs):
    return dict(knobs, max_new_tokens=MAX_NEW, pad_token_id=jlm.tokenizer.pad_token_id, eos_token_id=(0,))


MODES = {
    "beam3_lp-1": dict(num_beams=3, length_penalty=-1.0),
    "beam3_nrs2": dict(num_beams=3, num_return_sequences=2),
    "greedy_processors": dict(repetition_penalty=1.3, no_repeat_ngram_size=2, min_new_tokens=2),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("family", ["llama", "opt"])
def test_text_lm_texts_identical_to_jax(pairs, family, mode):
    jlm, tlm = pairs[family]
    gen = _gen(jlm, **MODES[mode])
    texts = tlm.generate(PROMPTS, GenerationConfig(**gen))
    assert len(texts) == len(PROMPTS) * gen.get("num_return_sequences", 1)
    assert texts == jlm.generate(PROMPTS, JGenerationConfig(**gen))


def _embeds(jlm, tlm):
    ids, mask = _batch(jlm.tokenizer, PROMPTS)
    jemb = jlm.module.apply(jlm.variables, jnp.asarray(ids), method=type(jlm.module).embed_and_scatter)
    with torch.inference_mode():
        temb = tlm.module.embed_and_scatter(torch.from_numpy(ids))
    return jemb, temb, mask


@pytest.mark.parametrize("family", ["llama", "opt"])
def test_text_lm_beam_tokens_identical_to_jax(pairs, family):
    """Every step runs (no eos): the engine's tokens themselves, not texts."""
    jlm, tlm = pairs[family]
    jemb, temb, mask = _embeds(jlm, tlm)
    gen = dict(_gen(jlm, num_beams=3, length_penalty=0.0), eos_token_id=())
    ref = np.asarray(jdec._beam_search_decoder_only(jlm.module, jlm.variables, jemb, jnp.asarray(mask),
                                                    JGenerationConfig(**gen)))
    with torch.inference_mode():
        ours = tdec._beam_search_decoder_only(tlm.module, temb, torch.from_numpy(mask), GenerationConfig(**gen))
    assert ours.shape == ref.shape == (len(PROMPTS), MAX_NEW)
    np.testing.assert_array_equal(ours.numpy(), ref)


SAMPLED = {
    "sample_t0.7_p0.9_nrs2": dict(do_sample=True, temperature=0.7, top_p=0.9, num_return_sequences=2),
    "beam_sample3": dict(do_sample=True, num_beams=3, temperature=0.7),
}


@pytest.mark.parametrize("mode", list(SAMPLED))
@pytest.mark.parametrize("family", ["llama", "opt"])
def test_text_lm_sampling_identical_to_jax_given_its_noise(pairs, family, mode):
    jlm, tlm = pairs[family]
    jemb, temb, mask = _embeds(jlm, tlm)
    gen = _gen(jlm, **SAMPLED[mode])
    key = jax.random.PRNGKey(2)
    jfn, tfn = ((jdec._beam_search_decoder_only, tdec._beam_search_decoder_only) if gen.get("num_beams", 1) > 1
                else (jdec._greedy_sample_decoder_only, tdec._greedy_sample_decoder_only))
    ref = np.asarray(jfn(jlm.module, jlm.variables, jemb, jnp.asarray(mask), JGenerationConfig(**gen), key))
    with torch.inference_mode():
        ours = tfn(tlm.module, temb, torch.from_numpy(mask), GenerationConfig(**gen), replay(key))
    np.testing.assert_array_equal(ours.numpy(), ref)
    twice = [tlm.generate(PROMPTS, GenerationConfig(**gen), generator=torch.Generator().manual_seed(5))
             for _ in range(2)]
    assert twice[0] == twice[1] and len(twice[0]) == len(PROMPTS) * gen.get("num_return_sequences", 1)
