"""Port vs JAX: sampling, beam_sample and the greedy logits processors
through the slice at tiny_config in fp32, on the greedy slice's inputs and
weights (``tests/test_torch_generate.py``'s fixture).

- Sampling and beam_sample: tokens identical to JAX's
  ``_greedy_sample_decoder_only`` / ``_beam_search_decoder_only`` when the
  port's noise callable replays JAX's key splits (``split(cur_rng)`` a step,
  then ``jax.random.gumbel`` of the sampled scores' shape), with
  ``num_return_sequences`` 2 among them.
- ``generate`` with the same ``torch.Generator`` seed gives the same tokens;
  ``top_k=1`` sampling gives the greedy tokens.
- Greedy ``generate`` with logits processors: tokens identical to
  ``eilev_tpu.generation.generate``.
- A generator on another device than the model's raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu.generation import GenerationConfig as JGenerationConfig
from eilev_tpu.generation import decoding as jdec
from eilev_tpu.generation import generate as jgenerate
from eilev_tpu.models.video_blip import VideoBlipForConditionalGeneration as JVB
from eilev_tpu.ops.preprocess import process_videos as jprocess
from eilev_tpu_torch.generation import GenerationConfig, generate
from eilev_tpu_torch.generation import decoding as tdec
from eilev_tpu_torch.ops.preprocess import process_videos

from .test_torch_generate import MAX_NEW, slice_setup  # noqa: F401  (the greedy slice's fixture)

PAD = 1


def replay(rng):
    """A noise callable drawing what JAX's loops draw from ``rng``: each call
    splits the running key and returns ``jax.random.gumbel`` of the next
    sub-key at the asked shape."""
    state = {"key": rng}

    def noise(like):
        state["key"], sub = jax.random.split(state["key"])
        return torch.from_numpy(np.array(jax.random.gumbel(sub, tuple(like.shape), jnp.float32)))

    return noise


@pytest.fixture(scope="module")
def embeds(slice_setup):  # noqa: F811
    """Each package's own prompt embeddings (frames -> encode -> scatter), the
    mask, and the slice's early eos (row 0's third greedy token)."""
    cfg, jmodel, params, model, frames, ids, mask, vim, t = slice_setup
    img = cfg.vision_config.image_size
    jpixel = jprocess(jnp.asarray(frames), num_frames=t, height=img, width=img)
    jemb = jmodel.apply({"params": params}, jnp.asarray(ids), jpixel, jnp.asarray(vim),
                        method=JVB.embed_and_scatter)
    with torch.inference_mode():
        pixel = process_videos(torch.from_numpy(frames), num_frames=t, height=img, width=img)
        temb = model.embed_and_scatter(torch.from_numpy(ids), pixel, torch.from_numpy(vim))
        probe = tdec._greedy_sample_decoder_only(
            model, temb, torch.from_numpy(mask), GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=(-1,)))
    return jemb, temb, mask, (int(probe[0, 2]),)


SAMPLING = {
    "t0.7_p0.9": dict(temperature=0.7, top_p=0.9),  # the VideoBLIP sample's
    "t0.7_p0.9_nrs2": dict(temperature=0.7, top_p=0.9, num_return_sequences=2),
    "top_k5_processors": dict(top_k=5, repetition_penalty=1.3, no_repeat_ngram_size=2, min_new_tokens=3),
    "typical_eta_t1.5": dict(temperature=1.5, typical_p=0.9, eta_cutoff=1e-3),
}
BEAM_SAMPLE = {
    "beam3_t0.7_p0.9": dict(num_beams=3, temperature=0.7, top_p=0.9),
    "beam3_top_k10_nrs2": dict(num_beams=3, top_k=10, num_return_sequences=2, length_penalty=-1.0),
}


def _both(embeds, knobs):
    jemb, temb, mask, eos = embeds
    gen = dict(knobs, do_sample=True, max_new_tokens=MAX_NEW, pad_token_id=PAD, eos_token_id=eos)
    return jemb, temb, mask, JGenerationConfig(**gen), GenerationConfig(**gen)


@pytest.mark.parametrize("case", list(SAMPLING))
def test_sampling_identical_to_jax_given_its_noise(slice_setup, embeds, case):  # noqa: F811
    jmodel, params, model = slice_setup[1:4]
    jemb, temb, mask, jcfg, tcfg = _both(embeds, SAMPLING[case])
    key = jax.random.PRNGKey(0)
    ref = np.asarray(jdec._greedy_sample_decoder_only(jmodel, {"params": params}, jemb, jnp.asarray(mask), jcfg, key))
    with torch.inference_mode():
        ours = tdec._greedy_sample_decoder_only(model, temb, torch.from_numpy(mask), tcfg, replay(key)).numpy()
    assert ours.shape == ref.shape == (mask.shape[0] * tcfg.num_return_sequences, MAX_NEW)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("case", list(BEAM_SAMPLE))
def test_beam_sample_identical_to_jax_given_its_noise(slice_setup, embeds, case):  # noqa: F811
    jmodel, params, model = slice_setup[1:4]
    jemb, temb, mask, jcfg, tcfg = _both(embeds, BEAM_SAMPLE[case])
    key = jax.random.PRNGKey(1)
    ref = np.asarray(jdec._beam_search_decoder_only(jmodel, {"params": params}, jemb, jnp.asarray(mask), jcfg, key))
    with torch.inference_mode():
        ours = tdec._beam_search_decoder_only(model, temb, torch.from_numpy(mask), tcfg, replay(key)).numpy()
    assert ours.shape == ref.shape and ours.shape[0] == mask.shape[0] * tcfg.num_return_sequences
    np.testing.assert_array_equal(ours, ref)


def _generate(setup, generator=None, **knobs):
    cfg, _, _, model, frames, ids, mask, vim, t = setup
    img = cfg.vision_config.image_size
    return generate(
        model, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
        pixel_values=process_videos(torch.from_numpy(frames), num_frames=t, height=img, width=img),
        video_input_mask=torch.from_numpy(vim), generator=generator,
        generation_config=GenerationConfig(max_new_tokens=MAX_NEW, pad_token_id=PAD, **knobs),
    ).numpy()


@pytest.mark.parametrize("knobs", [dict(do_sample=True, temperature=0.7, top_p=0.9, num_return_sequences=2),
                                   dict(do_sample=True, num_beams=3, temperature=0.7)])
def test_same_generator_seed_same_tokens(slice_setup, embeds, knobs):  # noqa: F811
    runs = [_generate(slice_setup, torch.Generator().manual_seed(seed), eos_token_id=embeds[3], **knobs)
            for seed in (7, 7)]
    np.testing.assert_array_equal(runs[0], runs[1])
    # no generator: one seeded with 0
    np.testing.assert_array_equal(
        _generate(slice_setup, eos_token_id=embeds[3], **knobs),
        _generate(slice_setup, torch.Generator().manual_seed(0), eos_token_id=embeds[3], **knobs))


def test_top_k_1_sampling_is_greedy(slice_setup, embeds):  # noqa: F811
    greedy = _generate(slice_setup, eos_token_id=embeds[3])
    sampled = _generate(slice_setup, torch.Generator().manual_seed(3), eos_token_id=embeds[3], do_sample=True,
                        top_k=1, temperature=0.7)
    np.testing.assert_array_equal(sampled, greedy)


GREEDY_PROCESSORS = {
    "repetition_penalty": dict(repetition_penalty=1.3),
    "no_repeat_ngram_size": dict(no_repeat_ngram_size=2),
    "min_new_tokens": dict(min_new_tokens=4),
    "bad_words_suppress_sequence_bias": dict(bad_words_ids=((13,), (61, 61)), suppress_tokens=(7,),
                                             sequence_bias=(((27,), -2.0),), begin_suppress_tokens=(61,)),
    "forced_eos_decay_renormalize": dict(forced_eos_token_id=(5,), exponential_decay_length_penalty=(2, 1.3),
                                         renormalize_logits=True),
}


@pytest.mark.parametrize("case", list(GREEDY_PROCESSORS))
def test_greedy_processors_identical_to_jax(slice_setup, embeds, case):  # noqa: F811
    cfg, jmodel, params, _, frames, ids, mask, vim, t = slice_setup
    img = cfg.vision_config.image_size
    gen = dict(GREEDY_PROCESSORS[case], max_new_tokens=MAX_NEW, pad_token_id=PAD, eos_token_id=embeds[3])
    ref = np.asarray(jgenerate(
        jmodel, {"params": params}, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        pixel_values=jprocess(jnp.asarray(frames), num_frames=t, height=img, width=img),
        video_input_mask=jnp.asarray(vim), generation_config=JGenerationConfig(**gen),
    ))
    ours = _generate(slice_setup, **{k: v for k, v in gen.items() if k not in ("max_new_tokens", "pad_token_id")})
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("device", ["cuda", "cuda:1"])
def test_generator_on_another_device_raises(device):
    """The noise is drawn on the generator's device: a host generator for a
    model on the card would draw every step on the host and copy it over."""
    with pytest.raises(ValueError, match="model's device"):
        tdec._seeded_noise(torch.Generator().manual_seed(0), torch.device(device))
    noise = tdec._seeded_noise(torch.Generator().manual_seed(0), torch.device("cpu"))
    assert torch.isfinite(noise(torch.zeros(2, 5))).all()
