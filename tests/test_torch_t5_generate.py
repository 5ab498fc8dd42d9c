"""Port vs JAX: the VideoBLIP-T5 slice at tiny_config(text_model="t5"), fp32.

uint8 frames -> process_videos -> encode_videos -> scatter into T5's
``shared`` embeddings -> the T5 encoder -> init_decode_cache (the cross K/V
projected once) -> the seq2seq loops. Tokens must be identical to
``eilev_tpu.generation.generate`` (greedy, the greedy logits processors,
beam, group beam; the outputs start with the decoder start token) and, with
the port's noise replaying JAX's key splits, to JAX's sampling (with
``num_return_sequences``) and beam_sample loops; greedy and beam under both
"xla" and "flash" (K5's twin, the bias form), set in both packages and
restored. The seq2seq classify agrees to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu import configs
from eilev_tpu.generation import GenerationConfig as JGenerationConfig
from eilev_tpu.generation import classify as jclassify
from eilev_tpu.generation import decoding as jdec
from eilev_tpu.generation import generate as jgenerate
from eilev_tpu.models.video_blip import VideoBlipForConditionalGeneration as JVB
from eilev_tpu.ops import attention as jattn
from eilev_tpu.ops.preprocess import process_videos as jprocess
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.generation import GenerationConfig, classify, generate, generate_stream
from eilev_tpu_torch.generation import decoding as tdec
from eilev_tpu_torch.models import VideoBlipForConditionalGeneration, params_from_jax
from eilev_tpu_torch.ops import attention as tattn
from eilev_tpu_torch.ops.preprocess import process_videos

from ._torch_port import random_params, to_np
from .test_torch_sampling import replay

MAX_NEW = 6
PAD = 0  # T5's pad (and decoder start) token


@pytest.fixture(scope="module")
def t5_setup():
    """Both packages' VideoBLIP-T5 on the same numpy weights, 2 datapoints x
    2 videos, row 1 left-padded, and the slice's early eos (row 0's second
    greedy token)."""
    cfg = configs.tiny_config(text_model="t5")
    img = cfg.vision_config.image_size
    rng = np.random.default_rng(21)
    b, v_per, t, s = 2, 2, 2, 14
    frames = rng.integers(0, 256, size=(b * v_per, 3, 5, 20, 20), dtype=np.uint8)
    ids = rng.integers(4, cfg.text_config.vocab_size, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    ids[1, :2], mask[1, :2] = PAD, 0
    vim = np.zeros((b, s), np.int32)
    vim[:, 2 : 2 + v_per * cfg.num_query_tokens] = 1
    jmodel = JVB(cfg)
    params = random_params(jmodel, 22, input_ids=jnp.asarray(ids), pixel_values=jnp.zeros((b * v_per, 3, t, img, img)),
                           video_input_mask=jnp.asarray(vim), decoder_input_ids=jnp.zeros((b, 1), jnp.int32))
    tcfg = tconfigs.tiny_config(text_model="t5")
    model = VideoBlipForConditionalGeneration(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tcfg), strict=True)
    jpixel = jprocess(jnp.asarray(frames), num_frames=t, height=img, width=img)
    pixel = process_videos(torch.from_numpy(frames), num_frames=t, height=img, width=img)
    st = dict(cfg=cfg, jmodel=jmodel, params=params, model=model.eval(), ids=ids, mask=mask, vim=vim,
              jpixel=jpixel, pixel=pixel)
    probe = _port(st, GenerationConfig(max_new_tokens=MAX_NEW, pad_token_id=PAD, eos_token_id=(-1,)))
    st["eos"] = (int(probe[0, 2]),)
    return st


@pytest.fixture(params=["xla", "flash"])
def impl(request):
    jattn.set_default_attention_impl(request.param)
    tattn.set_default_attention_impl(request.param)
    yield request.param
    jattn.set_default_attention_impl("auto")
    tattn.set_default_attention_impl("auto")


def _jax(st, gen_cfg, **kw):
    return np.asarray(jgenerate(
        st["jmodel"], {"params": st["params"]}, input_ids=jnp.asarray(st["ids"]),
        attention_mask=jnp.asarray(st["mask"]), pixel_values=st["jpixel"],
        video_input_mask=jnp.asarray(st["vim"]), generation_config=gen_cfg, **kw))


def _port(st, gen_cfg, **kw):
    return generate(
        st["model"], input_ids=torch.from_numpy(st["ids"]), attention_mask=torch.from_numpy(st["mask"]),
        pixel_values=st["pixel"], video_input_mask=torch.from_numpy(st["vim"]), generation_config=gen_cfg,
        **kw).numpy()


def _both(st, **knobs):
    gen = dict(knobs, max_new_tokens=MAX_NEW, pad_token_id=PAD)
    gen.setdefault("eos_token_id", st["eos"])
    return _jax(st, JGenerationConfig(**gen)), _port(st, GenerationConfig(**gen))


def test_greedy_tokens_identical_with_early_eos(t5_setup, impl):
    ref, ours = _both(t5_setup)
    assert ours.shape == ref.shape == (2, 1 + MAX_NEW)
    np.testing.assert_array_equal(ours, ref)
    assert (ours[:, 0] == t5_setup["cfg"].text_config.decoder_start_token_id).all()
    first = int(np.where(ours[0] == t5_setup["eos"][0])[0][0])
    assert first <= 3 and (ours[0, first + 1 :] == PAD).all()


BEAM = {
    "beam3": dict(num_beams=3),
    "beam3_nrs2_lp-1": dict(num_beams=3, num_return_sequences=2, length_penalty=-1.0),
    "group_beam_4_2_div0.5": dict(num_beams=4, num_beam_groups=2, diversity_penalty=0.5),
    "beam2_repetition": dict(num_beams=2, repetition_penalty=1.5, no_repeat_ngram_size=2),
}


@pytest.mark.parametrize("case", list(BEAM))
def test_beam_tokens_identical_to_jax(t5_setup, case):
    ref, ours = _both(t5_setup, **BEAM[case])
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def test_beam_under_flash_identical_to_jax(t5_setup, impl):
    ref, ours = _both(t5_setup, num_beams=3, num_return_sequences=3)
    np.testing.assert_array_equal(ours, ref)


GREEDY_PROCESSORS = {
    # the processors see [start] + generated, as HF's seq2seq input_ids
    "repetition_no_repeat": dict(repetition_penalty=1.3, no_repeat_ngram_size=2),
    "min_new_tokens_forced_bos": dict(min_new_tokens=3, forced_bos_token_id=5),
    "max_min_length": dict(max_length=5, min_length=3),  # decoder tokens, start included
}


@pytest.mark.parametrize("case", list(GREEDY_PROCESSORS))
def test_greedy_processors_identical_to_jax(t5_setup, case):
    knobs = dict(GREEDY_PROCESSORS[case])
    gen = dict(knobs, pad_token_id=PAD, eos_token_id=t5_setup["eos"])
    if "max_length" not in knobs:
        gen["max_new_tokens"] = MAX_NEW
    ref = _jax(t5_setup, JGenerationConfig(**gen))
    ours = _port(t5_setup, GenerationConfig(**gen))
    np.testing.assert_array_equal(ours, ref)


@pytest.fixture(scope="module")
def embeds(t5_setup):
    st = t5_setup
    jemb = st["jmodel"].apply({"params": st["params"]}, jnp.asarray(st["ids"]), st["jpixel"],
                              jnp.asarray(st["vim"]), method=JVB.embed_and_scatter)
    with torch.inference_mode():
        temb = st["model"].embed_and_scatter(torch.from_numpy(st["ids"]), st["pixel"], torch.from_numpy(st["vim"]))
    return jemb, temb


SAMPLING = {
    "t0.7_p0.9": dict(do_sample=True, temperature=0.7, top_p=0.9),
    "t0.7_p0.9_nrs2": dict(do_sample=True, temperature=0.7, top_p=0.9, num_return_sequences=2),
    "top_k5_processors": dict(do_sample=True, top_k=5, repetition_penalty=1.3, min_new_tokens=2),
}


@pytest.mark.parametrize("case", list(SAMPLING))
def test_sampling_identical_to_jax_given_its_noise(t5_setup, embeds, case):
    st = t5_setup
    jemb, temb = embeds
    gen = dict(SAMPLING[case], max_new_tokens=MAX_NEW, pad_token_id=PAD, eos_token_id=st["eos"])
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jdec._greedy_sample_seq2seq(st["jmodel"], {"params": st["params"]}, jemb,
                                                 jnp.asarray(st["mask"]), JGenerationConfig(**gen), key))
    with torch.inference_mode():
        ours = tdec._greedy_sample_seq2seq(st["model"], temb, torch.from_numpy(st["mask"]),
                                           GenerationConfig(**gen), replay(key)).numpy()
    assert ours.shape == ref.shape == (2 * gen.get("num_return_sequences", 1), 1 + MAX_NEW)
    np.testing.assert_array_equal(ours, ref)


def test_beam_sample_identical_to_jax_given_its_noise(t5_setup, embeds):
    st = t5_setup
    jemb, temb = embeds
    gen = dict(do_sample=True, num_beams=3, temperature=0.7, num_return_sequences=2, max_new_tokens=MAX_NEW,
               pad_token_id=PAD, eos_token_id=st["eos"])
    key = jax.random.PRNGKey(4)
    ref = np.asarray(jdec._beam_search_seq2seq(st["jmodel"], {"params": st["params"]}, jemb,
                                               jnp.asarray(st["mask"]), JGenerationConfig(**gen), key))
    with torch.inference_mode():
        ours = tdec._beam_search_seq2seq(st["model"], temb, torch.from_numpy(st["mask"]),
                                         GenerationConfig(**gen), replay(key)).numpy()
    np.testing.assert_array_equal(ours, ref)


def test_same_generator_seed_same_tokens(t5_setup):
    gen = GenerationConfig(do_sample=True, temperature=0.7, num_return_sequences=2, max_new_tokens=MAX_NEW,
                           pad_token_id=PAD)
    runs = [_port(t5_setup, gen, generator=torch.Generator().manual_seed(seed)) for seed in (9, 9)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert runs[0].shape == (4, 1 + MAX_NEW)


def test_decoder_only_modes_refuse_t5(t5_setup):
    """As in JAX: contrastive search is decoder-only; streaming too."""
    with pytest.raises(NotImplementedError, match="penalty_alpha"):
        _port(t5_setup, GenerationConfig(penalty_alpha=0.6, top_k=4, max_new_tokens=MAX_NEW, pad_token_id=PAD))
    with pytest.raises(NotImplementedError, match="T5Config"):
        next(generate_stream(t5_setup["model"], input_ids=torch.from_numpy(t5_setup["ids"])))


@pytest.mark.parametrize("class_batch_size", [None, 2])
def test_seq2seq_classify_matches_jax(t5_setup, impl, class_batch_size):
    """One encoder pass; the (C, L) class labels, right-padded, scored over
    the shared encoder states: (B, C) mean log-likelihoods within 1e-4."""
    st = t5_setup
    rng = np.random.default_rng(23)
    cls_ids = rng.integers(2, st["cfg"].text_config.vocab_size, size=(5, 3)).astype(np.int32)
    cls_mask = np.ones((5, 3), np.int32)
    cls_mask[1, 2:] = cls_mask[3, 1:] = 0
    cls_ids[cls_mask == 0] = PAD
    common = dict(prompt_input_ids=st["ids"], prompt_attention_mask=st["mask"],
                  prompt_video_input_mask=st["vim"], class_input_ids=cls_ids, class_attention_mask=cls_mask,
                  class_batch_size=class_batch_size)
    ref = jclassify(st["jmodel"], {"params": st["params"]}, pixel_values=st["jpixel"],
                    **{k: v if v is None or isinstance(v, int) else jnp.asarray(v) for k, v in common.items()})
    ours = classify(st["model"], pixel_values=st["pixel"],
                    **{k: v if v is None or isinstance(v, int) else torch.from_numpy(v) for k, v in common.items()})
    assert ours.shape == (2, 5)
    np.testing.assert_allclose(to_np(ours), np.asarray(ref), atol=1e-4, rtol=0)

