"""Port vs JAX: beam search through the whole slice at tiny_config in fp32.

uint8 frames -> process_videos -> encode -> scatter -> OPT prefill (K2's
twin) -> the beam engine over the tiled, reordered cache (K3's twin, or
K4's over the int8 cache). Tokens identical to
``eilev_tpu.generation.generate`` on the greedy slice's inputs and weights
(``tests/test_torch_generate.py``'s fixture) for plain beam (2, 3 and 5
beams; length_penalty 1, -1 and 0; early_stopping on and off),
``num_return_sequences``, group beam search, beam with the repetition and
n-gram processors, and beam over the int8 KV cache with int8 matmuls. The
eos is a token the best 3-beam hypothesis of row 0 holds early, so
hypotheses finish on the way and rows stop at different lengths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu import configs
from eilev_tpu.generation import GenerationConfig as JGenerationConfig
from eilev_tpu.generation import generate as jgenerate
from eilev_tpu.models.video_blip import VideoBlipForConditionalGeneration as JVB
from eilev_tpu.ops import quantization as jq
from eilev_tpu.ops.preprocess import process_videos as jprocess
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.generation import GenerationConfig, generate
from eilev_tpu_torch.models import VideoBlipForConditionalGeneration, params_from_jax
from eilev_tpu_torch.ops.preprocess import process_videos

from .test_torch_generate import MAX_NEW, slice_setup  # noqa: F401  (the greedy slice's fixture)

PAD = 1


def _jax_beam(setup, jmodel=None, params=None, **gen):
    cfg, jm, jp, _, frames, ids, mask, vim, t = setup
    img = cfg.vision_config.image_size
    return np.asarray(jgenerate(
        jmodel or jm, {"params": params or jp},
        input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        pixel_values=jprocess(jnp.asarray(frames), num_frames=t, height=img, width=img),
        video_input_mask=jnp.asarray(vim),
        generation_config=JGenerationConfig(max_new_tokens=MAX_NEW, pad_token_id=PAD, **gen),
    ))


def _port_beam(setup, model=None, **gen):
    cfg, _, _, m, frames, ids, mask, vim, t = setup
    img = cfg.vision_config.image_size
    return generate(
        model or m, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
        pixel_values=process_videos(torch.from_numpy(frames), num_frames=t, height=img, width=img),
        video_input_mask=torch.from_numpy(vim),
        generation_config=GenerationConfig(max_new_tokens=MAX_NEW, pad_token_id=PAD, **gen),
    ).numpy()


@pytest.fixture(scope="module")
def eos(slice_setup):  # noqa: F811
    """Row 0's third token of its best 3-beam hypothesis when no token ends
    one, as the greedy slice test takes its early eos."""
    probe = _port_beam(slice_setup, num_beams=3, eos_token_id=(-1,))
    return (int(probe[0, 2]),)


CASES = {
    "beam2_lp1": dict(num_beams=2, length_penalty=1.0, early_stopping=False),
    "beam3_lp-1_early_stopping": dict(num_beams=3, length_penalty=-1.0, early_stopping=True),
    "beam3_lp0": dict(num_beams=3, length_penalty=0.0, early_stopping=False),
    "beam5_lp-1": dict(num_beams=5, length_penalty=-1.0),  # the flagship sample's settings
    "beam2_lp0_early_stopping": dict(num_beams=2, length_penalty=0.0, early_stopping=True),
    "num_return_sequences_2": dict(num_beams=3, num_return_sequences=2),
    # every hypothesis returned, so the diversity penalty shows in the tokens
    "group_beam_4_2_div0.5": dict(num_beams=4, num_beam_groups=2, diversity_penalty=0.5, num_return_sequences=4),
    "beam3_repetition_ngram": dict(num_beams=3, repetition_penalty=1.3, no_repeat_ngram_size=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_beam_tokens_identical_to_jax(slice_setup, eos, case):  # noqa: F811
    gen = dict(CASES[case], eos_token_id=eos)
    ref = _jax_beam(slice_setup, **gen)
    ours = _port_beam(slice_setup, **gen)
    rows = slice_setup[5].shape[0] * gen.get("num_return_sequences", 1)
    assert ours.shape[0] == rows and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def test_beam_row_stops_early_on_eos(slice_setup, eos):  # noqa: F811
    """Beam 3, length_penalty 0: the rows' best hypotheses end on eos at
    different steps, the shorter padded after its eos, as JAX returns them."""
    gen = dict(num_beams=3, length_penalty=0.0, eos_token_id=eos)
    ours = _port_beam(slice_setup, **gen)
    np.testing.assert_array_equal(ours, _jax_beam(slice_setup, **gen))
    ends = [int(np.nonzero(row == eos[0])[0][0]) if (row == eos[0]).any() else None for row in ours]
    short = [i for i, e in enumerate(ends) if e is not None and e < ours.shape[1] - 1]
    assert short, f"no row ended on eos early: {ours}"
    assert all((ours[i, ends[i] + 1 :] == PAD).all() for i in short)


def test_beam_over_int8_cache_identical_to_jax(slice_setup):  # noqa: F811
    """Beam 3 with quantize_matmuls + int8_kv_cache: the cache's int8 values
    and bf16 scales are reordered with it; tokens identical to JAX's on the
    same quantized tree."""
    params = jax.tree.map(np.asarray, slice_setup[2])
    params = dict(params, language_model=jq.quantize_lm_params(params["language_model"]))

    def int8(mod):
        cfg = mod.tiny_config()
        text = dataclasses.replace(cfg.text_config, quantize_matmuls=True, int8_kv_cache=True)
        return mod.replace(cfg, text_config=text)

    tcfg = int8(tconfigs)
    ours_model = VideoBlipForConditionalGeneration(tcfg, device="cpu")
    ours_model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tcfg), strict=True)
    # no eos: every step reorders the cache; every hypothesis returned
    gen = dict(num_beams=3, num_return_sequences=3, eos_token_id=())
    ref = _jax_beam(slice_setup, jmodel=JVB(int8(configs)), params=params, **gen)
    ours = _port_beam(slice_setup, model=ours_model.eval(), **gen)
    np.testing.assert_array_equal(ours, ref)
