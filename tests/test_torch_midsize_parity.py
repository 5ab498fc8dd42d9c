"""Port vs JAX at mid size: greedy narration at the flagship prompt geometry.

The counterpart of tests/integration/test_full_geometry_parity.py, held
against ``eilev_tpu.generation.generate`` instead of the HF reference: the
same MID-SIZE model (6 layers, 1024 hidden, 16 heads, the real 50,272 OPT
vocabulary, 32 query tokens, 224^2 frames in 14^2 patches, 2,048 OPT
positions) at the geometry the published numbers were produced at (16
in-context examples + the query = 17 videos x 8 frames, the 766-token
interleaved prompt the JAX file takes from bench.py, built here, 32 new tokens), on one numpy weight tree (N(0, 0.05),
LayerNorm scales 1 + N(0, 0.1)) loaded into both packages. At N(0, 0.02)
every step emits the same token, which a wrong step would too; at 0.05 the
fp32 greedy run emits 19 distinct tokens, its smallest top-2 gap 6e-3.

- fp32: greedy tokens identical, and beam-5 (length_penalty -1) tokens
  identical, as the JAX file checks both;
- bf16 (a bf16 compute over the fp32 weights in both packages): greedy
  tokens identical, or parting at a near-tie of the port's logits (top-2
  gap within NEAR_TIE of the step's largest |logit|, the card's rule).

Marked slow, as the JAX file is: tier-1 does not run it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu import configs
from eilev_tpu_torch import configs as tconfigs

from ._torch_port import random_params

pytestmark = pytest.mark.slow

NEW_TOKENS = 32
SHOTS, FRAMES, TEXT_TOKENS_PER_SHOT = 16, 8, 12
NEAR_TIE = 2e-2
GEOMETRY = dict(text_model="opt", hidden=1024, heads=16, layers=6, image_size=224, patch_size=14, vocab_size=50272,
                num_query_tokens=32)


def _midsize(mod):
    cfg = mod.tiny_config(**GEOMETRY)
    # OPT's real position budget: the 766-token prompt + 32 new tokens
    return dataclasses.replace(cfg, text_config=dataclasses.replace(cfg.text_config, max_position_embeddings=2048))


def _prompt(q: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The interleaved 16-shot layout, one row: bos, then for each of the 17
    videos q query slots (pad 1), a newline (50118) and 12 text tokens."""
    rng = np.random.default_rng(0)
    ids, vim = [2], [0]
    for _ in range(SHOTS + 1):
        toks = rng.integers(1000, 40000, size=TEXT_TOKENS_PER_SHOT).tolist()
        ids += [1] * q + [50118] + toks
        vim += [1] * q + [0] * (1 + len(toks))
    ids, vim = np.asarray([ids]), np.asarray([vim])
    return ids, np.ones_like(ids), vim


@pytest.fixture(scope="module")
def midsize():
    from eilev_tpu.models.video_blip import VideoBlipForConditionalGeneration as JVB

    cfg = _midsize(configs)
    ids, mask, vim = _prompt(cfg.num_query_tokens)
    assert ids.shape == (1, 766), ids.shape
    pixel = np.random.default_rng(0).normal(size=(SHOTS + 1, 3, FRAMES, 224, 224)).astype(np.float32) * 0.5
    params = random_params(JVB(cfg), 0, input_ids=jnp.asarray(ids), pixel_values=jnp.asarray(pixel[:1]),
                           video_input_mask=jnp.asarray(vim), std=0.05)
    return cfg, jax.tree.map(np.asarray, params), ids, mask, vim, pixel


def _knobs(mode: str) -> dict:
    return dict(num_beams=5, length_penalty=-1.0) if mode == "beam5" else {}


def _jax_tokens(midsize, dtype, mode="greedy") -> np.ndarray:
    from eilev_tpu.generation import GenerationConfig, generate
    from eilev_tpu.models.video_blip import VideoBlipForConditionalGeneration as JVB

    cfg, params, ids, mask, vim, pixel = midsize
    return np.asarray(generate(
        JVB(cfg, dtype=dtype), {"params": params}, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        pixel_values=jnp.asarray(pixel, dtype), video_input_mask=jnp.asarray(vim),
        generation_config=GenerationConfig(max_new_tokens=NEW_TOKENS, pad_token_id=cfg.text_config.pad_token_id,
                                           **_knobs(mode))))


def _port_tokens(midsize, dtype, mode="greedy") -> tuple[np.ndarray, list]:
    """The port's tokens and the last-position logits of each LM forward
    (greedy: entry t chose token t)."""
    from eilev_tpu_torch.generation import GenerationConfig, generate
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration, params_from_jax

    cfg, params, ids, mask, vim, pixel = midsize
    tcfg = _midsize(tconfigs)
    kw = {} if dtype == torch.float32 else {"dtype": dtype, "param_dtype": torch.float32}
    model = VideoBlipForConditionalGeneration(tcfg, device="cpu", **kw)
    model.load_state_dict(params_from_jax(params, tcfg), strict=True)
    model.eval()
    rec: list = []
    model.language_model.register_forward_hook(lambda mod, args, out: rec.append(out[0][0, -1].float()))
    tokens = generate(model, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                      pixel_values=torch.from_numpy(pixel).to(dtype), video_input_mask=torch.from_numpy(vim),
                      generation_config=GenerationConfig(max_new_tokens=NEW_TOKENS,
                                                         pad_token_id=tcfg.text_config.pad_token_id, **_knobs(mode)))
    return tokens.numpy(), rec


@pytest.mark.parametrize("mode", ["greedy", "beam5"])
def test_fp32_tokens_identical_at_flagship_geometry(midsize, mode):
    ref = _jax_tokens(midsize, jnp.float32, mode)
    ours, _ = _port_tokens(midsize, torch.float32, mode)
    print(f"fp32 {mode}: JAX {ref.tolist()} port {ours.tolist()}")
    assert ref.shape[0] == 1 and ref.shape[1] <= NEW_TOKENS, ref.shape
    np.testing.assert_array_equal(ours, ref)


def test_bf16_greedy_tokens_identical_or_near_tie_at_flagship_geometry(midsize):
    ref = _jax_tokens(midsize, jnp.bfloat16)
    ours, rec = _port_tokens(midsize, torch.bfloat16)
    n = min(ours.shape[1], ref.shape[1])
    apart = np.nonzero(ours[0, :n] != ref[0, :n])[0]
    print(f"bf16 greedy: JAX {ref.tolist()} port {ours.tolist()} parting at {apart[:1].tolist()}")
    if len(apart):
        t = int(apart[0])
        top2 = rec[t].topk(2).values
        gap, scale = (top2[0] - top2[1]).item(), rec[t].abs().max().item()
        assert gap <= NEAR_TIE * scale, f"the port leaves JAX's greedy at {t} with a top-2 gap of {gap} ({scale})"
    else:
        assert ours.shape == ref.shape, (ours.shape, ref.shape)
