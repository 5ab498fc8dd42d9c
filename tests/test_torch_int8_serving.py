"""Port vs JAX: the int8 serving modes of greedy narration at tiny_config, fp32.

The same float tree is quantized with the JAX functions and loaded into both
packages. On the CPU both sides take the dequant + plain route for the int8
KV cache (the port through the decode kernel's plain twin), so:

- greedy tokens are identical to ``eilev_tpu.generation.generate``, with
  ``quantize_matmuls + int8_kv_cache``, with ``w8a8_prefill`` added (the
  2 x 40 prompt crosses the 64-row W8A8 dispatch), and with every serving
  mode on (W8A8 vision and Q-Former, fast gelu);
- the logits of the prefill and of each decode step agree to atol 1e-4, and
  the int8 cache buffers (values and bf16 scales) equal JAX's after prefill;
- the W8A8 vision tower and Q-Former agree with the flax modules to atol 1e-4;
- fast gelu agrees with ``eilev_tpu.ops.gelu`` in fast mode to atol 1e-6.

The global gelu mode is reset in a ``finally`` wherever a test sets it.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu import configs
from eilev_tpu.generation import GenerationConfig as JGenerationConfig
from eilev_tpu.generation import generate as jgenerate
from eilev_tpu.models import opt as jopt
from eilev_tpu.models.qformer import QFormerModel as JQFormer
from eilev_tpu.models.video_blip import VideoBlipForConditionalGeneration as JVB
from eilev_tpu.models.vision import VideoVisionModel as JVideoVision
from eilev_tpu.ops import gelu as jgelu
from eilev_tpu.ops import quantization as jq
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.generation import GenerationConfig, generate
from eilev_tpu_torch.models import VideoBlipForConditionalGeneration, init_cache, params_from_jax
from eilev_tpu_torch.models.qformer import QFormerModel
from eilev_tpu_torch.models.vision import VideoVisionModel
from eilev_tpu_torch.ops import gelu as tgelu

from ._torch_port import load_port, random_params, to_np

ATOL = 1e-4
MAX_NEW = 6
MODES = {
    "int8_lm_kv": dict(int8_lm=True, int8_kv=True),
    "w8a8_prefill": dict(int8_lm=True, int8_kv=True, w8a8_prefill=True),
    "all": dict(int8_lm=True, int8_kv=True, w8a8_prefill=True, int8_vision=True,
                int8_qformer=True, fast_gelu=True),
}


@contextlib.contextmanager
def gelu_mode(impl):
    """Set both packages' gelu switch for the block, and set it back."""
    jgelu.set_gelu_impl(impl)
    tgelu.set_gelu_impl(impl)
    try:
        yield
    finally:
        jgelu.set_gelu_impl("exact")
        tgelu.set_gelu_impl("exact")


def _configs(mod, modes):
    """The tiny config of ``mod`` (either package's configs) in ``modes``."""
    cfg = mod.tiny_config()
    text = dataclasses.replace(
        cfg.text_config, quantize_matmuls=modes.get("int8_lm", False),
        int8_kv_cache=modes.get("int8_kv", False), w8a8_prefill=modes.get("w8a8_prefill", False),
    )
    vision = dataclasses.replace(cfg.vision_config, quantize_matmuls=modes.get("int8_vision", False))
    qformer = dataclasses.replace(cfg.qformer_config, quantize_matmuls=modes.get("int8_qformer", False))
    return mod.replace(cfg, text_config=text, vision_config=vision, qformer_config=qformer)


@pytest.fixture(scope="module")
def float_setup():
    cfg = configs.tiny_config()
    img = cfg.vision_config.image_size
    rng = np.random.default_rng(21)
    b, v_per, t, s = 2, 2, 2, 40  # 80 prompt rows: above the 64-row W8A8 dispatch
    pixel = rng.normal(size=(b * v_per, 3, t, img, img)).astype(np.float32)
    ids = rng.integers(4, cfg.text_config.vocab_size, size=(b, s)).astype(np.int32)
    ids[:, 0] = 2
    mask = np.ones((b, s), np.int32)
    ids[1, :3], mask[1, :3] = 1, 0  # left padding
    vim = np.zeros((b, s), np.int32)
    vim[:, 4 : 4 + v_per * cfg.num_query_tokens] = 1
    params = random_params(
        JVB(cfg), 22, input_ids=jnp.asarray(ids), pixel_values=jnp.asarray(pixel),
        video_input_mask=jnp.asarray(vim),
    )
    return jax.tree.map(np.asarray, params), pixel, ids, mask, vim


def _pair(float_setup, modes):
    """(JAX model, JAX params, port model) on the same quantized tree."""
    params = dict(float_setup[0])
    if modes.get("int8_lm"):
        params["language_model"] = jq.quantize_lm_params(params["language_model"])
    if modes.get("int8_vision"):
        params["vision_model"] = jq.quantize_vision_params(params["vision_model"])
    if modes.get("int8_qformer"):
        params["qformer"] = jq.quantize_qformer_params(params["qformer"])
    params = jax.tree.map(np.asarray, params)
    tcfg = _configs(tconfigs, modes)
    ours = VideoBlipForConditionalGeneration(tcfg, device="cpu")
    ours.load_state_dict(params_from_jax(params, tcfg), strict=True)
    return JVB(_configs(configs, modes)), params, ours.eval()


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_tokens_identical_to_jax(float_setup, mode):
    modes = MODES[mode]
    jmodel, params, ours = _pair(float_setup, modes)
    _, pixel, ids, mask, vim = float_setup
    with gelu_mode("fast" if modes.get("fast_gelu") else "exact"):
        ref = np.asarray(jgenerate(
            jmodel, {"params": params}, input_ids=jnp.asarray(ids),
            attention_mask=jnp.asarray(mask), pixel_values=jnp.asarray(pixel),
            video_input_mask=jnp.asarray(vim),
            generation_config=JGenerationConfig(max_new_tokens=MAX_NEW, pad_token_id=1, eos_token_id=(-1,)),
        ))
        got = generate(
            ours, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
            pixel_values=torch.from_numpy(pixel), video_input_mask=torch.from_numpy(vim),
            generation_config=GenerationConfig(max_new_tokens=MAX_NEW, pad_token_id=1, eos_token_id=(-1,)),
        ).numpy()
    assert got.shape == ref.shape == (ids.shape[0], MAX_NEW)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", ["int8_lm_kv", "w8a8_prefill"])
def test_step_logits_and_int8_cache_match_jax(float_setup, mode):
    jmodel, params, ours = _pair(float_setup, MODES[mode])
    _, pixel, ids, mask, vim = float_setup
    embeds = np.array(jmodel.apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(pixel), jnp.asarray(vim),
        method=JVB.embed_and_scatter,
    ))
    b, s, dim = embeds.shape
    tcfg, jcfg = ours.config.text_config, jmodel.config.text_config
    jcache = jopt.init_cache(jcfg, b, s + 3)
    tcache = init_cache(tcfg, b, s + 3)
    rng = np.random.default_rng(23)
    steps = [(embeds, mask)] + [
        (rng.normal(size=(b, 1, dim)).astype(np.float32), np.ones((b, 1), np.int32)) for _ in range(3)
    ]
    for i, (x, m) in enumerate(steps):
        ref, jcache = jmodel.apply(
            {"params": params}, jnp.asarray(x), attention_mask=jnp.asarray(m), cache=jcache,
            method=JVB.lm_forward,
        )
        with torch.no_grad():
            got, tcache = ours.lm_forward(torch.from_numpy(x), attention_mask=torch.from_numpy(m), cache=tcache)
        np.testing.assert_allclose(to_np(got), to_np(ref), atol=ATOL, rtol=0)
        if i == 0:  # after prefill: the int8 values and bf16 scales are JAX's
            for key in ("k", "v"):
                assert tcache[key].dtype == torch.int8
                np.testing.assert_array_equal(tcache[key].numpy(), np.asarray(jcache[key]))
                scales = tcache[f"{key}_scale"]
                assert scales.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    scales.float().numpy(), np.asarray(jcache[f"{key}_scale"], np.float32)
                )
    assert tcache["index"] == int(jcache["index"]) == s + 3


@pytest.mark.parametrize("fast_gelu", [False, True])
def test_w8a8_vision_matches_jax(fast_gelu):
    vcfg = dataclasses.replace(configs.tiny_config(heads=4).vision_config, quantize_matmuls=True)
    pixel = np.random.default_rng(24).normal(size=(3, 3, 2, 16, 16)).astype(np.float32)
    float_cfg = dataclasses.replace(vcfg, quantize_matmuls=False)
    params = jq.quantize_vision_params(random_params(JVideoVision(float_cfg), 25, jnp.asarray(pixel)))
    tcfg = dataclasses.replace(tconfigs.tiny_config(heads=4).vision_config, quantize_matmuls=True)
    ours = load_port(VideoVisionModel(tcfg), jax.tree.map(np.asarray, params))
    with gelu_mode("fast" if fast_gelu else "exact"):
        ref_hidden, ref_pooled = JVideoVision(vcfg).apply({"params": params}, jnp.asarray(pixel))
        with torch.no_grad():
            hidden, pooled = ours(torch.from_numpy(pixel))
    np.testing.assert_allclose(to_np(hidden), to_np(ref_hidden), atol=ATOL, rtol=0)
    np.testing.assert_allclose(to_np(pooled), to_np(ref_pooled), atol=ATOL, rtol=0)


def test_w8a8_qformer_matches_jax():
    qcfg = dataclasses.replace(
        configs.tiny_config(layers=3).qformer_config, cross_attention_frequency=2,
        encoder_hidden_size=24, quantize_matmuls=True,
    )
    rng = np.random.default_rng(26)
    query = rng.normal(size=(2, 4, qcfg.hidden_size)).astype(np.float32)
    enc = rng.normal(size=(2, 10, 24)).astype(np.float32)
    enc_mask = np.ones((2, 10), np.int32)
    enc_mask[1, 6:] = 0
    float_cfg = dataclasses.replace(qcfg, quantize_matmuls=False)
    params = jq.quantize_qformer_params(
        random_params(JQFormer(float_cfg), 27, jnp.asarray(query), jnp.asarray(enc))
    )
    ref = JQFormer(qcfg).apply(
        {"params": params}, jnp.asarray(query), jnp.asarray(enc), jnp.asarray(enc_mask)
    )
    tcfg = dataclasses.replace(
        tconfigs.tiny_config(layers=3).qformer_config, cross_attention_frequency=2,
        encoder_hidden_size=24, quantize_matmuls=True,
    )
    ours = load_port(QFormerModel(tcfg), jax.tree.map(np.asarray, params))
    # the Q-Former's gelu is exact erf in both packages, whatever the switch says
    with gelu_mode("fast"), torch.no_grad():
        out = ours(torch.from_numpy(query), torch.from_numpy(enc), torch.from_numpy(enc_mask))
    np.testing.assert_allclose(to_np(out), to_np(ref), atol=ATOL, rtol=0)


def test_fast_gelu_matches_jax():
    x = (np.random.default_rng(28).normal(size=(4, 257)) * 3.0).astype(np.float32)
    np.testing.assert_allclose(
        tgelu.gelu_fast(torch.from_numpy(x)).numpy(), np.asarray(jgelu.gelu_fast(jnp.asarray(x))),
        atol=1e-6, rtol=0,
    )
    assert tgelu.get_gelu_impl() == "exact"
    with gelu_mode("fast"):
        assert tgelu.get_gelu_impl() == "fast"
        np.testing.assert_allclose(
            tgelu.gelu(torch.from_numpy(x)).numpy(), np.asarray(jgelu.gelu(jnp.asarray(x))),
            atol=1e-6, rtol=0,
        )
    assert tgelu.get_gelu_impl() == "exact"
    np.testing.assert_allclose(
        tgelu.gelu(torch.from_numpy(x)).numpy(), np.asarray(jgelu.gelu(jnp.asarray(x))),
        atol=1e-6, rtol=0,
    )
    with pytest.raises(ValueError, match="exact"):
        tgelu.set_gelu_impl("tanh")
