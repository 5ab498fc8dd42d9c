"""Port vs JAX: the int8 serving layers (ops/quantization.py) and the loading of
quantized parameter trees (models/convert.py), in fp32.

- ``quantize_int8`` and ``quantize_act_rows`` are bit-equal to JAX.
- ``Int8Dense`` on both sides of the 64-row W8A8 dispatch, and
  ``Int8W8A8Dense``, agree with the flax modules to atol 1e-5 (the same
  products; only the fp32 sums' order can differ).
- Trees quantized by JAX ``quantize_lm_params`` / ``quantize_vision_params``
  / ``quantize_qformer_params`` load ``strict=True`` into the port through
  ``params_from_jax``; the port's own tree functions give the same trees, and
  ``quantize_model_`` on a float port model gives the same state dict.

The float tree is built first and quantized with the JAX functions:
``_torch_port.random_params`` fills every leaf named ``scale`` as a LayerNorm
scale, so it cannot make int8 trees itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from eilev_tpu import configs
from eilev_tpu.models.video_blip import VideoBlipForConditionalGeneration as JVB
from eilev_tpu.ops import quantization as jq
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.models import VideoBlipForConditionalGeneration, params_from_jax
from eilev_tpu_torch.models.convert import flax_to_state_dict
from eilev_tpu_torch.ops import quantization as tq

from ._torch_port import random_params, to_np

ATOL = 1e-5


def _dense_tree(k_in, k_out, seed, zero_column=False):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(k_in, k_out)) * 0.05).astype(np.float32)
    if zero_column:
        w[:, 3] = 0.0  # absmax 0: scale 1, values 0
    w8, scale = jq.quantize_int8(jnp.asarray(w))
    bias = (rng.normal(size=(k_out,)) * 0.01).astype(np.float32)
    return w, {"w8": np.asarray(w8), "scale": np.asarray(scale), "bias": bias}


def test_quantize_int8_bit_equal_to_jax():
    w, tree = _dense_tree(32, 24, seed=0, zero_column=True)
    w8, scale = tq.quantize_int8(torch.from_numpy(w))
    assert w8.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(w8.numpy(), tree["w8"])
    np.testing.assert_array_equal(scale.numpy(), tree["scale"])
    assert scale[3] == 1.0 and (w8[:, 3] == 0).all()


def test_quantize_act_rows_bit_equal_to_jax():
    x = np.random.default_rng(1).normal(size=(2, 5, 32)).astype(np.float32)
    x[1, 2] = 0.0
    j8, js = jq.quantize_act_rows(jnp.asarray(x))
    t8, ts = tq.quantize_act_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _port_layer(cls, tree, k_in, k_out, **kwargs):
    mod = cls(k_in, k_out, **kwargs)
    mod.load_state_dict(flax_to_state_dict(tree), strict=True)
    return mod.eval()


@pytest.mark.parametrize("w8a8_min_rows", [0, jq.W8A8_PREFILL_MIN_ROWS])
@pytest.mark.parametrize("rows", [30, 80])  # below and above the 64-row dispatch
def test_int8_dense_matches_flax(rows, w8a8_min_rows):
    _, tree = _dense_tree(32, 24, seed=2)
    x = np.random.default_rng(3).normal(size=(2, rows // 2, 32)).astype(np.float32)
    ref = jq.Int8Dense(features=24, dtype=jnp.float32, w8a8_min_rows=w8a8_min_rows).apply(
        {"params": tree}, jnp.asarray(x)
    )
    ours = _port_layer(tq.Int8Dense, tree, 32, 24, w8a8_min_rows=w8a8_min_rows)
    with torch.no_grad():
        out = ours(torch.from_numpy(x))
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, rows // 2, 24)
    np.testing.assert_allclose(to_np(out), to_np(ref), atol=ATOL, rtol=0)
    if w8a8_min_rows and rows >= w8a8_min_rows:
        # the W8A8 side really ran: it differs from weight-only by activation rounding
        weight_only = _port_layer(tq.Int8Dense, tree, 32, 24)
        with torch.no_grad():
            assert not torch.equal(out, weight_only(torch.from_numpy(x)))


@pytest.mark.parametrize("bias", [True, False])
def test_int8_w8a8_dense_matches_flax(bias):
    _, tree = _dense_tree(32, 24, seed=4)
    if not bias:
        del tree["bias"]
    x = np.random.default_rng(5).normal(size=(3, 10, 32)).astype(np.float32)
    ref = jq.Int8W8A8Dense(features=24, use_bias=bias, dtype=jnp.float32).apply(
        {"params": tree}, jnp.asarray(x)
    )
    ours = _port_layer(tq.Int8W8A8Dense, tree, 32, 24, bias=bias)
    with torch.no_grad():
        out = ours(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(out), to_np(ref), atol=ATOL, rtol=0)


def test_dense_cls_follows_the_config():
    text = tconfigs.tiny_config().text_config
    assert tq.dense_cls(text) is nn.Linear
    assert tq.dense_cls(tconfigs.replace(text, quantize_matmuls=True)) is tq.Int8Dense
    w8a8 = tq.dense_cls(tconfigs.replace(text, quantize_matmuls=True, w8a8_prefill=True))
    assert w8a8(8, 8).w8a8_min_rows == tq.W8A8_PREFILL_MIN_ROWS
    vision = tconfigs.tiny_config().vision_config
    assert tq.vision_dense_cls(vision) is nn.Linear
    assert tq.vision_dense_cls(tconfigs.replace(vision, quantize_matmuls=True)) is tq.Int8W8A8Dense


@pytest.fixture(scope="module")
def float_tree():
    cfg = configs.tiny_config()
    b, s, img = 1, 12, cfg.vision_config.image_size
    vim = np.zeros((b, s), np.int32)
    vim[:, 1 : 1 + cfg.num_query_tokens] = 1
    params = random_params(
        JVB(cfg), 9, input_ids=jnp.zeros((b, s), jnp.int32),
        pixel_values=jnp.zeros((b, 3, 2, img, img)), video_input_mask=jnp.asarray(vim),
    )
    return jax.tree.map(np.asarray, params)


def _jax_quantized(params):
    q = dict(params)
    q["language_model"] = jq.quantize_lm_params(params["language_model"])
    q["vision_model"] = jq.quantize_vision_params(params["vision_model"])
    q["qformer"] = jq.quantize_qformer_params(params["qformer"])
    return jax.tree.map(np.asarray, q)


def _int8_config():
    cfg = tconfigs.tiny_config()
    return tconfigs.replace(
        cfg,
        text_config=tconfigs.replace(cfg.text_config, quantize_matmuls=True, int8_kv_cache=True),
        vision_config=tconfigs.replace(cfg.vision_config, quantize_matmuls=True),
        qformer_config=tconfigs.replace(cfg.qformer_config, quantize_matmuls=True),
    )


def test_quantized_jax_trees_load_strict(float_tree):
    cfg = _int8_config()
    model = VideoBlipForConditionalGeneration(cfg, device="cpu")
    sd = params_from_jax(_jax_quantized(float_tree), cfg)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    layer = model.language_model.layers[0]
    assert isinstance(layer.self_attn.qkv_proj, tq.Int8Dense)
    assert layer.self_attn.qkv_proj.w8.dtype == torch.int8
    assert isinstance(model.vision_model.vision.layers[0].mlp.fc1, tq.Int8W8A8Dense)
    assert isinstance(model.qformer.layers[0].ffn_query.output, tq.Int8W8A8Dense)
    # LayerNorm scales still map to weight; the int8 scales keep their name
    assert "language_model.layers.0.self_attn_layer_norm.weight" in sd
    assert sd["language_model.layers.0.fc1.scale"].dtype == torch.float32


@pytest.mark.parametrize(
    "subtree,fn",
    [
        ("language_model", "quantize_lm_params"),
        ("vision_model", "quantize_vision_params"),
        ("qformer", "quantize_qformer_params"),
    ],
)
def test_port_tree_functions_match_jax(float_tree, subtree, fn):
    ref = jax.tree.map(np.asarray, getattr(jq, fn)(float_tree[subtree]))
    ours = getattr(tq, fn)(float_tree[subtree])
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def test_quantize_model_in_place_matches_quantized_tree(float_tree):
    cfg = tconfigs.tiny_config()
    model = VideoBlipForConditionalGeneration(cfg, device="cpu")
    model.load_state_dict(params_from_jax(float_tree, cfg), strict=True)
    tq.quantize_model_(model, int8_lm=True, int8_kv=True, int8_vision=True, int8_qformer=True)
    want = params_from_jax(_jax_quantized(float_tree), _int8_config())
    got = model.state_dict()
    assert set(got) == set(want)
    for key, val in want.items():
        assert got[key].dtype == val.dtype, key
        torch.testing.assert_close(got[key], val, rtol=0, atol=0, msg=key)
    assert model.config == _int8_config()
    assert model.language_model.config.int8_kv_cache
    assert model.language_model.layers[1].self_attn.config.quantize_matmuls
    assert model.vision_model.vision.layers[0].self_attn.config.quantize_matmuls


def test_quantize_model_w8a8_prefill_needs_int8_lm():
    model = VideoBlipForConditionalGeneration(tconfigs.tiny_config(), device="cpu")
    with pytest.raises(ValueError, match="int8_lm"):
        tq.quantize_model_(model, w8a8_prefill=True)
    tq.quantize_model_(model, int8_lm=True, w8a8_prefill=True)
    fc1 = model.language_model.layers[0].fc1
    assert isinstance(fc1, tq.Int8Dense) and fc1.w8a8_min_rows == tq.W8A8_PREFILL_MIN_ROWS
    assert isinstance(model.vision_model.vision.layers[0].mlp.fc1, nn.Linear)
