"""Port vs JAX: the plain twins of kernels K1 and K2 (ops/fused_attention.py).

Each plain twin is held against both JAX forms of its kernel: the Pallas
kernel in interpret mode and its XLA fallback. Shapes cover tiny widths and
the real head widths (D=88 at S=257 for the ViT, D=80 at S=130 for OPT) with
2 heads, K1 past its whole-row limit (S=400, which the card runs on K2's
body) and K2 past K2_MAX_SEQ (S=2,100, the card's two-pass body). Tolerances: fp32 atol 1e-5; bf16 atol = rtol = 2e-2 (one bf16 ulp of
a rounded score, after scaling, moves a probability by under 1%), with NaN
rows equal where a fully masked query row is NaN in bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu.ops import fused_attention as jfa
from eilev_tpu_torch.ops import fused_attention as tfa

from ._torch_port import to_np

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(atol=1e-5, rtol=1e-5) if dtype == "fp32" else dict(atol=2e-2, rtol=2e-2)


def _qkv(b, s, nh, hd, dtype, seed):
    x = np.random.default_rng(seed).normal(size=(b, s, 3 * nh * hd)).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


@pytest.mark.parametrize("form", ["interpret", "xla"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,s,nh,hd", [(3, 9, 2, 8), (2, 257, 2, 88), (1, 400, 2, 16)])
def test_k1_plain_matches_jax(b, s, nh, hd, dtype, form):
    jq, tq = _qkv(b, s, nh, hd, dtype, seed=s)
    scale = hd**-0.5
    if form == "interpret":
        ref = jfa.packed_qkv_attention(jq, nh, hd, scale=scale, interpret=True)
    else:
        ref = jfa._xla_packed_fallback(jq, nh, hd, scale)
    ours = tfa.packed_qkv_attention_reference(tq, nh, hd, scale)
    assert ours.dtype == tq.dtype and tuple(ours.shape) == (b, s, nh * hd)
    np.testing.assert_allclose(to_np(ours), to_np(ref), **_tol(dtype))


def _mask(b, s, padding):
    m = np.ones((b, s), np.int32)
    if padding == "left":
        m[0, : s // 5] = 0
    elif padding == "right":
        m[1, s - s // 4 :] = 0
    return m


@pytest.mark.parametrize("form", ["interpret", "xla"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("padding", ["none", "left", "right"])
@pytest.mark.parametrize("b,s,nh,hd", [(2, 24, 2, 8), (2, 130, 2, 80)])
def test_k2_plain_matches_jax(b, s, nh, hd, padding, dtype, form):
    jq, tq = _qkv(b, s, nh, hd, dtype, seed=s + 1)
    m = _mask(b, s, padding)
    scale = hd**-0.5
    if form == "interpret":
        ref = jfa.packed_qkv_causal_attention(jq, nh, hd, jnp.asarray(m), scale=scale, interpret=True)
    else:
        ref = jfa._xla_packed_causal_fallback(jq, nh, hd, jnp.asarray(m), scale)
    ours = tfa.packed_qkv_causal_attention_reference(tq, nh, hd, torch.from_numpy(m), scale)
    assert ours.dtype == tq.dtype and tuple(ours.shape) == (b, s, nh * hd)
    ref_np = to_np(ref)
    if padding == "left" and dtype == "bf16":
        # finfo(float32).min is -inf in bf16: the left-padded query rows of
        # row 0 attend only masked keys and are NaN in the reference too
        assert np.isnan(ref_np[0, : s // 5]).all()
    np.testing.assert_allclose(to_np(ours), ref_np, equal_nan=True, **_tol(dtype))


def test_wrappers_take_the_plain_twin_on_cpu():
    _, tq = _qkv(2, 17, 2, 8, "fp32", seed=3)
    mask = torch.ones(2, 17, dtype=torch.int32)
    k1, k2 = tfa.packed_qkv_attention.launches, tfa.packed_qkv_causal_attention.launches
    torch.testing.assert_close(
        tfa.packed_qkv_attention(tq, 2, 8),
        tfa.packed_qkv_attention_reference(tq, 2, 8, 8**-0.5),
        rtol=0, atol=0,
    )
    torch.testing.assert_close(
        tfa.packed_qkv_causal_attention(tq, 2, 8, mask),
        tfa.packed_qkv_causal_attention_reference(tq, 2, 8, mask, 8**-0.5),
        rtol=0, atol=0,
    )
    # the counters count kernel launches only
    assert (tfa.packed_qkv_attention.launches, tfa.packed_qkv_causal_attention.launches) == (k1, k2)


def test_wrappers_refuse_other_devices():
    qkv = torch.empty(1, 4, 3 * 2 * 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfa.packed_qkv_attention(qkv, 2, 8)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfa.packed_qkv_causal_attention(qkv, 2, 8, torch.ones(1, 4, device="meta"))


@pytest.mark.parametrize("form", ["interpret", "xla"])
def test_k2_fp32_fully_masked_rows_are_uniform(form):
    """In fp32 finfo(float32).min is finite: a query row with no kept key is
    the uniform average of every V row (of all S keys, the causally masked
    ones too), in the JAX kernel and in the twin."""
    b, s, nh, hd = 2, 24, 2, 8
    jq, tq = _qkv(b, s, nh, hd, "fp32", seed=7)
    m = _mask(b, s, "left")  # row 0: keys 0 .. s // 5 - 1 padded
    if form == "interpret":
        ref = jfa.packed_qkv_causal_attention(jq, nh, hd, jnp.asarray(m), scale=hd**-0.5, interpret=True)
    else:
        ref = jfa._xla_packed_causal_fallback(jq, nh, hd, jnp.asarray(m), hd**-0.5)
    ours = tfa.packed_qkv_causal_attention_reference(tq, nh, hd, torch.from_numpy(m), hd**-0.5)
    v_mean = tq.reshape(b, s, 3, nh * hd)[0, :, 2].mean(0).numpy()
    dead = s // 5
    np.testing.assert_allclose(to_np(ours)[0, :dead], np.broadcast_to(v_mean, (dead, nh * hd)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(to_np(ref)[0, :dead], np.broadcast_to(v_mean, (dead, nh * hd)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(to_np(ours), to_np(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("form", ["interpret", "xla"])
def test_k2_plain_matches_jax_past_k2_max_seq(form):
    """bf16 at S = 2,100, past K2_MAX_SEQ, where the card runs the two-pass
    body: the twin against JAX's packed causal attention at 2 small heads,
    row 0 left-padded by 420 (its padded query rows NaN in both)."""
    b, s, nh, hd = 2, 2100, 2, 8
    jq, tq = _qkv(b, s, nh, hd, "bf16", seed=11)
    m = _mask(b, s, "left")
    if form == "interpret":
        ref = jfa.packed_qkv_causal_attention(jq, nh, hd, jnp.asarray(m), scale=hd**-0.5, interpret=True)
    else:
        ref = jfa._xla_packed_causal_fallback(jq, nh, hd, jnp.asarray(m), hd**-0.5)
    ours = tfa.packed_qkv_causal_attention_reference(tq, nh, hd, torch.from_numpy(m), hd**-0.5)
    ref_np = to_np(ref)
    assert np.isnan(ref_np[0, : s // 5]).all() and np.isfinite(ref_np[0, s // 5 :]).all()
    np.testing.assert_array_equal(np.isnan(to_np(ours)), np.isnan(ref_np))
    np.testing.assert_allclose(to_np(ours), ref_np, equal_nan=True, **_tol("bf16"))


# (dtype, S, causal) -> the body a CUDA call takes: fp32 the fp32 body at any
# S; bf16 K2 K2's streamed body up to K2_MAX_SEQ (2,048); bf16 K1 whole rows
# up to K1_MAX_SEQ (384), K2's body past it; both the two-pass body past
# K2_MAX_SEQ
PACKED_ROUTE = [
    ((torch.float32, 257, False), "f32"), ((torch.float32, 5000, False), "f32"),
    ((torch.float32, 766, True), "f32"),
    ((torch.bfloat16, 1, False), "whole_rows"), ((torch.bfloat16, 257, False), "whole_rows"),
    ((torch.bfloat16, 384, False), "whole_rows"), ((torch.bfloat16, 385, False), "streamed"),
    ((torch.bfloat16, 577, False), "streamed"), ((torch.bfloat16, 2048, False), "streamed"),
    ((torch.bfloat16, 17, True), "streamed"), ((torch.bfloat16, 766, True), "streamed"),
    ((torch.bfloat16, 2048, True), "streamed"), ((torch.bfloat16, 2049, True), "two_pass"),
    ((torch.bfloat16, 4096, True), "two_pass"), ((torch.bfloat16, 2049, False), "two_pass"),
    ((torch.bfloat16, 3072, False), "two_pass"), ((torch.float32, 4096, True), "f32"),
]


@pytest.mark.parametrize("case,want", PACKED_ROUTE)
def test_packed_body_route(case, want):
    dtype, s, causal = case
    qkv = torch.empty(2, s, 3 * 16 * 88, dtype=dtype, device="meta")
    assert tfa.packed_body(qkv, causal) == want


def test_cuda_checks_take_bf16_and_fp32_only():
    """What the CUDA wrappers accept, read on CPU tensors (no launch): bf16 and
    fp32 at any S up to the grid's 65,535 query tiles of 64 (bf16 past
    K2_MAX_SEQ through the two-pass body); fp16 raises."""
    tfa._check(torch.zeros(1, tfa.K2_MAX_SEQ, 3 * 2 * 8, dtype=torch.bfloat16), 2, 8)
    tfa._check(torch.zeros(1, tfa.K2_MAX_SEQ + 1, 3 * 2 * 8), 2, 8)
    tfa._check(torch.zeros(1, tfa.K2_MAX_SEQ + 1, 3 * 2 * 8, dtype=torch.bfloat16), 2, 8)
    too_long = torch.empty(1, 65535 * 64 + 1, 3 * 2 * 8, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="positions"):
        tfa._check(too_long, 2, 8)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        tfa._check(torch.zeros(1, 8, 3 * 2 * 8, dtype=torch.float16), 2, 8)
