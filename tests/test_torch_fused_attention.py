"""Port vs JAX: the plain twins of kernels K1 and K2 (ops/fused_attention.py).

Each plain twin is held against both JAX forms of its kernel: the Pallas
kernel in interpret mode and its XLA fallback. Shapes cover tiny widths and
the real head widths (D=88 at S=257 for the ViT, D=80 at S=130 for OPT) with
2 heads, K1 past its whole-row limit (S=400, which the card runs on the
two-pass body) and K2 at S=2,100 (past OPT's 2,048 positions). Tolerances: fp32 atol 1e-5; bf16 atol = rtol = 2e-2 (one bf16 ulp of
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
    """bf16 at S = 2,100, past OPT's 2,048 positions (the card runs the
    two-pass body at any S): the twin against JAX's packed causal attention
    at 2 small heads,
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
# S; bf16 K1 whole rows in registers up to K1_MAX_SEQ (384), the two-pass body
# past it; bf16 K2 the two-pass body at every S
PACKED_ROUTE = [
    ((torch.float32, 257, False), "f32"), ((torch.float32, 5000, False), "f32"),
    ((torch.float32, 766, True), "f32"),
    ((torch.bfloat16, 1, False), "sm90_rows"), ((torch.bfloat16, 257, False), "sm90_rows"),
    ((torch.bfloat16, 384, False), "sm90_rows"), ((torch.bfloat16, 385, False), "sm90"),
    ((torch.bfloat16, 577, False), "sm90"), ((torch.bfloat16, 2048, False), "sm90"),
    ((torch.bfloat16, 17, True), "sm90"), ((torch.bfloat16, 766, True), "sm90"),
    ((torch.bfloat16, 2048, True), "sm90"), ((torch.bfloat16, 2049, True), "sm90"),
    ((torch.bfloat16, 4096, True), "sm90"), ((torch.bfloat16, 2049, False), "sm90"),
    ((torch.bfloat16, 3072, False), "sm90"), ((torch.float32, 4096, True), "f32"),
]


@pytest.mark.parametrize("case,want", PACKED_ROUTE)
def test_packed_body_route(case, want):
    dtype, s, causal = case
    qkv = torch.empty(2, s, 3 * 16 * 88, dtype=dtype, device="meta")
    assert tfa.packed_body(qkv, causal) == want


# the head dims of the port's attentions (64, OPT's 80, the ViT's 88, 128)
# and lengths at the edges of the bodies' tiles and capacities
GRID_DIMS = [64, 80, 88, 128]
GRID_LENGTHS = [1, 64, 65, 257, 384, 385, 2048, 2049, 4096]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", GRID_LENGTHS)
@pytest.mark.parametrize("hd", GRID_DIMS)
def test_packed_body_at_every_head_dim_and_length(hd, s, causal):
    """bf16: the rule reads S and causality only (every head dim takes the
    same body); the CUDA checks take the shape (no launch, on meta tensors)
    and the body's shared memory fits a block."""
    qkv = torch.empty(2, s, 3 * 4 * hd, dtype=torch.bfloat16, device="meta")
    want = "sm90" if causal or s > tfa.K1_MAX_SEQ else "sm90_rows"
    assert tfa.packed_body(qkv, causal) == want
    tfa._check(qkv, 4, hd)
    assert tfa.packed_smem_bytes(want, s, hd) <= tfa.MAX_SMEM


def test_shared_memory_of_the_packed_bodies():
    """The layouts' sizes in bytes: a head cut into parts of 64 and 16
    columns at OPT's 80 and 64 and 32 at the ViT's 88; the two-pass body's
    rings (124,032 at D = 80, one block an SM), the whole-row body's K and V
    of a head at 272 keys with three Q buffers (the ViT: 142,400) and at its
    384-key capacity with two, which at D = 128 leaves 1,984 of the 232,448
    bytes a block may use."""
    assert [tfa.part_widths(d) for d in (8, 16, 24, 32, 48, 64, 72, 80, 88, 96, 112, 128)] == [
        (16, 0), (16, 0), (32, 0), (32, 0), (64, 0), (64, 0), (64, 16), (64, 16), (64, 32), (64, 32),
        (64, 64), (64, 64)]
    assert tfa.packed_smem_bytes("sm90", 766, 80) == 124032
    assert tfa.packed_smem_bytes("sm90", 766, 64) == 99456
    assert tfa.packed_smem_bytes("sm90", 4096, 128) == 197760
    assert tfa.packed_smem_bytes("sm90_rows", 257, 88) == 142400
    assert tfa.packed_smem_bytes("sm90_rows", 257, 80) == 119872
    assert tfa.packed_smem_bytes("sm90_rows", 384, 128) == tfa.MAX_SMEM - 1984
    assert tfa.packed_smem_bytes("sm90_rows", 9, 8) == 15424


def test_cuda_checks_take_bf16_and_fp32_only():
    """What the CUDA wrappers accept, read on CPU tensors (no launch): bf16 and
    fp32 at any S up to 65,535 query tiles of 128 (the fp32 body's grid; the
    bf16 bodies have no length limit of their own), and at most 2^31 - 1
    blocks of (query tile, head, batch row); fp16 raises."""
    tfa._check(torch.zeros(1, 2048, 3 * 2 * 8, dtype=torch.bfloat16), 2, 8)
    tfa._check(torch.zeros(1, 2049, 3 * 2 * 8), 2, 8)
    tfa._check(torch.zeros(1, 2049, 3 * 2 * 8, dtype=torch.bfloat16), 2, 8)
    tfa._check(torch.empty(1, 65535 * 128, 3 * 2 * 8, dtype=torch.bfloat16, device="meta"), 2, 8)
    too_long = torch.empty(1, 65535 * 128 + 1, 3 * 2 * 8, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="positions"):
        tfa._check(too_long, 2, 8)
    too_many = torch.empty(65535, 4096, 3 * 2048 * 8, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="blocks"):
        tfa._check(too_many, 2048, 8)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        tfa._check(torch.zeros(1, 8, 3 * 2 * 8, dtype=torch.float16), 2, 8)
