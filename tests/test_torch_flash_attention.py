"""Port vs JAX: the K5 twin (ops/flash_attention.py) against the Pallas
flash_attention in interpret mode at block 128, and the dispatcher
ops/attention.dot_product_attention against the JAX one; the written rule
of which body a CUDA call takes (k5_body) on meta tensors.

Shapes are those of tests/models/test_flash_attention.py. Tolerances: fp32
atol 1e-5 (the same recurrence, summed in another order); bf16 atol = rtol
2e-2 (one bf16 ulp of p or of the output). Fully masked rows are exactly 0 in
both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu.ops import attention as jattn
from eilev_tpu.ops import flash_attention as jflash
from eilev_tpu_torch.ops import attention as tattn
from eilev_tpu_torch.ops import flash_attention as tflash

from ._torch_port import to_np


def _inputs(seed, b, s, l, h, d, kvh=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, l, kvh or h, d)).astype(np.float32)
    v = rng.normal(size=(b, l, kvh or h, d)).astype(np.float32)
    return q, k, v


def _jax_flash(q, k, v, dtype, **kw):
    group = q.shape[2] // k.shape[2]
    k, v = np.repeat(k, group, axis=2), np.repeat(v, group, axis=2)  # as the JAX callers do
    to = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    out = jflash.flash_attention(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        padding_mask=to(kw.get("padding_mask")), bias=to(kw.get("bias")),
        causal=kw.get("causal", False), q_offset=kw.get("q_offset", 0),
        scale=kw.get("scale"), scale_query_first=kw.get("scale_query_first", False),
        block_q=128, block_kv=128, interpret=True,
    )
    return np.asarray(out.astype(jnp.float32))


def _port_flash(q, k, v, dtype, **kw):
    to = lambda x: None if x is None else torch.from_numpy(np.asarray(x))  # noqa: E731
    kw = dict(kw, padding_mask=to(kw.get("padding_mask")), bias=to(kw.get("bias")))
    out = tflash.flash_attention(
        torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype), torch.from_numpy(v).to(dtype), **kw
    )
    assert out.dtype == dtype
    return to_np(out)


def _case(name):
    """(inputs, kwargs) of each shape of tests/models/test_flash_attention.py."""
    if name == "vit":  # 257 tokens, hd 88: non-multiples of the tiling
        return _inputs(0, 3, 257, 257, 4, 88), {"scale": 88**-0.5}
    if name == "opt_causal_left_padded":
        pm = np.ones((2, 100), np.int32)
        pm[0, :17] = 0
        return _inputs(1, 2, 100, 100, 2, 80), {
            "padding_mask": pm, "causal": True, "scale": 80**-0.5, "scale_query_first": True}
    if name == "prefill_padded_cache":  # 70 queries into 200 slots, score-side scale
        pm = np.zeros((2, 200), np.int32)
        pm[:, :70] = 1
        return _inputs(2, 2, 70, 200, 2, 80), {"padding_mask": pm, "causal": True, "scale": 80**-0.5}
    if name == "cross_padded_keys":
        pm = np.ones((2, 300), np.int32)
        pm[1, 250:] = 0
        return _inputs(3, 2, 64, 300, 2, 64), {"padding_mask": pm, "scale": 64**-0.5}
    if name == "t5_bias":
        q, k, v = _inputs(4, 2, 90, 90, 2, 64)
        bias = np.random.default_rng(40).normal(size=(2, 90, 90)).astype(np.float32) * 2.0
        pm = np.ones((2, 90), np.int32)
        pm[0, 80:] = 0
        return (q, k, v), {"bias": bias, "padding_mask": pm}
    if name == "t5_decode_self":
        # the T5 decoder's cached step: one query over 33 slots, the (H, 1, L)
        # relative bias at q_offset = index, the (B, L) filled-slot mask
        q, k, v = _inputs(9, 3, 1, 33, 4, 64)
        bias = np.random.default_rng(41).normal(size=(4, 1, 33)).astype(np.float32) * 2.0
        pm = np.zeros((3, 33), np.int32)
        pm[:, :13] = 1
        return (q, k, v), {"bias": bias, "padding_mask": pm}
    if name == "t5_decode_cross":  # one query over padded encoder keys, no scale
        pm = np.ones((3, 300), np.int32)
        pm[1, 260:] = 0
        pm[2, 140:] = 0
        return _inputs(10, 3, 1, 300, 4, 64), {"padding_mask": pm}
    if name == "gqa_q_offset":  # 4 heads over 2 kv heads, causal with q_offset
        return _inputs(6, 2, 60, 190, 4, 64, kvh=2), {"causal": True, "q_offset": 130, "scale": 0.125}
    if name == "llama_left_padded_tile":
        # the LLaMA prefill form at hd 128 (GQA 4 over 2, score-side scale,
        # empty cache tail); row 0 is left-padded by 150, so its key tile 0
        # is wholly masked: the tiles the card's Hopper body skips
        pm = np.zeros((2, 320), np.int32)
        pm[:, :300] = 1
        pm[0, :150] = 0
        return _inputs(7, 2, 300, 320, 4, 128, kvh=2), {
            "padding_mask": pm, "causal": True, "scale": 128**-0.5}
    raise KeyError(name)


CASES = ["vit", "opt_causal_left_padded", "prefill_padded_cache", "cross_padded_keys", "t5_bias",
         "t5_decode_self", "t5_decode_cross", "gqa_q_offset", "llama_left_padded_tile"]


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_jax_flash(name, dtype):
    (q, k, v), kw = _case(name)
    tdtype, jdtype = getattr(torch, dtype), getattr(jnp, dtype)
    ref = _jax_flash(q, k, v, jdtype, **kw)
    ours = _port_flash(q, k, v, tdtype, **kw)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(ours, ref, atol=tol, rtol=0 if dtype == "float32" else tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_rows_are_exactly_zero(dtype):
    q, k, v = _inputs(5, 1, 64, 64, 1, 64)
    pm = np.zeros((1, 64), np.int32)
    pm[:, 32:] = 1  # causal rows 0..31 see only masked keys
    kw = {"padding_mask": pm, "causal": True, "scale": 0.125}
    ours = _port_flash(q, k, v, getattr(torch, dtype), **kw)
    ref = _jax_flash(q, k, v, getattr(jnp, dtype), **kw)
    assert np.isfinite(ours).all()
    assert (ours[0, :32] == 0).all() and (ref[0, :32] == 0).all()
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(ours, ref, atol=tol, rtol=0)


def test_left_padded_tile_rows_are_exactly_zero():
    """In llama_left_padded_tile, batch row 0's first 150 query rows see only
    padded keys (0 on the card and in the twin, which the Pallas kernel
    matches above), and its key tile 0 holds no kept key at all."""
    (q, k, v), kw = _case("llama_left_padded_tile")
    assert not kw["padding_mask"][0, : tflash.BLOCK_KV].any()
    out = _port_flash(q, k, v, torch.float32, **kw)
    assert (out[0, :150] == 0).all() and (out[0, 150:] != 0).any(axis=-1).all()
    assert np.isfinite(out).all()


def test_cpu_wrapper_runs_the_twin_without_counting():
    (q, k, v), kw = _case("prefill_padded_cache")
    kw = dict(kw, padding_mask=torch.from_numpy(kw["padding_mask"]))
    args = [torch.from_numpy(x) for x in (q, k, v)]
    before = (tflash.flash_attention.launches, tflash.flash_attention.launches_sm90)
    out = tflash.flash_attention(*args, **kw)
    assert (tflash.flash_attention.launches, tflash.flash_attention.launches_sm90) == before
    torch.testing.assert_close(out, tflash.flash_attention_reference(*args, **kw), atol=0, rtol=0)


def _meta(shape, strides=None):
    """A tensor with shape and strides only (the rule reads nothing else)."""
    if strides is None:
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")
    return torch.empty_strided(shape, strides, dtype=torch.bfloat16, device="meta")


def _sm90_rule_case(name):
    """(q, k, v, bias) of each row of the body-choice table."""
    llama_cache = _meta((32, 4, 2048, 8, 128))  # a stacked (layers, B, slots, kv heads, hd) cache
    if name == "llama_prefill":  # contiguous q, k/v a layer slice read in place
        return _meta((4, 1984, 32, 128)), llama_cache[5], llama_cache[5], None
    if name == "llama_prefill_b1":
        return _meta((1, 1984, 32, 128)), _meta((1, 2048, 32, 128)), _meta((1, 2048, 32, 128)), None
    if name == "gqa_4_over_1_q_offset":
        return _meta((2, 70, 4, 128)), _meta((2, 333, 1, 128)), _meta((2, 333, 1, 128)), None
    if name.startswith("hd_"):
        d = int(name[3:])
        return _meta((2, 257, 16, d)), _meta((2, 257, 16, d)), _meta((2, 257, 16, d)), None
    if name == "bias":
        x = _meta((2, 90, 4, 128))
        return x, x, x, _meta((4, 90, 90))
    if name == "rows_overlap":  # a row stride below heads * hd
        x = _meta((2, 90, 4, 128), (90 * 256, 256, 128, 1))
        return x, x, x, None
    if name == "batches_overlap":
        x = _meta((2, 90, 4, 128), (512, 512, 128, 1))
        return x, x, x, None
    if name == "batch_1_any_batch_stride":  # a single batch row's stride is never used
        x = _meta((1, 90, 4, 128), (8, 512, 128, 1))
        return x, x, x, None
    if name == "fp32_llama_prefill":  # an fp32 model: the fp32 body of attention_f32.cu
        q = torch.empty((1, 1984, 32, 128), dtype=torch.float32, device="meta")
        k = torch.empty((1, 2048, 32, 128), dtype=torch.float32, device="meta")
        return q, k, k, None
    if name == "keys_past_shared_memory":
        q = _meta((1, 8, 1, 128))
        k = _meta((1, 500_000, 1, 128))
        return q, k, k, None
    raise KeyError(name)


SM90_RULE = {
    "llama_prefill": True, "llama_prefill_b1": True, "gqa_4_over_1_q_offset": True,
    "batch_1_any_batch_stride": True, "hd_88": False, "hd_64": True, "hd_80": False,
    "hd_120": False, "bias": False, "rows_overlap": False, "batches_overlap": False,
    "keys_past_shared_memory": False, "fp32_llama_prefill": False,
}


@pytest.mark.parametrize("name", list(SM90_RULE))
def test_sm90_body_rule(name):
    """Whether a CUDA call takes K5's Hopper body (wgmma + TMA): head_dim
    128 or 64 with no bias and non-overlapping rows and batches whose shared
    memory fits (a bias only at 64, in bf16 padded rows: test_k5_body_rule);
    the mma.sync body for the rest of these rows."""
    q, k, v, bias = _sm90_rule_case(name)
    assert tflash.uses_sm90_body(q, k, v, bias) is SM90_RULE[name]


def test_sm90_shared_memory_layout():
    # Q + 2 K + 2 V tiles of 128 x 128 bf16, the barrier block, 4 keep-bit
    # words and a list entry per 128-key tile, 1 KB of alignment slack
    assert tflash.sm90_smem_bytes(2048) == 5 * 32768 + 128 + 16 * 20 + 1024
    assert tflash.sm90_smem_bytes(300) == 5 * 32768 + 128 + 3 * 20 + 1024
    assert tflash.sm90_smem_bytes(2048) <= tflash.SMEM_LIMIT < tflash.sm90_smem_bytes(500_000)


def _padded_bias(h, s, l, dtype=torch.bfloat16):
    """An (h, s, l) view of an (h, s, l rounded up to 8) buffer: the T5
    module's bias layout (models/t5.py: compute_bias)."""
    return _meta((h, s, -(-l // 8) * 8)).to(dtype)[:, :, :l]


def _k5_form(name):
    """(q, k, v, bias) of each form K5's callers give it, as meta tensors."""
    if name.startswith("t5_encoder"):  # 766 prompt tokens, 32 x 64, the relative bias
        b = 4 if name.startswith("t5_encoder_b4") else 1
        x = _meta((b, 766, 32, 64))
        bias = {"t5_encoder_b1": _padded_bias(32, 766, 766), "t5_encoder_b4": _padded_bias(32, 766, 766),
                "t5_encoder_b4_fp32_bias": _padded_bias(32, 766, 766, torch.float32),
                "t5_encoder_b4_unpadded_bias": _meta((32, 766, 766))}[name]
        return x, x, x, bias
    if name in ("t5_decoder_self", "engine_self"):  # one query over a layer slice of the stacked cache
        slots = 33 if name == "t5_decoder_self" else 64
        cache = _meta((6, 4, slots, 32, 64))
        return _meta((4, 1, 32, 64)), cache[1], cache[1], _padded_bias(32, 1, slots)
    if name in ("t5_cross", "engine_cross"):  # one query over the stacked encoder K/V
        cross = _meta((6, 4, 766 if name == "t5_cross" else 832, 32, 64))
        return _meta((4, 1, 32, 64)), cross[2], cross[2], None
    if name == "videomae":  # (8, 1,568, 12 x 64), no mask, no bias
        x = _meta((8, 1568, 12, 64))
        return x, x, x, None
    if name.startswith("qformer"):  # 32 queries of 68 videos over 32 queries or 8 x 257 frame tokens
        keys = 32 if name == "qformer_self" else 2056
        return _meta((68, 32, 12, 64)), _meta((68, keys, 12, 64)), _meta((68, keys, 12, 64)), None
    if name == "llama_prefill":
        cache = _meta((32, 4, 2048, 32, 128))
        return _meta((4, 1984, 32, 128)), cache[3], cache[3], None
    if name == "hd_80":
        x = _meta((2, 257, 16, 80))
        return x, x, x, None
    if name == "hd_128_bias":
        x = _meta((2, 90, 4, 128))
        return x, x, x, _padded_bias(4, 90, 90)
    if name == "rows_overlap":  # a row stride below heads * hd
        x = _meta((2, 90, 4, 64), (90 * 128, 128, 64, 1))
        return x, x, x, None
    if name in ("four_queries", "five_queries"):
        x = _meta((2, 4 if name == "four_queries" else 5, 8, 64))
        return x, _meta((2, 500, 8, 64)), _meta((2, 500, 8, 64)), None
    if name == "one_query_past_shared_memory":  # 57,600 keys: 450 tiles of scores, past 227 KB
        return _meta((1, 1, 4, 64)), _meta((1, 57_600, 4, 64)), _meta((1, 57_600, 4, 64)), None
    if name == "fp32":
        x = torch.empty((1, 1, 4, 64), device="meta")
        return x, x, x, None
    raise KeyError(name)


K5_BODY_RULE = {
    "t5_encoder_b1": "sm90", "t5_encoder_b4": "sm90", "t5_encoder_b4_fp32_bias": "mma",
    "t5_encoder_b4_unpadded_bias": "mma", "t5_decoder_self": "decode", "t5_cross": "decode",
    "engine_self": "decode", "engine_cross": "decode", "videomae": "sm90", "qformer_self": "sm90",
    "qformer_cross": "sm90", "llama_prefill": "sm90", "hd_80": "mma", "hd_128_bias": "mma",
    "rows_overlap": "mma", "four_queries": "decode", "five_queries": "sm90",
    "one_query_past_shared_memory": "sm90", "fp32": "f32",
}


@pytest.mark.parametrize("name", list(K5_BODY_RULE))
def test_k5_body_rule(name):
    """Which K5 body a CUDA call takes at every form its callers give it: the
    decode body for the one-query steps (T5's decoder and cross steps, the
    serving engine's), the Hopper body for the T5 encoder (its bf16 bias in
    padded rows), VideoMAE, the Q-Former and the LLaMA prefill, the mma.sync
    body for head dim 80, a bias at head dim 128, an fp32 or unpadded bias,
    and overlapping rows; uses_sm90_body is the rule's "sm90" case."""
    q, k, v, bias = _k5_form(name)
    assert tflash.k5_body(q, k, v, bias) == K5_BODY_RULE[name]
    assert tflash.uses_sm90_body(q, k, v, bias) is (K5_BODY_RULE[name] == "sm90")


def test_shared_memory_of_the_new_bodies():
    # head dim 64: a block of 64 queries; Q (64 x 64), 2 K and 2 V tiles of
    # 128 x 64 bf16, and with a bias 2 bias tiles of 64 x 128 bf16
    assert tflash.sm90_smem_bytes(766, 64) == 8192 + 4 * 16384 + 128 + 6 * 20 + 1024
    assert tflash.sm90_smem_bytes(766, 64, bias=True) == 8192 + 4 * 16384 + 2 * 16384 + 128 + 6 * 20 + 1024
    assert tflash.sm90_smem_bytes(2048, 128) == tflash.sm90_smem_bytes(2048)
    # the decode body: 128 fp32 scores, 16 segment maxima and a running max a
    # key tile, 16 warps' rows and sums
    assert tflash.decode_smem_bytes(766) == 6 * 512 + 6 * 64 + 6 * 4 + 16 * 129 * 4
    assert tflash.decode_smem_bytes(386 * 128) <= tflash.SMEM_LIMIT < tflash.decode_smem_bytes(386 * 128 + 1)


def test_masks_are_read_in_place():
    """The bf16 bodies read 1-, 4- and 8-byte integer masks with contiguous
    keys where they lie, through the batch stride (0 for the T5 decoder's
    filled-slot mask expanded to (B, L)); anything else is converted."""
    filled = (torch.arange(33) < 13).to(torch.int32)[None].expand(4, 33)
    for mask in (filled, torch.ones(4, 766, dtype=torch.int64), torch.ones(4, 766, dtype=torch.bool),
                 torch.ones(4, 800, dtype=torch.int32)[:, :766]):
        assert tflash._mask_in_place(mask) is mask
    for mask in (torch.ones(4, 766), torch.ones(766, 4, dtype=torch.int32).t(), torch.ones(4, 766, dtype=torch.int16)):
        got = tflash._mask_in_place(mask)
        assert got.dtype == torch.int32 and got.is_contiguous() and torch.equal(got, mask.to(torch.int32))


@pytest.mark.parametrize("name", ["t5_bias", "t5_decode_self"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_takes_a_bf16_bias_in_padded_rows(name, dtype):
    """The T5 module's bias as the wrapper now hands it over: bf16, in an
    (H, S, L rounded up to 8) buffer viewed as (H, S, L). JAX gets the same
    values (its wrapper casts the bias to fp32, exactly)."""
    (q, k, v), kw = _case(name)
    h, s, l = kw["bias"].shape
    bias16 = torch.from_numpy(kw["bias"]).to(torch.bfloat16)
    buf = torch.zeros(h, s, -(-l // 8) * 8, dtype=torch.bfloat16)
    buf[:, :, :l] = bias16
    view = buf[:, :, :l]
    assert view.stride(1) % 8 == 0 and view.stride(2) == 1
    tdtype, jdtype = getattr(torch, dtype), getattr(jnp, dtype)
    ref = _jax_flash(q, k, v, jdtype, **dict(kw, bias=to_np(bias16)))
    out = tflash.flash_attention(torch.from_numpy(q).to(tdtype), torch.from_numpy(k).to(tdtype),
                                 torch.from_numpy(v).to(tdtype), padding_mask=torch.from_numpy(kw["padding_mask"]),
                                 bias=view)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(to_np(out), ref, atol=tol, rtol=0 if dtype == "float32" else tol)


# (q_len, kv_len, bias ndim or None, implementation): both sides of each
# threshold, a 4-d bias, and the explicit modes
DISPATCH = [
    (1024, 2048, None, "auto"), (1023, 2048, None, "auto"), (1024, 2047, None, "auto"),
    (1984, 2048, 3, "auto"), (1984, 2048, 4, "auto"), (4096, 4096, None, "auto"),
    (32, 2056, None, "auto"), (1, 2048, None, "auto"),
    (7, 9, None, "flash"), (2000, 4000, None, "xla"), (2000, 4000, None, "fused"),
    # T5: the encoder at the narration's 766 and past both thresholds (bias),
    # the decoder's cached step (bias over 33 slots) and its cross step
    (766, 766, 3, "auto"), (2048, 2048, 3, "auto"), (1, 33, 3, "auto"), (1, 766, None, "auto"),
    (766, 766, 3, "flash"), (1, 33, 3, "flash"), (1, 766, None, "flash"),
]


@pytest.mark.parametrize("s,l,bias_ndim,impl", DISPATCH)
def test_dispatch_takes_flash_where_jax_does(monkeypatch, s, l, bias_ndim, impl):
    """The port's dispatcher picks K5 on exactly the shapes where the JAX one
    picks its Pallas kernel. Both kernels are replaced by recorders: no
    attention is computed."""
    seen = []
    monkeypatch.setattr(jflash, "flash_attention", lambda *a, **k: seen.append(("jax", "flash")))
    monkeypatch.setattr(jattn, "_xla_attention", lambda *a, **k: seen.append(("jax", "xla")))
    monkeypatch.setattr(tflash, "flash_attention", lambda *a, **k: seen.append(("port", "flash")))
    monkeypatch.setattr(tattn, "plain_attention", lambda *a, **k: seen.append(("port", "xla")))
    bias_shape = {None: None, 3: (1, s, l), 4: (1, 1, s, l)}[bias_ndim]
    jbias = None if bias_shape is None else jnp.zeros(bias_shape)
    tbias = None if bias_shape is None else torch.zeros(bias_shape)
    jattn.dot_product_attention(jnp.zeros((1, s, 1, 8)), jnp.zeros((1, l, 1, 8)),
                                jnp.zeros((1, l, 1, 8)), bias=jbias, implementation=impl)
    tattn.dot_product_attention(torch.zeros(1, s, 1, 8), torch.zeros(1, l, 1, 8),
                                torch.zeros(1, l, 1, 8), bias=tbias, implementation=impl)
    assert len(seen) == 2 and seen[0][1] == seen[1][1], seen
    assert tattn.uses_flash(s, l, tbias, impl) == (seen[1][1] == "flash")


def test_default_impl_switch_matches_jax():
    assert tattn.get_default_attention_impl() == jattn.get_default_attention_impl() == "auto"
    try:
        tattn.set_default_attention_impl("flash")
        assert tattn.uses_flash(7, 9)
        tattn.set_default_attention_impl("xla")
        assert not tattn.uses_flash(4096, 4096)
        with pytest.raises(ValueError):
            tattn.set_default_attention_impl("pallas")
    finally:
        tattn.set_default_attention_impl("auto")
    assert (tattn._FLASH_MIN_Q, tattn._FLASH_MIN_KV) == (jattn._FLASH_MIN_Q, jattn._FLASH_MIN_KV)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_dot_product_attention_gqa_matches_jax(impl):
    """A GQA call (4 heads over 2 kv heads): the port reads the kv heads in
    place, JAX repeats them; the same numbers under either implementation."""
    q, k, v = _inputs(8, 2, 40, 40, 4, 32, kvh=2)
    pm = np.ones((2, 40), np.int32)
    pm[1, :5] = 0
    kw = dict(causal=True, scale=32**-0.5, softmax_in_fp32=True, implementation=impl)
    ref = jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(np.repeat(k, 2, axis=2)), jnp.asarray(np.repeat(v, 2, axis=2)),
        padding_mask=jnp.asarray(pm), **kw)
    ours = tattn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        padding_mask=torch.from_numpy(pm), **kw)
    real = pm.astype(bool)  # left-padded rows: uniform (xla) or 0 (flash), alike in both
    np.testing.assert_allclose(to_np(ours)[real], np.asarray(ref)[real], atol=1e-5, rtol=0)
    np.testing.assert_allclose(to_np(ours), np.asarray(ref), atol=1e-5, rtol=0)


def test_cuda_check_head_dims():
    """Read on CPU tensors (no launch): the fp32 body pads the head dim
    itself, so fp32 takes any head_dim up to 128 (100; 33 as views of a
    packed QKV of 3 heads, whose k and v are only 4-byte aligned); bf16 rows
    are read with 16-byte loads, so bf16 takes multiples of 8; neither takes
    more than 128."""
    for d in (100, 33, 8, 128):
        x = torch.zeros(2, 8, 2, d)
        tflash._check_cuda(x, x, x, None, None)
    q, k, v = torch.zeros(2, 8, 3 * 3 * 33).view(2, 8, 3, 3, 33).unbind(2)
    assert k.data_ptr() % 16
    tflash._check_cuda(q, k, v, None, None)
    for dtype, d in ((torch.bfloat16, 12), (torch.bfloat16, 100), (torch.float32, 136), (torch.bfloat16, 136)):
        x = torch.zeros(2, 8, 2, d, dtype=dtype)
        with pytest.raises(ValueError, match="head_dim"):
            tflash._check_cuda(x, x, x, None, None)


def test_cuda_check_takes_bf16_or_fp32():
    """What the CUDA wrapper accepts, read on CPU tensors (no launch): q, k, v
    all bf16 (rows of 16-byte loads) or all fp32 (any row stride); fp16 or
    mixed dtypes raise."""
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.zeros(2, 8, 2, 16, dtype=dtype)
        tflash._check_cuda(x, x, x, None, None)
    odd = torch.zeros(2, 9, 2, 16)[:, 1:]  # a row stride of 32, a batch stride of 288 fp32 values
    tflash._check_cuda(odd, odd, odd, None, None)
    with pytest.raises(TypeError, match="all bf16 or all fp32"):
        h = torch.zeros(2, 8, 2, 16, dtype=torch.float16)
        tflash._check_cuda(h, h, h, None, None)
    with pytest.raises(TypeError, match="all bf16 or all fp32"):
        q = torch.zeros(2, 8, 2, 16)
        kv = torch.zeros(2, 8, 2, 16, dtype=torch.bfloat16)
        tflash._check_cuda(q, kv, kv, None, None)
