"""The hand-written CUDA kernels K1-K6 against their plain twins, on the card.

Marked ``cuda``; skips on a host without a CUDA device (the CPU suite runs the
plain twins against JAX in tests/test_torch_fused_attention.py,
tests/test_torch_decode_attention.py, tests/test_torch_flash_attention.py and
tests/test_torch_fused_mlp.py). Run on a GPU host with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``.
Tolerance: bf16 atol = rtol = 2e-2 for K1-K3, K5 and K6 and 3e-2 for K4 (the
int8 cache; the JAX int8 kernel test's bar). K5's cases check which of its
three bf16 bodies the kernel reports it ran (``launches_sm90``,
``launches_decode``) against the rule ``k5_body`` states. Every kernel test runs in bf16 and in fp32 (an
fp32 model: its ``dtype`` parameter); the fp32 bodies are held to their twins
at atol = rtol = 1e-4 with TF32 off (the twins' products in full fp32; both
sides differ only in the order of fp32 sums) and counted in ``launches_f32``
(``launches_int8_f32`` for K4). The default ``tiny_config`` model, built on
the card with no dtype (fp32), and TextLM's text-only module in fp32 must
give the tokens of the same weights on the CPU.
"""

import pytest
import torch

from eilev_tpu_torch.ops import decode_attention as tda
from eilev_tpu_torch.ops import flash_attention as tfl
from eilev_tpu_torch.ops import fused_attention as tfa
from eilev_tpu_torch.ops import fused_mlp as tfm

pytestmark = pytest.mark.cuda

# every bf16 and fp32 case at its dtype's tolerance
DTYPES = [torch.bfloat16, torch.float32]
TOL = {torch.bfloat16: dict(atol=2e-2, rtol=2e-2), torch.float32: dict(atol=1e-4, rtol=1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, s, nh, hd, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(b, s, 3 * nh * hd, device=device, generator=g).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,nh,hd", [(3, 9, 2, 8), (2, 257, 2, 88), (8, 257, 16, 88), (2, 100, 3, 128),
                                       (2, 600, 4, 64)])
def test_k1_kernel_matches_plain(cuda, b, s, nh, hd, dtype):
    qkv = _qkv(b, s, nh, hd, cuda, seed=s).to(dtype)
    f32 = dtype == torch.float32
    before = (tfa.packed_qkv_attention.launches, tfa.packed_qkv_attention.launches_f32)
    out = tfa.packed_qkv_attention(qkv, nh, hd)
    torch.cuda.synchronize()
    assert (tfa.packed_qkv_attention.launches, tfa.packed_qkv_attention.launches_f32) == (
        before[0] + 1, before[1] + f32)
    assert out.dtype == dtype
    ref = tfa.packed_qkv_attention_reference(qkv, nh, hd, hd**-0.5)
    torch.testing.assert_close(out, ref, **TOL[dtype])


@pytest.mark.parametrize("s", [1, 17, 257, tfa.K1_MAX_SEQ, 385, 577, 1025, 2048])
@pytest.mark.parametrize("hd", [88, 128])
def test_k1_takes_whole_rows_up_to_its_limit(cuda, s, hd):
    """bf16, odd batch. Whole score rows in registers up to K1_MAX_SEQ (S = 1,
    17, the ViT's 257 and the largest S the resident design takes: K and V of
    a head in shared memory); past it the two-pass body with no causal
    frontier (577: a 336^2 ViT), with K1's rounding points. Both are counted
    in launches_sm90."""
    qkv = _qkv(3, s, 2, hd, cuda, seed=s)
    assert tfa.packed_body(qkv, causal=False) == ("sm90_rows" if s <= tfa.K1_MAX_SEQ else "sm90")
    before = (tfa.packed_qkv_attention.launches, tfa.packed_qkv_attention.launches_sm90)
    out = tfa.packed_qkv_attention(qkv, 2, hd)
    torch.cuda.synchronize()
    assert (tfa.packed_qkv_attention.launches, tfa.packed_qkv_attention.launches_sm90) == (
        before[0] + 1, before[1] + 1)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, tfa.packed_qkv_attention_reference(qkv, 2, hd, hd**-0.5),
                               atol=2e-2, rtol=2e-2)


def test_packed_kernels_refuse_sequences_past_their_limit(cuda):
    """The limit is the fp32 body's grid, kept for both dtypes: 65,535 query
    tiles of 128."""
    s = 65535 * 128 + 1
    with pytest.raises(ValueError, match="positions"):
        tfa.packed_qkv_attention(torch.zeros(1, s, 3 * 8, dtype=torch.bfloat16, device=cuda), 1, 8)
    with pytest.raises(ValueError, match="positions"):
        tfa.packed_qkv_causal_attention(
            torch.zeros(1, s, 3 * 8, dtype=torch.bfloat16, device=cuda), 1, 8,
            torch.ones(1, s, dtype=torch.int32, device=cuda))


# (causal, B, S, heads, hd, left padding of row 0): bf16 past OPT's 2,048
# positions, on the two-pass body; the chip_smoke shapes (K2 at 4,096 x 32 x
# 80 with 100 padded keys, K1 at 3,072 x 16 x 88) and small ones with ragged
# tiles
TWO_PASS_CASES = [(True, 1, 2100, 2, 8, 420), (True, 2, 2049, 3, 128, 0), (True, 1, 4096, 32, 80, 100),
                  (True, 2, 2200, 4, 80, 517), (False, 1, 3072, 16, 88, 0), (False, 2, 2081, 2, 64, 0)]


@pytest.mark.parametrize("causal,b,s,nh,hd,pad", TWO_PASS_CASES)
def test_two_pass_body_matches_plain(cuda, causal, b, s, nh, hd, pad):
    """bf16 at long S: within 2e-2 of the twin, and the left-padded query
    rows (no kept key) NaN in both, as in JAX."""
    qkv = _qkv(b, s, nh, hd, cuda, seed=s)
    assert tfa.packed_body(qkv, causal) == "sm90"
    fn = tfa.packed_qkv_causal_attention if causal else tfa.packed_qkv_attention
    before = fn.launches_sm90
    if causal:
        mask = torch.ones(b, s, dtype=torch.int32, device=cuda)
        mask[0, :pad] = 0
        out = fn(qkv, nh, hd, mask)
        ref = tfa.packed_qkv_causal_attention_reference(qkv, nh, hd, mask, hd**-0.5)
    else:
        out = fn(qkv, nh, hd)
        ref = tfa.packed_qkv_attention_reference(qkv, nh, hd, hd**-0.5)
    torch.cuda.synchronize()
    assert fn.launches_sm90 == before + 1
    nan_rows = torch.isnan(ref).any(-1)
    assert torch.equal(torch.isnan(out).any(-1), nan_rows) and int(nan_rows.sum()) == pad
    torch.testing.assert_close(out, ref, equal_nan=True, atol=2e-2, rtol=2e-2)


# the port's head dims (64, OPT's 80, the ViT's 88, 128) and lengths at the
# edges of the bodies' 64-row warpgroup tiles, 128-key tiles and capacities
GRID_DIMS = [64, 80, 88, 128]
GRID_LENGTHS = [1, 64, 65, 257, 384, 385, 2048, 2049, 4096]


@pytest.mark.parametrize("s", GRID_LENGTHS)
@pytest.mark.parametrize("hd", GRID_DIMS)
def test_k1_sm90_bodies_at_every_head_dim_and_length(cuda, hd, s):
    """bf16 K1, B = 3 (batch rows past S must read as zeros, not as the next
    row), against the twin at 2e-2 on the body the rule names, counted once
    in launches_sm90."""
    qkv = _qkv(3, s, 2, hd, cuda, seed=hd + s)
    fn = tfa.packed_qkv_attention
    assert tfa.packed_body(qkv, causal=False) == ("sm90_rows" if s <= tfa.K1_MAX_SEQ else "sm90")
    before = (fn.launches, fn.launches_sm90)
    out = fn(qkv, 2, hd)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_sm90) == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, tfa.packed_qkv_attention_reference(qkv, 2, hd, hd**-0.5),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("padding", ["none", "right", "left", "row_masked"])
@pytest.mark.parametrize("s", GRID_LENGTHS)
@pytest.mark.parametrize("hd", GRID_DIMS)
def test_k2_sm90_body_at_every_head_dim_and_length(cuda, hd, s, padding):
    """bf16 K2, B = 3: no padding, row 1 right-padded by S // 4, row 0
    left-padded by max(1, S // 5) (its first query rows keep no key), or row 2
    with no kept key at all; NaN in exactly the twin's positions, the rest
    within 2e-2, counted once in launches_sm90."""
    qkv = _qkv(3, s, 2, hd, cuda, seed=hd * s)
    mask = torch.ones(3, s, dtype=torch.int32, device=cuda)
    if padding == "right":
        mask[1, s - s // 4:] = 0
    elif padding == "left":
        mask[0, : max(1, s // 5)] = 0
    elif padding == "row_masked":
        mask[2] = 0
    fn = tfa.packed_qkv_causal_attention
    assert tfa.packed_body(qkv, causal=True) == "sm90"
    before = (fn.launches, fn.launches_sm90)
    out = fn(qkv, 2, hd, mask)
    ref = tfa.packed_qkv_causal_attention_reference(qkv, 2, hd, mask, hd**-0.5)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_sm90) == (before[0] + 1, before[1] + 1)
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(out), nan)
    if padding == "left":
        assert nan[0, : max(1, s // 5)].all()
    elif padding == "row_masked":
        assert nan[2].all()
    else:
        assert not nan.any()
    torch.testing.assert_close(out, ref, equal_nan=True, atol=2e-2, rtol=2e-2)


# (dtype, B, S, heads, hd): every shape in bf16 and fp32, and S = 2,100
K2_SHAPES = [(2, 24, 2, 8), (2, 130, 2, 80), (2, 766, 32, 80), (2, 2048, 4, 80), (1, 2048, 2, 128)]
K2_CASES = [(dt, *shape) for dt in DTYPES for shape in K2_SHAPES] + [
    (torch.float32, 1, 2100, 2, 128), (torch.bfloat16, 1, 2100, 2, 128)]


@pytest.mark.parametrize("padding", ["none", "left", "right"])
@pytest.mark.parametrize("dtype,b,s,nh,hd", K2_CASES)
def test_k2_kernel_matches_plain(cuda, dtype, b, s, nh, hd, padding):
    qkv = _qkv(b, s, nh, hd, cuda, seed=1).to(dtype)
    f32 = dtype == torch.float32
    mask = torch.ones(b, s, dtype=torch.int32, device=cuda)
    if padding == "left":
        mask[0, : s // 5] = 0
    elif padding == "right":
        mask[-1, s - s // 4 :] = 0
    before = (tfa.packed_qkv_causal_attention.launches, tfa.packed_qkv_causal_attention.launches_f32)
    out = tfa.packed_qkv_causal_attention(qkv, nh, hd, mask)
    torch.cuda.synchronize()
    assert (tfa.packed_qkv_causal_attention.launches, tfa.packed_qkv_causal_attention.launches_f32) == (
        before[0] + 1, before[1] + f32)
    ref = tfa.packed_qkv_causal_attention_reference(qkv, nh, hd, mask, hd**-0.5)
    if padding == "left" and f32:  # finfo(float32).min is finite: the uniform average of every V row
        v_mean = qkv.view(b, s, 3, nh * hd)[0, :, 2].mean(0)
        torch.testing.assert_close(out[0, : s // 5], v_mean.expand(s // 5, -1), **TOL[dtype])
    elif padding == "left":  # fully masked query rows are NaN in bf16, in both
        assert torch.isnan(out[0, : s // 5]).all() and torch.isnan(ref[0, : s // 5]).all()
        assert torch.isfinite(out[0, s // 5 :]).all()
    torch.testing.assert_close(out, ref, equal_nan=True, **TOL[dtype])


def test_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(TypeError, match="bf16 or fp32"):
        tfa.packed_qkv_attention(_qkv(1, 8, 2, 8, cuda).half(), 2, 8)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.packed_qkv_attention(_qkv(1, 8, 2, 12, cuda), 2, 12)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.packed_qkv_attention(_qkv(2, 8, 2, 8, cuda).transpose(0, 1), 2, 8)


def _cache(n_layers, b, s, kvh, hd, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    k = torch.randn(n_layers, b, s, kvh, hd, device=device, generator=g).to(torch.bfloat16)
    v = torch.randn(n_layers, b, s, kvh, hd, device=device, generator=g).to(torch.bfloat16)
    return k, v, g


def _decode_mask(b, s, device, kind):
    mask = torch.ones(b, s, dtype=torch.int32, device=device)
    if kind == "mid-decode":  # the unfilled tail of the cache
        mask[:, s - s // 8 :] = 0
    elif kind == "left-padded":
        mask[0, : s // 5] = 0
    elif kind == "fully-masked-row":
        mask[-1] = 0
    return mask


# (L, B, S, heads, kv_heads, hd, scale_query): OPT shapes (groups of 1, q-side
# scale) and GQA shapes (score-side scale); S is a multiple of no tile size
DECODE_SHAPES = [
    (3, 2, 37, 4, 4, 64, True),
    (4, 4, 798, 32, 32, 80, True),
    (2, 1, 131, 2, 2, 128, True),
    (2, 2, 2048, 32, 8, 128, False),
    (2, 3, 333, 8, 2, 80, False),
]


# K3's shapes: DECODE_SHAPES and those chip_smoke checks, where the written
# rule (ops/decode_attention.k3_split) gives the bf16 cache the split: the
# narration's decode at batch 1 (a cluster of 8), the text LM's (B = 1,
# 2,048 slots, 32 x 128, a cluster of 8), S = 1 and 5; (4, 4, 798, ...) in
# DECODE_SHAPES is the narration's batch 4, which keeps one block a (head,
# row), as does the text LM's beam-4 (4 rows of 2,048 slots, 32 x 128)
K3_SHAPES = DECODE_SHAPES + [
    (2, 1, 798, 32, 32, 80, True),
    (2, 1, 2048, 32, 32, 128, False),
    (2, 1, 1, 32, 32, 128, False),
    (2, 1, 5, 32, 32, 128, False),
    (2, 4, 2048, 32, 32, 128, False),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["full", "mid-decode", "left-padded", "fully-masked-row"])
@pytest.mark.parametrize("n_layers,b,s,nh,kvh,hd,scale_query", K3_SHAPES)
def test_k3_kernel_matches_plain(cuda, n_layers, b, s, nh, kvh, hd, scale_query, kind, dtype):
    k, v, g = _cache(n_layers, b, s, kvh, hd, cuda, seed=s)
    k, v = k.to(dtype), v.to(dtype)
    q = torch.randn(b, nh * hd, device=cuda, generator=g).to(dtype)
    mask = _decode_mask(b, s, cuda, kind)
    kw = dict(num_heads=nh, head_dim=hd, kv_heads=kvh, scale_query=scale_query)
    kb, vb = k.view(n_layers, b, s, -1), v.view(n_layers, b, s, -1)
    counter = "launches_f32" if dtype == torch.float32 else "launches_bf16"
    for layer in (0, n_layers - 1):
        before = getattr(tda.decode_attention_stacked, counter)
        out = tda.decode_attention_stacked(q, kb, vb, mask, layer, **kw)
        torch.cuda.synchronize()
        assert getattr(tda.decode_attention_stacked, counter) == before + 1
        ref = tda.decode_attention_stacked_reference(q, kb, vb, mask, layer, **kw)
        if kind == "fully-masked-row" and dtype == torch.float32:
            # finite in fp32: the uniform average of every slot's V row
            want = v[layer, -1].mean(0).repeat_interleave(nh // kvh, dim=0).reshape(-1)
            torch.testing.assert_close(out[-1], want, **TOL[dtype])
        elif kind == "fully-masked-row":  # NaN in bf16, in both
            assert torch.isnan(out[-1]).all() and torch.isnan(ref[-1]).all()
        torch.testing.assert_close(out, ref, equal_nan=True, **TOL[dtype])


# K4's shapes: K3's, the narration's decode at batch 1 (a cluster of 8 at
# D = 80), the text LM's decode (B = 1, 2,048 slots, 32 x 128, a cluster of
# 8), S = 1 and 5 (fewer slots than a cluster's chunks), and 4,000 slots (500
# a block: two steps of each lane's rows)
INT8_SHAPES = DECODE_SHAPES + [
    (1, 1, 798, 32, 32, 80, True),
    (1, 1, 2048, 32, 32, 128, False),
    (2, 1, 1, 32, 32, 128, False),
    (2, 1, 5, 32, 32, 128, False),
    (2, 1, 4000, 32, 32, 128, False),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["full", "mid-decode", "left-padded", "fully-masked-row"])
@pytest.mark.parametrize("n_layers,b,s,nh,kvh,hd,scale_query", INT8_SHAPES)
def test_k4_kernel_matches_plain(cuda, n_layers, b, s, nh, kvh, hd, scale_query, kind, dtype):
    """An int8 cache with bf16 scales under a bf16 or an fp32 model (query,
    output and dequantized values in the model dtype)."""
    k, v, g = _cache(n_layers, b, s, kvh, hd, cuda, seed=s + 1)
    k, v = k.to(dtype), v.to(dtype)
    q = torch.randn(b, nh * hd, device=cuda, generator=g).to(dtype)
    f32 = dtype == torch.float32
    k8, ks = tda.quantize_kv(k)
    v8, vs = tda.quantize_kv(v)
    k8, v8 = k8.view(n_layers, b, s, -1), v8.view(n_layers, b, s, -1)
    mask = _decode_mask(b, s, cuda, kind)
    kw = dict(num_heads=nh, head_dim=hd, kv_heads=kvh, scale_query=scale_query)
    layer = n_layers // 2
    before = (tda.decode_attention_stacked.launches_int8, tda.decode_attention_stacked.launches_int8_f32)
    out = tda.decode_attention_stacked(q, k8, v8, mask, layer, k_scale=ks, v_scale=vs, **kw)
    torch.cuda.synchronize()
    assert (tda.decode_attention_stacked.launches_int8, tda.decode_attention_stacked.launches_int8_f32) == (
        before[0] + 1, before[1] + f32)
    assert out.dtype == dtype
    ref = tda.decode_attention_stacked_reference(q, k8, v8, mask, layer, k_scale=ks, v_scale=vs, **kw)
    if kind == "fully-masked-row" and f32:  # finite in fp32: the uniform average
        assert torch.isfinite(out[-1]).all()
    elif kind == "fully-masked-row":  # NaN in bf16, in both
        assert torch.isnan(out[-1]).all() and torch.isnan(ref[-1]).all()
    tol = TOL[dtype] if f32 else dict(atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(out, ref, equal_nan=True, **tol)
    if f32:
        return
    # and against dequantize_kv + the bf16 twin, as chip_smoke holds it
    kd = tda.dequantize_kv(k8.view(k.shape), ks).view(n_layers, b, s, -1)
    vd = tda.dequantize_kv(v8.view(v.shape), vs).view(n_layers, b, s, -1)
    ref_bf16 = tda.decode_attention_stacked_reference(q, kd, vd, mask, layer, **kw)
    torch.testing.assert_close(out, ref_bf16, atol=3e-2, rtol=3e-2, equal_nan=True)


# The fp32 body (an fp32 model over an fp32 or int8 cache) at the edges of
# its lanes, its staging and its rare path: (L, B, S, heads, kv_heads, hd,
# scale_query, mask, layer). Head dims 8 (one lane a row), 24, 64, 80 and 128
# (every lane mapping, 8 values a lane), grouped-query heads (4 and 2 a kv
# head) at both scale sides, S a multiple of neither the cluster nor 32,
# staged and streamed K and V (ops/decode_attention.f32_staged), holes, dead
# prefixes longer than half the cache, and fully masked rows (the uniform
# average of every V row)
F32_EDGE_CASES = {
    "d64_gqa_q_side": (3, 2, 1001, 32, 8, 64, True, "holes", 2),
    "d128_gqa_score_side": (2, 1, 2047, 32, 8, 128, False, "mid-decode", 1),
    "d128_long": (2, 1, 4001, 32, 8, 128, False, "holes", 1),
    "d80_dead_prefix": (2, 4, 2048, 32, 32, 80, True, "dead-prefix", 1),
    "d80_staged": (2, 1, 798, 32, 32, 80, True, "holes", 1),
    "d24": (2, 2, 300, 6, 3, 24, True, "left-padded", 0),
    "d8": (2, 3, 37, 4, 2, 8, False, "fully-masked-row", 1),
}
F32_DECODE_EDGES = [(name, cache) for name, case in F32_EDGE_CASES.items() for cache in ("fp32", "int8")
                    if cache == "fp32" or case[5] % 16 == 0]


def _f32_edge_mask(b, s, device, kind):
    mask = torch.ones(b, s, dtype=torch.int32, device=device)
    if kind == "holes":  # every third slot, and at B > 1 the last row fully masked
        mask[:, ::3] = 0
        if b > 1:
            mask[-1] = 0
    elif kind == "mid-decode":
        mask[:, s - s // 8:] = 0
    elif kind == "left-padded":
        mask[0, : s // 5] = 0
    elif kind == "fully-masked-row":
        mask[-1] = 0
    elif kind == "dead-prefix":  # live windows behind dead prefixes of 1,100 and 1,500 slots, an empty row
        mask.zero_()
        mask[0, 1100:] = 1
        mask[0, 1100::7] = 0
        mask[1, 1500:1600] = 1
        mask[3, 2:] = 1
        mask[3, 2::10] = 0
    return mask


@pytest.mark.parametrize("name,cache", F32_DECODE_EDGES)
def test_f32_decode_body_at_its_edges(cuda, name, cache):
    n_layers, b, s, nh, kvh, hd, scale_query, kind, layer = F32_EDGE_CASES[name]
    k, v, g = _cache(n_layers, b, s, kvh, hd, cuda, seed=s + hd)
    k, v = k.float(), v.float()
    q = torch.randn(b, nh * hd, device=cuda, generator=g)
    mask = _f32_edge_mask(b, s, cuda, kind)
    kw = dict(num_heads=nh, head_dim=hd, kv_heads=kvh, scale_query=scale_query)
    fn = tda.decode_attention_stacked
    if cache == "int8":
        k8, ks = tda.quantize_kv(k)
        v8, vs = tda.quantize_kv(v)
        args = (k8.view(n_layers, b, s, -1), v8.view(n_layers, b, s, -1))
        kw.update(k_scale=ks, v_scale=vs)
        v_rows = tda.dequantize_kv(v8, vs, torch.float32)
        before = (fn.launches_int8, fn.launches_int8_f32, fn.launches_f32)
        step = (1, 1, 0)
    else:
        args = (k.view(n_layers, b, s, -1), v.view(n_layers, b, s, -1))
        v_rows = v
        before = (fn.launches_int8, fn.launches_int8_f32, fn.launches_f32)
        step = (0, 0, 1)
    out = fn(q, *args, mask, layer, **kw)
    torch.cuda.synchronize()
    assert (fn.launches_int8, fn.launches_int8_f32, fn.launches_f32) == tuple(x + d for x, d in zip(before, step))
    ref = tda.decode_attention_stacked_reference(q, *args, mask, layer, **kw)
    torch.testing.assert_close(out, ref, **TOL[torch.float32])
    for r in range(b):
        if not mask[r].any():  # finite in fp32: the uniform average of every slot's V row
            want = v_rows[layer, r].mean(0).repeat_interleave(nh // kvh, dim=0).reshape(-1)
            torch.testing.assert_close(out[r], want, **TOL[torch.float32])


def test_decode_kernel_refuses_what_it_does_not_take(cuda):
    k, v, g = _cache(2, 1, 40, 2, 16, cuda, seed=0)
    q = torch.randn(1, 32, device=cuda, generator=g).to(torch.bfloat16)
    mask = torch.ones(1, 40, dtype=torch.int32, device=cuda)
    kw = dict(num_heads=2, head_dim=16)
    kb = k.view(2, 1, 40, -1)
    with pytest.raises(TypeError, match="bf16 or fp32"):  # an fp16 cache
        tda.decode_attention_stacked(q.half(), kb.half(), kb.half(), mask, 0, **kw)
    with pytest.raises(TypeError, match="bf16 or fp32"):  # an fp32 query over a bf16 cache
        tda.decode_attention_stacked(q.float(), kb, kb, mask, 0, **kw)
    k8, ks = tda.quantize_kv(k[..., :8].contiguous())
    with pytest.raises(ValueError, match="head_dim"):  # int8 rows of 8 bytes: not 16-byte aligned
        tda.decode_attention_stacked(
            q[:, :16].contiguous(), k8.view(2, 1, 40, -1), k8.view(2, 1, 40, -1), mask, 0,
            num_heads=2, head_dim=8, k_scale=ks, v_scale=ks,
        )
    # the one-block bf16 body (2 * B * H > 132: 4 rows x 34 heads) keeps all
    # 60k scores in one block, above 227 KB of shared memory; the split (B * H
    # = 2) spreads them over a cluster of 8
    s_big = 60_000
    big = torch.zeros(1, 4, s_big, 34 * 16, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        tda.decode_attention_stacked(
            torch.zeros(4, 34 * 16, dtype=torch.bfloat16, device=cuda), big, big,
            torch.ones(4, s_big, dtype=torch.int32, device=cuda), 0, num_heads=34, head_dim=16,
        )
    del big
    big = torch.zeros(1, 1, s_big, 32, dtype=torch.bfloat16, device=cuda)
    out = tda.decode_attention_stacked(q, big, big, torch.ones(1, s_big, dtype=torch.int32, device=cuda), 0, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    # int8: a cluster of 8 blocks (B * H = 2) splits the scores, so the limit
    # is 8 blocks' worth: 60k slots run, 480k do not
    for s_int8, fits in ((60_000, True), (480_000, False)):
        big8 = torch.zeros(1, 1, s_int8, 32, dtype=torch.int8, device=cuda)
        sc = torch.ones(1, 1, s_int8, 2, dtype=torch.bfloat16, device=cuda)
        args = (q, big8, big8, torch.ones(1, s_int8, dtype=torch.int32, device=cuda), 0)
        assert (tda.split_smem_bytes(s_int8, 16, tda.cluster_size(1, 2, s_int8)) <= tda.SMEM_LIMIT) is fits
        if fits:
            out = tda.decode_attention_stacked(*args, k_scale=sc, v_scale=sc, **kw)
            torch.cuda.synchronize()
            assert torch.isfinite(out).all()
        else:
            with pytest.raises(ValueError, match="shared memory"):
                tda.decode_attention_stacked(*args, k_scale=sc, v_scale=sc, **kw)
    strided_q = torch.randn(1, 64, device=cuda, generator=g).to(torch.bfloat16)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tda.decode_attention_stacked(strided_q, kb, kb, mask, 0, **kw)


# (B, S, L, heads, kv_heads, hd, causal, q_offset, scale_query_first, mask,
# bias): the LLaMA prefill into a padded cache (score-side scale, GQA, left
# padding), the T5 form (bias + padding, no scale), Q-Former cross attention,
# the ViT shape with hd 88, a q-side scale with q_offset > 0, and lengths that
# are multiples of no tile size
FLASH_CASES = [
    (2, 200, 256, 4, 4, 128, True, 0, False, "cache", False),
    (3, 130, 300, 8, 2, 128, True, 0, False, "left-padded-cache", False),
    (2, 90, 90, 4, 4, 64, False, 0, None, "right", True),
    (2, 32, 2056, 12, 12, 64, False, 0, False, "right", False),
    (2, 257, 257, 4, 4, 88, False, 0, False, None, False),
    (2, 70, 200, 4, 4, 80, True, 130, True, None, False),
    (1, 1984, 2048, 8, 8, 128, True, 0, False, "cache", False),
    # the Hopper body (hd 128, no bias): S and L multiples of no tile, a
    # left padding longer than a 128-key tile, q_offset > 0 with a q-side
    # scale, GQA 4 over 1, no mask, and not causal
    (2, 300, 333, 8, 2, 128, True, 0, False, "left-padded-150", False),
    (2, 70, 333, 4, 4, 128, True, 200, True, None, False),
    (2, 150, 270, 4, 1, 128, True, 0, False, "cache", False),
    (3, 257, 257, 4, 4, 128, False, 0, False, None, False),
    (2, 200, 389, 4, 2, 128, False, 0, False, "right", False),
    # hd 128 with a bias: the mma.sync body
    (2, 90, 90, 4, 4, 128, False, 0, None, "right", True),
]


K5_COUNTERS = ("launches", "launches_sm90", "launches_decode", "launches_f32")


def _k5_counted(body, call):
    """One K5 call; the launch counters must say it ran ``body`` (k5_body's
    name) and nothing else."""
    before = [getattr(tfl.flash_attention, c) for c in K5_COUNTERS]
    out = call()
    torch.cuda.synchronize()
    after = [getattr(tfl.flash_attention, c) for c in K5_COUNTERS]
    assert after == [before[0] + 1, before[1] + (body == "sm90"), before[2] + (body == "decode"),
                     before[3] + (body == "f32")], (body, before, after)
    return out


def _padded_bias(nh, s, l, device, g, scale=2.0):
    """A bf16 (nh, s, l) bias as the T5 module builds it: a view of an (nh,
    s, l rounded up to 8) buffer (models/t5.py: compute_bias)."""
    buf = (torch.randn(nh, s, -(-l // 8) * 8, device=device, generator=g) * scale).to(torch.bfloat16)
    return buf[:, :, :l]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,l,nh,kvh,hd,causal,q_offset,sqf,mask,bias", FLASH_CASES)
def test_k5_kernel_matches_plain(cuda, b, s, l, nh, kvh, hd, causal, q_offset, sqf, mask, bias, dtype):
    g = torch.Generator(device=cuda).manual_seed(s + l)
    q = torch.randn(b, s, nh, hd, device=cuda, generator=g).to(dtype)
    k = torch.randn(b, l, kvh, hd, device=cuda, generator=g).to(dtype)
    v = torch.randn(b, l, kvh, hd, device=cuda, generator=g).to(dtype)
    f32 = dtype == torch.float32
    pm = None
    padded = {"left-padded-cache": s // 3, "left-padded-150": 150}.get(mask, 0)
    if mask is not None:
        pm = torch.ones(b, l, dtype=torch.int32, device=cuda)
        if mask in ("cache", "left-padded-cache", "left-padded-150"):
            pm[:, s:] = 0  # the unfilled cache tail
        pm[0, :padded] = 0
        if mask == "right":
            pm[-1, l - l // 5 :] = 0
    bias_t = (torch.randn(nh, s, l, device=cuda, generator=g) * 2.0) if bias else None
    scale = None if sqf is None else hd**-0.5
    kw = dict(padding_mask=pm, bias=bias_t, causal=causal, q_offset=q_offset,
              scale=scale, scale_query_first=bool(sqf))
    body = tfl.k5_body(q, k, v, bias_t)
    # an fp32 bias takes the mma.sync body at these query counts
    assert body == ("f32" if f32 else "sm90" if hd in (64, 128) and not bias else "mma")
    out = _k5_counted(body, lambda: tfl.flash_attention(q, k, v, **kw))
    ref = tfl.flash_attention_reference(q, k, v, **kw)
    if padded:  # fully masked rows are exactly 0, in both
        assert (out[0, :padded] == 0).all() and (ref[0, :padded] == 0).all()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, **TOL[dtype])


@pytest.mark.parametrize("hd", [64, 128])
def test_k5_reads_a_cache_layer_in_place(cuda, hd):
    """k, v as a layer slice of the stacked cache: strided rows, no copy (hd
    128 and 64 both through the Hopper body's tensor maps)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    kb = torch.randn(3, 2, 160, 4, hd, device=cuda, generator=g).to(torch.bfloat16)
    vb = torch.randn(3, 2, 160, 4, hd, device=cuda, generator=g).to(torch.bfloat16)
    q = torch.randn(2, 100, 8, hd, device=cuda, generator=g).to(torch.bfloat16)
    pm = torch.zeros(2, 160, dtype=torch.int32, device=cuda)
    pm[:, :100] = 1
    kw = dict(padding_mask=pm, causal=True, scale=hd**-0.5)
    assert tfl.k5_body(q, kb[1], vb[1]) == "sm90"
    before = tfl.flash_attention.launches_sm90
    out = tfl.flash_attention(q, kb[1], vb[1], **kw)
    torch.cuda.synchronize()
    assert tfl.flash_attention.launches_sm90 == before + 1
    ref = tfl.flash_attention_reference(q, kb[1].contiguous(), vb[1].contiguous(), **kw)
    torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2)


# K5's bias form at the flan-t5-xl shapes of the T5 path (32 heads x 64, no
# scale): the encoder at the narration's 766 tokens (B 1, and B 4 with a
# padded row), the decoder's cached step (one query over a layer slice of the
# 33-slot stacked cache, the (H, 1, L) bias, the filled-slot mask expanded to
# (B, L)) and its cross step (one query over a layer slice of the stacked
# encoder K/V, padded keys)
T5_SHAPES = ["encoder_b1", "encoder_b4_padded", "decoder_self", "decoder_cross"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", T5_SHAPES)
def test_k5_at_the_flan_t5_xl_shapes(cuda, name, dtype):
    g = torch.Generator(device=cuda).manual_seed(len(name))
    nh, hd, b = 32, 64, (1 if name == "encoder_b1" else 4)
    q = torch.randn(b, 766 if name.startswith("encoder") else 1, nh, hd, device=cuda, generator=g).to(dtype)
    bias = pm = None
    if name.startswith("encoder"):
        k = torch.randn(b, 766, nh, hd, device=cuda, generator=g).to(dtype)
        v = torch.randn(b, 766, nh, hd, device=cuda, generator=g).to(dtype)
        bias = _padded_bias(nh, 766, 766, cuda, g, scale=1.0).to(dtype)  # the module's layout
        pm = torch.ones(b, 766, dtype=torch.int32, device=cuda)
        pm[-1, 700:] = 0
    elif name == "decoder_self":
        kb = torch.randn(3, b, 33, nh, hd, device=cuda, generator=g).to(dtype)
        k, v = kb[1], kb[2]
        bias = _padded_bias(nh, 1, 33, cuda, g, scale=1.0).to(dtype)
        pm = (torch.arange(33, device=cuda) < 13).to(torch.int32)[None].expand(b, 33)
    else:
        kb = torch.randn(3, b, 766, nh, hd, device=cuda, generator=g).to(dtype)
        k, v = kb[0], kb[2]
        pm = torch.ones(b, 766, dtype=torch.int32, device=cuda)
        pm[1, 500:] = 0
    body = tfl.k5_body(q, k, v, bias)
    assert body == ("f32" if dtype == torch.float32 else "sm90" if name.startswith("encoder") else "decode")
    out = _k5_counted(body, lambda: tfl.flash_attention(q, k, v, padding_mask=pm, bias=bias))
    ref = tfl.flash_attention_reference(q, k.contiguous(), v.contiguous(), padding_mask=pm, bias=bias)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, **TOL[dtype])


# K5's decode body (one to four query rows, a GEMV over the key tiles):
# (B, S, L, heads, kv heads, hd, bias, mask, causal, q_offset, scale) at the
# T5 decoder's and the serving engine's steps and ragged key counts (1, 33,
# 127, 129, 766, 832; 2,054: more tiles than a block's 8 warps), the
# filled-slot mask expanded to (B, L), dead prefixes and a row with no kept
# key (exactly 0), a bool and an int64 mask read in place, an fp32 bias, GQA,
# head dims 80 and 128, a q-side scale, causal with q_offset, 4 query rows
DECODE_CASES = {
    "self_l1": (4, 1, 1, 32, 32, 64, "bf16", "filled", False, 0, None),
    "self_l33": (4, 1, 33, 32, 32, 64, "bf16", "filled", False, 0, None),
    "cross_l127": (4, 1, 127, 32, 32, 64, None, "right", False, 0, None),
    "cross_l129": (4, 1, 129, 32, 32, 64, None, "right", False, 0, None),
    "cross_l766": (4, 1, 766, 32, 32, 64, None, "right", False, 0, None),
    "engine_self_l64_dead_prefixes": (4, 1, 64, 32, 32, 64, "bf16", "dead-prefix", False, 0, None),
    "engine_cross_l832": (4, 1, 832, 32, 32, 64, None, "right", False, 0, None),
    "l2054_bool_mask": (2, 1, 2054, 8, 8, 64, None, "bool", False, 0, None),
    "int64_mask_fp32_bias": (3, 1, 300, 4, 4, 64, "fp32", "int64", False, 0, None),
    "gqa_hd128_score_scale": (2, 1, 700, 8, 2, 128, None, "right", False, 0, "score"),
    "hd80_q_scale_causal": (2, 3, 400, 4, 4, 80, "bf16", None, True, 250, "query"),
    "four_rows_causal": (2, 4, 333, 4, 4, 64, "bf16", "right", True, 100, None),
}


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_k5_decode_body_matches_plain(cuda, name):
    b, s, l, nh, kvh, hd, bias, mask, causal, q_offset, scale = DECODE_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(l + s)
    q = torch.randn(b, s, nh, hd, device=cuda, generator=g).to(torch.bfloat16)
    kv = torch.randn(2, 3, b, l, kvh, hd, device=cuda, generator=g).to(torch.bfloat16)
    k, v = kv[0, 1], kv[1, 2]  # layer slices of a stacked cache
    dead = []
    pm = None
    if mask == "filled":
        pm = (torch.arange(l, device=cuda) < max(1, l * 2 // 5)).to(torch.int32)[None].expand(b, l)
    elif mask is not None:
        pm = torch.ones(b, l, dtype=torch.int32, device=cuda)
        if mask == "dead-prefix":  # reused slots: dead prefixes, slots past the index, row 3 keeps nothing
            for r, start in enumerate((0, 9, 20)):
                pm[r, :start] = 0
            pm[:, 48:] = 0
            pm[3] = 0
            dead = [3]
        else:
            pm[-1, l - l // 3:] = 0
            pm[0] = 0  # a row with no kept key
            dead = [0]
        pm = {"bool": pm.bool(), "int64": pm.long()}.get(mask, pm)
    bias_t = None
    if bias == "bf16":
        bias_t = _padded_bias(nh, s, l, cuda, g)
    elif bias == "fp32":
        bias_t = torch.randn(nh, s, l, device=cuda, generator=g) * 2.0
    kw = dict(padding_mask=pm, bias=bias_t, causal=causal, q_offset=q_offset,
              scale=None if scale is None else hd**-0.5, scale_query_first=scale == "query")
    assert tfl.k5_body(q, k, v, bias_t) == "decode"
    out = _k5_counted("decode", lambda: tfl.flash_attention(q, k, v, **kw))
    ref = tfl.flash_attention_reference(q, k, v, **kw)
    for r in dead:  # a row that keeps no key is exactly 0, in both
        assert (out[r] == 0).all() and (ref[r] == 0).all()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2)


# K5's Hopper body at head dim 64: (B, S, L, heads, kv heads, bias, mask,
# causal, q_offset): the T5 encoder (the bf16 bias in padded rows; at B = 4 a
# padded row whose last key tiles hold no kept key, and a row with no kept
# key at all: exactly 0), VideoMAE, the Q-Former's self and cross
# attentions, ragged L (127, 129), causal with GQA and a q_offset
SM90_D64_CASES = {
    "t5_encoder_b1": (1, 766, 766, 32, 32, True, None, False, 0),
    "t5_encoder_b4_padded": (4, 766, 766, 32, 32, True, "padded", False, 0),
    "videomae": (2, 1568, 1568, 12, 12, False, None, False, 0),
    "qformer_self": (17, 32, 32, 12, 12, False, None, False, 0),
    "qformer_cross": (17, 32, 2056, 12, 12, False, "right", False, 0),
    "l127_bias": (2, 200, 127, 4, 4, True, "right", False, 0),
    "l129_bias": (2, 129, 129, 4, 4, True, "padded", False, 0),
    "gqa_causal_q_offset": (2, 300, 420, 8, 2, False, "right", True, 100),
}


@pytest.mark.parametrize("name", list(SM90_D64_CASES))
def test_k5_hopper_body_at_head_dim_64(cuda, name):
    b, s, l, nh, kvh, bias, mask, causal, q_offset = SM90_D64_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(s + l)
    q = torch.randn(b, s, nh, 64, device=cuda, generator=g).to(torch.bfloat16)
    k = torch.randn(b, l, kvh, 64, device=cuda, generator=g).to(torch.bfloat16)
    v = torch.randn(b, l, kvh, 64, device=cuda, generator=g).to(torch.bfloat16)
    pm, dead = None, []
    if mask is not None:
        pm = torch.ones(b, l, dtype=torch.int32, device=cuda)
        pm[-1, l - l // 3:] = 0
        if mask == "padded":  # the last row's tail; row 0 keeps nothing
            pm[-1, min(l - 1, 100):] = 0
            pm[0] = 0
            dead = [0]
    bias_t = _padded_bias(nh, s, l, cuda, g) if bias else None
    kw = dict(padding_mask=pm, bias=bias_t, causal=causal, q_offset=q_offset,
              scale=None if bias else 0.125)
    assert tfl.k5_body(q, k, v, bias_t) == "sm90"
    out = _k5_counted("sm90", lambda: tfl.flash_attention(q, k, v, **kw))
    ref = tfl.flash_attention_reference(q, k, v, **kw)
    for r in dead:
        assert (out[r] == 0).all() and (ref[r] == 0).all()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError, match="all bf16 or all fp32"):
        tfl.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="all bf16 or all fp32"):
        tfl.flash_attention(q.float(), q, q)
    odd = torch.zeros(1, 8, 2, 12, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tfl.flash_attention(odd, odd, odd)
    with pytest.raises(ValueError, match="strides"):
        t = q.transpose(1, 2)
        tfl.flash_attention(t, t, t)


def _f32_edge_case(name, device):
    """One call of the fp32 attention body (csrc/attention_f32.cu) at an edge
    of its tiling: (wrapper, call, twin call, rows that see no kept key and
    what they must be: "uniform" (the average of every V row) or "zero")."""
    g = torch.Generator(device=device).manual_seed(11)

    def rand(*shape):
        return torch.randn(*shape, device=device, generator=g)

    if name in ("k1_s257", "k2_s766_left_padded"):
        b, s, nh, hd = (2, 257, 16, 88) if name == "k1_s257" else (2, 766, 4, 80)
        qkv = rand(b, s, 3 * nh * hd)
        if name == "k1_s257":  # 17 16-row groups, the last holding one row; a 1-key tail tile
            return (tfa.packed_qkv_attention, lambda: tfa.packed_qkv_attention(qkv, nh, hd),
                    lambda: tfa.packed_qkv_attention_reference(qkv, nh, hd, hd**-0.5), None)
        mask = torch.ones(b, s, dtype=torch.int32, device=device)
        mask[0, :150] = 0
        v_mean = qkv.view(b, s, 3, nh * hd)[0, :, 2].mean(0)
        return (tfa.packed_qkv_causal_attention, lambda: tfa.packed_qkv_causal_attention(qkv, nh, hd, mask),
                lambda: tfa.packed_qkv_causal_attention_reference(qkv, nh, hd, mask, hd**-0.5),
                ((0, slice(0, 150)), v_mean))
    if name == "k5_1984_into_2048":
        q, k, v = rand(1, 1984, 4, 128), rand(1, 2048, 4, 128), rand(1, 2048, 4, 128)
        mask = torch.ones(1, 2048, dtype=torch.int32, device=device)
        mask[:, 1984:] = 0
        kw = dict(padding_mask=mask, causal=True, scale=128**-0.5)
        dead = None
    elif name == "d100":  # head dim a multiple of no 8-wide chunk
        q, k, v = rand(2, 257, 4, 100), rand(2, 257, 4, 100), rand(2, 257, 4, 100)
        kw = dict(scale=100**-0.5)
        dead = None
    elif name == "gqa4_bias_q_offset":  # 8 heads over 2, (H, S, L) bias, q_offset > 0, q-side scale
        q, k, v = rand(2, 70, 8, 80), rand(2, 200, 2, 80), rand(2, 200, 2, 80)
        mask = torch.ones(2, 200, dtype=torch.int32, device=device)
        mask[0, :140] = 0  # query rows 0-9 of row 0 see no kept key
        kw = dict(padding_mask=mask, bias=rand(8, 70, 200) * 2.0, causal=True, q_offset=130, scale=80**-0.5,
                  scale_query_first=True)
        dead = ((0, slice(0, 10)), "zero")
    else:  # "packed_3x33_4byte": views of a packed QKV, rows of 297 floats, k and v 4-byte aligned
        qkv = rand(2, 100, 3 * 3 * 33)
        q, k, v = qkv.view(2, 100, 3, 3, 33).unbind(2)
        assert k.data_ptr() % 16 and v.data_ptr() % 16
        mask = torch.ones(2, 100, dtype=torch.int32, device=device)
        mask[0, :30] = 0
        kw = dict(padding_mask=mask, causal=True, scale=33**-0.5)
        dead = ((0, slice(0, 30)), "zero")
    return (tfl.flash_attention, lambda: tfl.flash_attention(q, k, v, **kw),
            lambda: tfl.flash_attention_reference(q, k, v, **kw), dead)


F32_EDGES = ["k1_s257", "k2_s766_left_padded", "k5_1984_into_2048", "d100", "gqa4_bias_q_offset",
             "packed_3x33_4byte"]


@pytest.mark.parametrize("name", F32_EDGES)
def test_f32_attention_body_at_the_edges_of_its_tiling(cuda, name):
    """The fp32 body of K1, K2 and K5 (3xTF32 on the tensor cores, K/V by
    cp.async) against its twin at 1e-4 where its tiling is ragged: S and L
    multiples of no tile (257, 766, 1,984 queries into 2,048 slots), D = 100,
    grouped-query heads with a bias and q_offset > 0, k and v only 4-byte
    aligned (4-byte copies), and fully masked rows in both modes (uniform =
    1: the average of every V row; 0: exactly 0). Every call launches the
    fp32 body once."""
    fn, call, twin, dead = _f32_edge_case(name, cuda)
    before = fn.launches_f32
    out = call()
    torch.cuda.synchronize()
    assert fn.launches_f32 == before + 1
    ref = twin()
    if dead is not None:
        rows, want = dead
        if isinstance(want, str):
            assert (out[rows] == 0).all() and (ref[rows] == 0).all()
        else:
            torch.testing.assert_close(out[rows], want.expand_as(out[rows]), **TOL[torch.float32])
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, **TOL[torch.float32])


def _mlp_inputs(b, s, d, f, device, seed=0):
    """bf16 inputs at the scale a trained layer keeps: x N(0, 1), LayerNorm
    scale 1 + N(0, 0.1), weights N(0, 1 / fan_in), so every activation is of
    unit scale and atol = rtol = 2e-2 bites at any width. (With the JAX
    test's 0.1 weights at F = 6144 the outputs are ~24 wide, and one-ulp
    flips of the rounded activation, which kernel and twin may round
    differently after summing in another order, move near-zero outputs by
    ~0.04.)"""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, device=device, generator=g) * std + mean).to(torch.bfloat16)

    return (rand(b, s, d), rand(d, std=0.1, mean=1.0), rand(d, std=0.1), rand(d, f, std=d**-0.5),
            rand(f, std=0.1), rand(f, d, std=f**-0.5), rand(d, std=0.1))


# (dtype, B, S, D, F): every shape in bf16 and fp32, and widths the bf16
# body refuses (rows of 72 and 120 bytes) in fp32 only
K6_SHAPES = [(2, 257, 1408, 6144), (3, 17, 32, 64), (5, 100, 88, 200)]
K6_CASES = [(dt, *shape) for dt in DTYPES for shape in K6_SHAPES] + [(torch.float32, 5, 100, 36, 60)]


@pytest.mark.parametrize("dtype,b,s,d,f", K6_CASES)
def test_k6_kernel_matches_plain(cuda, dtype, b, s, d, f):
    args = [a.to(dtype) for a in _mlp_inputs(b, s, d, f, cuda)]
    before = (tfm.ln_mlp.launches, tfm.ln_mlp.launches_f32)
    out = tfm.ln_mlp(*args)
    torch.cuda.synchronize()
    assert (tfm.ln_mlp.launches, tfm.ln_mlp.launches_f32) == (before[0] + 1, before[1] + (dtype == torch.float32))
    assert out.shape == (b, s, d) and out.dtype == dtype
    torch.testing.assert_close(out, tfm.ln_mlp_reference(*args), **TOL[dtype])


# K6 at the edges of its tiling, (B, S, D, F, byte offset of w1 and w2 past
# a 256-byte boundary): the bf16 body's 128 x 256 (or x 128) tiles of
# 64-deep k over a persistent grid of one block an SM, the fp32 body's
# 128 x 128 tiles of 32-deep k. The ViT shape: M = 34,952 = 273 * 128 + 8,
# fc2's N = 1408 on 128-wide tiles, 6,576 fc1 tiles (~50 waves); M = 37
# (odd, fewer tiles than one wave); F = 200 (fc1's N ragged against 256,
# fc2's K ragged); D = 32 (fc1's K under one k tile) and 88 (not a multiple
# of it); 133 x 128 rows at F = 128 (133 fc1 tiles: one past a wave of 132);
# weights 16 bytes past a 128-byte boundary (TMA takes any 16-byte aligned
# base), and in fp32 4 bytes past (the fp32 body's 4-byte copies).
K6_EDGES = {
    "vit_rows_34952": (136, 257, 1408, 6144, 0),
    "odd_rows_37": (1, 37, 64, 128, 0),
    "f_200": (3, 50, 64, 200, 0),
    "d_32": (2, 40, 32, 96, 0),
    "d_88": (2, 70, 88, 256, 0),
    "tiles_133": (133, 128, 64, 128, 0),
    "weights_16_bytes_off": (2, 129, 128, 512, 16),
    "weights_4_bytes_off": (2, 129, 128, 512, 4),  # fp32 only: the bf16 body takes 16-byte bases
}
K6_EDGE_CASES = [(dt, name) for dt in DTYPES for name in K6_EDGES
                 if dt == torch.float32 or K6_EDGES[name][4] % 16 == 0]


def _at_offset(t, offset):
    """A contiguous copy of ``t`` whose data starts ``offset`` bytes past a
    256-byte boundary (offset a multiple of the element size)."""
    skip = offset // t.element_size()
    buf = torch.empty(t.numel() + skip, dtype=t.dtype, device=t.device)
    out = buf[skip:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 256 == offset
    return out


@pytest.mark.parametrize("dtype,name", K6_EDGE_CASES)
def test_k6_at_the_edges_of_its_tiling(cuda, dtype, name):
    b, s, d, f, offset = K6_EDGES[name]
    args = [a.to(dtype) for a in _mlp_inputs(b, s, d, f, cuda)]
    if offset:
        args[3], args[5] = _at_offset(args[3], offset), _at_offset(args[5], offset)
    before = (tfm.ln_mlp.launches, tfm.ln_mlp.launches_f32)
    out = tfm.ln_mlp(*args)
    torch.cuda.synchronize()
    assert (tfm.ln_mlp.launches, tfm.ln_mlp.launches_f32) == (before[0] + 1, before[1] + (dtype == torch.float32))
    assert out.shape == (b, s, d) and out.dtype == dtype
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, tfm.ln_mlp_reference(*args), **TOL[dtype])


def test_k6_refuses_what_it_does_not_take(cuda):
    args = _mlp_inputs(2, 8, 32, 64, cuda)
    with pytest.raises(TypeError, match="all bf16 or all fp32"):
        tfm.ln_mlp(*(a.half() for a in args))
    with pytest.raises(ValueError, match="contiguous"):
        tfm.ln_mlp(args[0].transpose(0, 1), *args[1:])
    odd = _mlp_inputs(2, 8, 36, 64, cuda)  # D = 36: rows of 72 bytes
    with pytest.raises(ValueError, match="% 8"):
        tfm.ln_mlp(*odd)
    odd_f = _mlp_inputs(2, 8, 32, 60, cuda)
    with pytest.raises(ValueError, match="% 8"):
        tfm.ln_mlp(*odd_f)
    with pytest.raises(ValueError, match="w2"):
        tfm.ln_mlp(*args[:5], args[5][:32], args[6])


def test_default_tiny_model_runs_fp32_on_the_card(cuda):
    """VideoBlipForConditionalGeneration(tiny_config()) with no device or
    dtype builds fp32 on the card; greedy generate runs K1, K2 and K3 through
    their fp32 bodies and gives the tokens of the same weights on the CPU."""
    from eilev_tpu_torch import configs
    from eilev_tpu_torch.generation import GenerationConfig, generate
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration
    from eilev_tpu_torch.ops.preprocess import process_videos

    cfg = configs.tiny_config()
    model = VideoBlipForConditionalGeneration(cfg).eval()
    param = next(model.parameters())
    assert param.is_cuda and param.dtype == torch.float32
    g = torch.Generator().manual_seed(5)
    cpu_model = VideoBlipForConditionalGeneration(cfg, device="cpu").eval()
    with torch.no_grad():
        for p in cpu_model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    model.load_state_dict(cpu_model.state_dict())
    b, v_per, t, s = 2, 2, 2, 16
    img = cfg.vision_config.image_size
    frames = torch.randint(0, 256, (b * v_per, 3, 5, 20, 20), generator=g, dtype=torch.uint8)
    ids = torch.randint(4, cfg.text_config.vocab_size, (b, s), generator=g)
    ids[:, 0] = 2
    mask = torch.ones(b, s, dtype=torch.int64)
    ids[1, :2], mask[1, :2] = 1, 0  # left padding
    vim = torch.zeros(b, s, dtype=torch.int64)
    vim[:, 3 : 3 + v_per * cfg.num_query_tokens] = 1
    gen = GenerationConfig(max_new_tokens=8, pad_token_id=1, eos_token_id=(-1,))

    def tokens(m, dev):
        pixel = process_videos(frames.to(dev), num_frames=t, height=img, width=img)
        return generate(m, input_ids=ids.to(dev), attention_mask=mask.to(dev), pixel_values=pixel,
                        video_input_mask=vim.to(dev), generation_config=gen).cpu()

    counts = (tfa.packed_qkv_attention.launches_f32, tfa.packed_qkv_causal_attention.launches_f32,
              tda.decode_attention_stacked.launches_f32)
    on_card = tokens(model, cuda)
    torch.cuda.synchronize()
    after = (tfa.packed_qkv_attention.launches_f32, tfa.packed_qkv_causal_attention.launches_f32,
             tda.decode_attention_stacked.launches_f32)
    n = cfg.text_config.num_hidden_layers
    assert after[0] - counts[0] == cfg.vision_config.num_hidden_layers
    assert after[1] - counts[1] == n
    steps = after[2] - counts[2]
    assert steps > 0 and steps % n == 0  # n launches on every one-token step
    torch.testing.assert_close(on_card, tokens(cpu_model, "cpu"), atol=0, rtol=0)


def test_text_lm_runs_fp32_on_the_card(cuda):
    """The text-only module TextLM builds, in fp32 on the card, decoded
    greedily through the call TextLM.generate makes: a 2,040-token prompt
    into 2,048 cache slots, so that the auto dispatcher takes K5 for the
    prefill; K5 and K3 run through their fp32 bodies (GQA 2 over 1, row 1
    left-padded) and give the tokens of the same weights on the CPU."""
    from eilev_tpu_torch import configs
    from eilev_tpu_torch.generation import GenerationConfig
    from eilev_tpu_torch.generation.decoding import _greedy_sample_decoder_only
    from eilev_tpu_torch.generation.text_lm import _TextOnlyModule
    from eilev_tpu_torch.ops.attention import uses_flash

    text = configs.LlamaConfig(vocab_size=96, hidden_size=256, num_hidden_layers=2, num_attention_heads=2,
                               num_key_value_heads=1, intermediate_size=512, max_position_embeddings=2048)
    cfg = configs.VideoBlipConfig(text_config=text)
    s, new = 2040, 8
    assert uses_flash(s, s + new)
    g = torch.Generator().manual_seed(6)
    cpu_module = _TextOnlyModule(cfg, device="cpu", dtype=torch.float32).eval()
    with torch.no_grad():
        for p in cpu_module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    module = _TextOnlyModule(cfg, device=cuda, dtype=torch.float32).eval()
    module.load_state_dict(cpu_module.state_dict())
    ids = torch.randint(3, text.vocab_size, (2, s), generator=g)
    mask = torch.ones(2, s, dtype=torch.int64)
    ids[:, 0] = text.bos_token_id
    ids[1, :100], mask[1, :100] = text.pad_token_id, 0  # left padding
    ids[1, 100] = text.bos_token_id
    gen = GenerationConfig(max_new_tokens=new, pad_token_id=text.pad_token_id, eos_token_id=(-1,))

    @torch.inference_mode()
    def tokens(m, dev):
        embeds = m.embed_and_scatter(ids.to(dev))
        return _greedy_sample_decoder_only(m, embeds, mask.to(dev), gen).cpu()

    counts = (tfl.flash_attention.launches_f32, tda.decode_attention_stacked.launches_f32)
    on_card = tokens(module, cuda)
    torch.cuda.synchronize()
    after = (tfl.flash_attention.launches_f32, tda.decode_attention_stacked.launches_f32)
    n = text.num_hidden_layers
    assert after[0] - counts[0] == n  # the prefill, one K5 launch a layer
    assert after[1] - counts[1] == n * (new - 1)  # every one-token step, one K3 launch a layer
    torch.testing.assert_close(on_card, tokens(cpu_module, "cpu"), atol=0, rtol=0)
