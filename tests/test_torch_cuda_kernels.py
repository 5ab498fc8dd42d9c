"""The hand-written CUDA kernels K1-K6 against their plain twins, on the card.

Marked ``cuda``; skips on a host without a CUDA device (the CPU suite runs the
plain twins against JAX in tests/test_torch_fused_attention.py,
tests/test_torch_decode_attention.py, tests/test_torch_flash_attention.py and
tests/test_torch_fused_mlp.py). Run on a GPU host with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``.
Tolerance: bf16 atol = rtol = 2e-2 for K1-K3, K5 and K6 and 3e-2 for K4 (the
int8 cache; the JAX int8 kernel test's bar). K5's cases check which of its
two bodies the kernel reports it ran (``launches_sm90``) against the rule
``uses_sm90_body`` states.
"""

import pytest
import torch

from eilev_tpu_torch.ops import decode_attention as tda
from eilev_tpu_torch.ops import flash_attention as tfl
from eilev_tpu_torch.ops import fused_attention as tfa
from eilev_tpu_torch.ops import fused_mlp as tfm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on a GPU")
    return torch.device("cuda")


def _qkv(b, s, nh, hd, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(b, s, 3 * nh * hd, device=device, generator=g).to(torch.bfloat16)


@pytest.mark.parametrize("b,s,nh,hd", [(3, 9, 2, 8), (2, 257, 2, 88), (8, 257, 16, 88), (2, 100, 3, 128)])
def test_k1_kernel_matches_plain(cuda, b, s, nh, hd):
    qkv = _qkv(b, s, nh, hd, cuda)
    before = tfa.packed_qkv_attention.launches
    out = tfa.packed_qkv_attention(qkv, nh, hd)
    torch.cuda.synchronize()
    assert tfa.packed_qkv_attention.launches == before + 1
    ref = tfa.packed_qkv_attention_reference(qkv, nh, hd, hd**-0.5)
    torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("s", [1, 17, 257, tfa.K1_MAX_SEQ])
@pytest.mark.parametrize("hd", [88, 128])
def test_k1_takes_whole_rows_up_to_its_limit(cuda, s, hd):
    """Odd batch; S = 1, 17, the ViT's 257 and the largest S the resident
    design takes (K and V of a head in shared memory)."""
    qkv = _qkv(3, s, 2, hd, cuda, seed=s)
    out = tfa.packed_qkv_attention(qkv, 2, hd)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, tfa.packed_qkv_attention_reference(qkv, 2, hd, hd**-0.5),
                               atol=2e-2, rtol=2e-2)


def test_packed_kernels_refuse_sequences_past_their_limit(cuda):
    with pytest.raises(ValueError, match="sequences"):
        tfa.packed_qkv_attention(_qkv(1, tfa.K1_MAX_SEQ + 1, 1, 8, cuda), 1, 8)
    s = tfa.K2_MAX_SEQ + 1
    with pytest.raises(ValueError, match="sequences"):
        tfa.packed_qkv_causal_attention(
            _qkv(1, s, 1, 8, cuda), 1, 8, torch.ones(1, s, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("padding", ["none", "left", "right"])
@pytest.mark.parametrize("b,s,nh,hd", [(2, 24, 2, 8), (2, 130, 2, 80), (2, 766, 32, 80),
                                       (2, 2048, 4, 80), (1, 2048, 2, 128)])
def test_k2_kernel_matches_plain(cuda, b, s, nh, hd, padding):
    qkv = _qkv(b, s, nh, hd, cuda, seed=1)
    mask = torch.ones(b, s, dtype=torch.int32, device=cuda)
    if padding == "left":
        mask[0, : s // 5] = 0
    elif padding == "right":
        mask[-1, s - s // 4 :] = 0
    before = tfa.packed_qkv_causal_attention.launches
    out = tfa.packed_qkv_causal_attention(qkv, nh, hd, mask)
    torch.cuda.synchronize()
    assert tfa.packed_qkv_causal_attention.launches == before + 1
    ref = tfa.packed_qkv_causal_attention_reference(qkv, nh, hd, mask, hd**-0.5)
    if padding == "left":  # fully masked query rows are NaN in bf16, in both
        assert torch.isnan(out[0, : s // 5]).all() and torch.isnan(ref[0, : s // 5]).all()
        assert torch.isfinite(out[0, s // 5 :]).all()
    torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2, equal_nan=True)


def test_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(TypeError, match="bf16"):
        tfa.packed_qkv_attention(_qkv(1, 8, 2, 8, cuda).float(), 2, 8)
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


@pytest.mark.parametrize("kind", ["full", "mid-decode", "left-padded", "fully-masked-row"])
@pytest.mark.parametrize("n_layers,b,s,nh,kvh,hd,scale_query", DECODE_SHAPES)
def test_k3_kernel_matches_plain(cuda, n_layers, b, s, nh, kvh, hd, scale_query, kind):
    k, v, g = _cache(n_layers, b, s, kvh, hd, cuda, seed=s)
    q = torch.randn(b, nh * hd, device=cuda, generator=g).to(torch.bfloat16)
    mask = _decode_mask(b, s, cuda, kind)
    kw = dict(num_heads=nh, head_dim=hd, kv_heads=kvh, scale_query=scale_query)
    kb, vb = k.view(n_layers, b, s, -1), v.view(n_layers, b, s, -1)
    for layer in (0, n_layers - 1):
        before = tda.decode_attention_stacked.launches_bf16
        out = tda.decode_attention_stacked(q, kb, vb, mask, layer, **kw)
        torch.cuda.synchronize()
        assert tda.decode_attention_stacked.launches_bf16 == before + 1
        ref = tda.decode_attention_stacked_reference(q, kb, vb, mask, layer, **kw)
        if kind == "fully-masked-row":  # NaN in bf16, in both
            assert torch.isnan(out[-1]).all() and torch.isnan(ref[-1]).all()
        torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2, equal_nan=True)


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


@pytest.mark.parametrize("kind", ["full", "mid-decode", "fully-masked-row"])
@pytest.mark.parametrize("n_layers,b,s,nh,kvh,hd,scale_query", INT8_SHAPES)
def test_k4_kernel_matches_plain(cuda, n_layers, b, s, nh, kvh, hd, scale_query, kind):
    k, v, g = _cache(n_layers, b, s, kvh, hd, cuda, seed=s + 1)
    q = torch.randn(b, nh * hd, device=cuda, generator=g).to(torch.bfloat16)
    k8, ks = tda.quantize_kv(k)
    v8, vs = tda.quantize_kv(v)
    k8, v8 = k8.view(n_layers, b, s, -1), v8.view(n_layers, b, s, -1)
    mask = _decode_mask(b, s, cuda, kind)
    kw = dict(num_heads=nh, head_dim=hd, kv_heads=kvh, scale_query=scale_query)
    layer = n_layers // 2
    before = tda.decode_attention_stacked.launches_int8
    out = tda.decode_attention_stacked(q, k8, v8, mask, layer, k_scale=ks, v_scale=vs, **kw)
    torch.cuda.synchronize()
    assert tda.decode_attention_stacked.launches_int8 == before + 1
    ref = tda.decode_attention_stacked_reference(q, k8, v8, mask, layer, k_scale=ks, v_scale=vs, **kw)
    if kind == "fully-masked-row":  # NaN in bf16, in both
        assert torch.isnan(out[-1]).all() and torch.isnan(ref[-1]).all()
    torch.testing.assert_close(out, ref, atol=3e-2, rtol=3e-2, equal_nan=True)
    # and against dequantize_kv + the bf16 twin, as chip_smoke holds it
    kd = tda.dequantize_kv(k8.view(k.shape), ks).view(n_layers, b, s, -1)
    vd = tda.dequantize_kv(v8.view(v.shape), vs).view(n_layers, b, s, -1)
    ref_bf16 = tda.decode_attention_stacked_reference(q, kd, vd, mask, layer, **kw)
    torch.testing.assert_close(out, ref_bf16, atol=3e-2, rtol=3e-2, equal_nan=True)


def test_decode_kernel_refuses_what_it_does_not_take(cuda):
    k, v, g = _cache(2, 1, 40, 2, 16, cuda, seed=0)
    q = torch.randn(1, 32, device=cuda, generator=g).to(torch.bfloat16)
    mask = torch.ones(1, 40, dtype=torch.int32, device=cuda)
    kw = dict(num_heads=2, head_dim=16)
    kb = k.view(2, 1, 40, -1)
    with pytest.raises(TypeError, match="bf16"):  # an fp32 cache
        tda.decode_attention_stacked(q.float(), kb.float(), kb.float(), mask, 0, **kw)
    k8, ks = tda.quantize_kv(k[..., :8].contiguous())
    with pytest.raises(ValueError, match="head_dim"):  # int8 rows of 8 bytes: not 16-byte aligned
        tda.decode_attention_stacked(
            q[:, :16].contiguous(), k8.view(2, 1, 40, -1), k8.view(2, 1, 40, -1), mask, 0,
            num_heads=2, head_dim=8, k_scale=ks, v_scale=ks,
        )
    s_big = 60_000  # scores above 227 KB of shared memory
    big = torch.zeros(1, 1, s_big, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        tda.decode_attention_stacked(
            q, big, big, torch.ones(1, s_big, dtype=torch.int32, device=cuda), 0, **kw
        )
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


@pytest.mark.parametrize("b,s,l,nh,kvh,hd,causal,q_offset,sqf,mask,bias", FLASH_CASES)
def test_k5_kernel_matches_plain(cuda, b, s, l, nh, kvh, hd, causal, q_offset, sqf, mask, bias):
    g = torch.Generator(device=cuda).manual_seed(s + l)
    q = torch.randn(b, s, nh, hd, device=cuda, generator=g).to(torch.bfloat16)
    k = torch.randn(b, l, kvh, hd, device=cuda, generator=g).to(torch.bfloat16)
    v = torch.randn(b, l, kvh, hd, device=cuda, generator=g).to(torch.bfloat16)
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
    sm90 = tfl.uses_sm90_body(q, k, v, bias_t)
    assert sm90 == (hd == 128 and not bias)
    before = (tfl.flash_attention.launches, tfl.flash_attention.launches_sm90)
    out = tfl.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (tfl.flash_attention.launches, tfl.flash_attention.launches_sm90) == (
        before[0] + 1, before[1] + int(sm90))
    ref = tfl.flash_attention_reference(q, k, v, **kw)
    if padded:  # fully masked rows are exactly 0, in both
        assert (out[0, :padded] == 0).all() and (ref[0, :padded] == 0).all()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("hd", [64, 128])
def test_k5_reads_a_cache_layer_in_place(cuda, hd):
    """k, v as a layer slice of the stacked cache: strided rows, no copy (hd
    128 through the Hopper body's tensor maps, 64 through the mma.sync body)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    kb = torch.randn(3, 2, 160, 4, hd, device=cuda, generator=g).to(torch.bfloat16)
    vb = torch.randn(3, 2, 160, 4, hd, device=cuda, generator=g).to(torch.bfloat16)
    q = torch.randn(2, 100, 8, hd, device=cuda, generator=g).to(torch.bfloat16)
    pm = torch.zeros(2, 160, dtype=torch.int32, device=cuda)
    pm[:, :100] = 1
    kw = dict(padding_mask=pm, causal=True, scale=hd**-0.5)
    before = tfl.flash_attention.launches_sm90
    out = tfl.flash_attention(q, kb[1], vb[1], **kw)
    torch.cuda.synchronize()
    assert tfl.flash_attention.launches_sm90 == before + (hd == 128)
    ref = tfl.flash_attention_reference(q, kb[1].contiguous(), vb[1].contiguous(), **kw)
    torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        tfl.flash_attention(q.float(), q.float(), q.float())
    odd = torch.zeros(1, 8, 2, 12, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tfl.flash_attention(odd, odd, odd)
    with pytest.raises(ValueError, match="strides"):
        t = q.transpose(1, 2)
        tfl.flash_attention(t, t, t)


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


@pytest.mark.parametrize("b,s,d,f", [(2, 257, 1408, 6144), (3, 17, 32, 64), (5, 100, 88, 200)])
def test_k6_kernel_matches_plain(cuda, b, s, d, f):
    args = _mlp_inputs(b, s, d, f, cuda)
    before = tfm.ln_mlp.launches
    out = tfm.ln_mlp(*args)
    torch.cuda.synchronize()
    assert tfm.ln_mlp.launches == before + 1
    assert out.shape == (b, s, d) and out.dtype == torch.bfloat16
    torch.testing.assert_close(out, tfm.ln_mlp_reference(*args), atol=2e-2, rtol=2e-2)


def test_k6_refuses_what_it_does_not_take(cuda):
    args = _mlp_inputs(2, 8, 32, 64, cuda)
    with pytest.raises(TypeError, match="bf16"):
        tfm.ln_mlp(*(a.float() for a in args))
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
