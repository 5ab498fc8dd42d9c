"""The numerics of the fp32 attention body's design, held on the CPU.

``csrc/attention_f32.cu`` (the fp32 body of K1, K2 and K5) runs both of its
products on the tensor cores as 3xTF32: every operand x is split into hi =
tf32_rna(x) and lo = tf32_rna(x - hi) (``cvt.rna.tf32.f32``: 10 mantissa
bits, round to nearest, ties away from zero), and a b = lo_a hi_b + hi_a lo_b
+ hi_a hi_b with fp32 sums in k steps of 8 (one mma.sync m16n8k8 each); lo
lo is dropped. This file emulates those products in torch (the rounding by
bit arithmetic on the fp32 pattern) inside the kernel's online softmax over
its key tiles, and holds the result to the plain twins evaluated in fp64, at
the bar the card holds the kernel to (atol = rtol = 1e-4, ``F32_TOL`` of
``chip_smoke.py``): an fp32 model's attention must agree with the fp32
reference to about fp32's own rounding of a ~D-term sum, far below that bar;
3xTF32 keeps ~22 bits a product, so it passes with more than an order of
magnitude to spare. A single TF32 product (hi x hi: ~11 bits an operand) must miss the
same bar, so the test tells the two designs apart. Inputs come from numpy
with a seed, at tiny shapes in the three modes the kernel serves: K1
(uniform rows, no mask), K2 (causal + padding, query-side scale, fully
masked rows = the uniform average of every V row) and K5 (grouped-query
heads, an (H, S, L) bias, a query offset, padding; fully masked rows exactly
0).
"""

import numpy as np
import pytest
import torch

from eilev_tpu_torch.ops import flash_attention as tfl
from eilev_tpu_torch.ops import fused_attention as tfa

from ._torch_port import tf32_product, tf32_rna, tf32_split

TOL = 1e-4
FLT_MIN = torch.finfo(torch.float32).min


def emulated_attention(q, k, v, *, passes, uniform, mask=None, bias=None, causal=False, q_offset=0,
                       q_scale=1.0, s_scale=1.0):
    """The fp32 body's arithmetic: q (B, S, H, D), k, v (B, L, KVH, D) fp32;
    online softmax over key tiles of 32 with one division at the end; masked
    keys at finfo(float32).min (uniform) or excluded (p = 0)."""
    b, s, h, d = q.shape
    l_len, kvh = k.shape[1], k.shape[2]
    bk = 32
    qh = (q * q_scale).permute(0, 2, 1, 3)
    kh = k.permute(0, 2, 1, 3).repeat_interleave(h // kvh, dim=1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(h // kvh, dim=1)
    q_pos = torch.arange(s)[:, None] + q_offset
    m = torch.full((b, h, s, 1), -torch.inf)
    l_sum = torch.zeros(b, h, s, 1)
    acc = torch.zeros(b, h, s, d)
    for k0 in range(0, l_len, bk):
        k1 = min(k0 + bk, l_len)
        sc = tf32_product(qh, kh[:, :, k0:k1].transpose(-1, -2), passes) * s_scale
        if bias is not None:
            sc = sc + bias[None, :, :, k0:k1]
        keep = torch.ones(1, 1, s, k1 - k0, dtype=torch.bool)
        if mask is not None:
            keep = keep & (mask[:, None, None, k0:k1] != 0)
        if causal:
            keep = keep & (torch.arange(k0, k1)[None, :] <= q_pos)[None, None]
        sc = torch.where(keep, sc, FLT_MIN if uniform else -torch.inf)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        empty = m_new == -torch.inf
        alpha = torch.where(empty, 1.0, torch.exp(m - m_new))
        p = torch.where(empty, 0.0, torch.exp(sc - m_new))
        l_sum = l_sum * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + tf32_product(p, vh[:, :, k0:k1], passes)
        m = m_new
    return (acc / torch.where(l_sum == 0.0, 1.0, l_sum)).permute(0, 2, 1, 3)


def _rand(rng, *shape, std=1.0) -> torch.Tensor:
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))


def _k1_case(rng):
    """K1: the ViT attention, bidirectional, score-side scale; S = 80 spans
    two 32-key tiles and a ragged one."""
    b, s, nh, hd = 2, 80, 2, 24
    qkv = _rand(rng, b, s, 3 * nh * hd, std=2.0)
    q, k, v = qkv.view(b, s, 3, nh, hd).unbind(2)
    scale = hd**-0.5
    emu = lambda passes: emulated_attention(q, k, v, passes=passes, uniform=True, s_scale=scale)  # noqa: E731
    ref64 = tfa.packed_qkv_attention_reference(qkv.double(), nh, hd, scale).view(b, s, nh, hd)
    twin = tfa.packed_qkv_attention_reference(qkv, nh, hd, scale).view(b, s, nh, hd)
    return emu, ref64, twin, None


def _k2_case(rng):
    """K2: the OPT prefill, causal, query-side scale, row 0 left-padded by 9
    (its query rows 0-8 see no kept key), row 1 right-padded."""
    b, s, nh, hd = 2, 70, 2, 16
    qkv = _rand(rng, b, s, 3 * nh * hd, std=2.0)
    mask = torch.ones(b, s, dtype=torch.int32)
    mask[0, :9] = 0
    mask[1, 55:] = 0
    q, k, v = qkv.view(b, s, 3, nh, hd).unbind(2)
    scale = hd**-0.5
    emu = lambda passes: emulated_attention(q, k, v, passes=passes, uniform=True, mask=mask,  # noqa: E731
                                            causal=True, q_scale=scale)
    ref64 = tfa.packed_qkv_causal_attention_reference(qkv.double(), nh, hd, mask, scale).view(b, s, nh, hd)
    twin = tfa.packed_qkv_causal_attention_reference(qkv, nh, hd, mask, scale).view(b, s, nh, hd)
    dead = (0, slice(0, 9))
    # the twins' fully masked rows: the uniform average of every V row
    torch.testing.assert_close(twin[dead], v[0].mean(0).expand(9, -1, -1), atol=TOL, rtol=TOL)
    return emu, ref64, twin, dead


def _k5_case(rng):
    """K5: 4 query heads over 1 kv head, an (H, S, L) bias, q_offset 5,
    causal, score-side scale, row 0 left-padded so that its query rows 0-5
    see no kept key; L = 100 spans three 32-key tiles and a ragged one."""
    b, s, l_len, nh, kvh, hd, off = 2, 30, 100, 4, 1, 40, 5
    q = _rand(rng, b, s, nh, hd, std=2.0)
    k = _rand(rng, b, l_len, kvh, hd, std=2.0)
    v = _rand(rng, b, l_len, kvh, hd)
    bias = _rand(rng, nh, s, l_len, std=2.0)
    mask = torch.ones(b, l_len, dtype=torch.int32)
    mask[0, :11] = 0  # query row i sees keys <= i + 5: rows 0-5 none
    mask[:, off + s:] = 0  # the unfilled cache tail
    scale = hd**-0.5
    kw = dict(padding_mask=mask, bias=bias, causal=True, q_offset=off, scale=scale)
    emu = lambda passes: emulated_attention(q, k, v, passes=passes, uniform=False, mask=mask,  # noqa: E731
                                            bias=bias, causal=True, q_offset=off, s_scale=scale)
    ref64 = tfl.flash_attention_reference(q.double(), k.double(), v.double(), **dict(kw, bias=bias.double()))
    twin = tfl.flash_attention_reference(q, k, v, **kw)
    dead = (0, slice(0, 6))
    assert (twin[dead] == 0).all()  # the twin's fully masked rows are exactly 0
    return emu, ref64, twin, dead


CASES = {"k1_uniform": _k1_case, "k2_causal_padded": _k2_case, "k5_gqa_bias_offset": _k5_case}


@pytest.mark.parametrize("mode", list(CASES))
def test_3xtf32_products_hold_the_fp32_bar(mode):
    """(a) The 3xTF32 products stay within 1e-4 of the twin in fp64, within
    a tenth of that, and within twice the error of the plain fp32 twin (the
    products' error is fp32's own: 2-6e-6 at these inputs)."""
    emu, ref64, twin, _ = CASES[mode](np.random.default_rng(10))
    out = emu(3)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.double(), ref64, atol=TOL, rtol=TOL)
    err = (out.double() - ref64).abs().max().item()
    assert err < TOL / 10
    assert err <= 2 * (twin.double() - ref64).abs().max().item()


@pytest.mark.parametrize("mode", list(CASES))
def test_one_tf32_product_misses_the_bar(mode):
    """(b) One TF32 product, even rounded to nearest, misses the same bar
    (by 25-75x at these inputs): the test tells 3xTF32 from single-pass
    TF32."""
    emu, ref64, _, _ = CASES[mode](np.random.default_rng(10))
    out = emu(1)
    assert not torch.allclose(out.double(), ref64, atol=TOL, rtol=TOL)
    assert (out.double() - ref64).abs().max().item() > 3 * TOL


@pytest.mark.parametrize("mode", ["k2_causal_padded", "k5_gqa_bias_offset"])
def test_fully_masked_rows_are_the_twins(mode):
    """(c) Rows with no kept key come out as the twins give them: the uniform
    average of every V row (K2, finfo(float32).min is finite) or exactly 0
    (K5)."""
    emu, _, twin, dead = CASES[mode](np.random.default_rng(10))
    out = emu(3)
    if mode == "k5_gqa_bias_offset":
        assert (out[dead] == 0).all()
    torch.testing.assert_close(out[dead], twin[dead], atol=TOL, rtol=TOL)
    torch.testing.assert_close(out, twin, atol=TOL, rtol=TOL)


def test_tf32_rounding_is_to_nearest_ties_away():
    """The bit arithmetic against the rule: 10 mantissa bits kept, a dropped
    half rounded away from zero, a carry into the exponent."""
    one_ulp = 2.0**-10  # tf32's ulp at 1
    x = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 2 - 2.0**-23,
                      2.0 - 2.0**-23, 3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 2.0, 3.0, -0.0], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    hi, lo = tf32_split(torch.tensor([1.0 / 3.0]))
    assert hi.item() != 1.0 / 3.0 and abs((hi + lo).item() - 1.0 / 3.0) < 2.0**-22 / 3.0 * 2
