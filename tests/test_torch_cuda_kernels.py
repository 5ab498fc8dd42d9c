"""The hand-written CUDA kernels K1 and K2 against their plain twins, on the card.

Marked ``cuda``; skips on a host without a CUDA device (the CPU suite runs the
plain twins against JAX in tests/test_torch_fused_attention.py). Run on a GPU
host with ``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``.
Tolerance: bf16 atol = rtol = 2e-2, as in chip_smoke.py.
"""

import pytest
import torch

from eilev_tpu_torch.ops import fused_attention as tfa

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


@pytest.mark.parametrize("padding", ["none", "left", "right"])
@pytest.mark.parametrize("b,s,nh,hd", [(2, 24, 2, 8), (2, 130, 2, 80), (2, 766, 32, 80)])
def test_k2_kernel_matches_plain(cuda, b, s, nh, hd, padding):
    qkv = _qkv(b, s, nh, hd, cuda, seed=1)
    mask = torch.ones(b, s, dtype=torch.int32, device=cuda)
    if padding == "left":
        mask[0, : s // 5] = 0
    elif padding == "right":
        mask[1, s - s // 4 :] = 0
    before = tfa.packed_qkv_causal_attention.launches
    out = tfa.packed_qkv_causal_attention(qkv, nh, hd, mask)
    torch.cuda.synchronize()
    assert tfa.packed_qkv_causal_attention.launches == before + 1
    ref = tfa.packed_qkv_causal_attention_reference(qkv, nh, hd, mask, hd**-0.5)
    if padding == "left":  # fully masked query rows are NaN in bf16, in both
        assert torch.isnan(out[0, : s // 5]).all()
    torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2, equal_nan=True)


def test_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(TypeError, match="bf16"):
        tfa.packed_qkv_attention(_qkv(1, 8, 2, 8, cuda).float(), 2, 8)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.packed_qkv_attention(_qkv(1, 8, 2, 12, cuda), 2, 12)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.packed_qkv_attention(_qkv(2, 8, 2, 8, cuda).transpose(0, 1), 2, 8)
