"""Port vs JAX: the plain attention primitives (ops/attention.py), fp32, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu.ops import attention as ja
from eilev_tpu_torch.ops import attention as ta

from ._torch_port import to_np


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(scale=0.3),  # score-side scale (Q-Former)
        dict(scale=0.3, scale_query_first=True, softmax_in_fp32=True, causal=True),  # OPT prefill
        dict(scale=0.3, scale_query_first=True, softmax_in_fp32=True, padding=True),  # OPT decode
        dict(scale=None, bias=3, causal=True, q_offset=2, padding=True),  # T5-style bias
        dict(scale=0.5, bias=4),
    ],
)
def test_plain_attention_matches_xla_attention(kwargs):
    rng = np.random.default_rng(0)
    b, s, l, h, d = 2, 5, 7, 3, 4
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for n in (s, l, l))
    args = dict(kwargs)
    mask = None
    if args.pop("padding", False):
        mask = np.ones((b, l), np.int32)
        mask[0, :3] = 0
    bias = None
    nd = args.pop("bias", None)
    if nd:
        bias = rng.normal(size=(h, s, l) if nd == 3 else (b, 1, s, l)).astype(np.float32)
    full = dict(bias=None, padding_mask=None, causal=False, q_offset=0, scale=None,
                scale_query_first=False, softmax_in_fp32=False)
    full.update(args)
    ref = ja._xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        **{**full, "bias": None if bias is None else jnp.asarray(bias),
           "padding_mask": None if mask is None else jnp.asarray(mask)},
    )
    ours = ta.plain_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        **{**full, "bias": None if bias is None else torch.from_numpy(bias),
           "padding_mask": None if mask is None else torch.from_numpy(mask)},
    )
    np.testing.assert_allclose(to_np(ours), to_np(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("q_len,kv_len,offset", [(4, 4, 0), (2, 6, 3), (1, 5, 4)])
def test_causal_bias_and_mask_to_bias_match_jax(q_len, kv_len, offset):
    ref = ja.make_causal_bias(q_len, kv_len, offset=offset)
    ours = ta.make_causal_bias(q_len, kv_len, offset=offset)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    keep = np.random.default_rng(q_len).integers(0, 2, size=(3, kv_len)).astype(bool)
    np.testing.assert_array_equal(
        ta.mask_to_bias(torch.from_numpy(keep)).numpy(), np.asarray(ja.mask_to_bias(jnp.asarray(keep)))
    )


def test_packed_qkv_self_attention_matches_jax():
    qkv = np.random.default_rng(1).normal(size=(2, 6, 3 * 2 * 8)).astype(np.float32)
    ref = ja.packed_qkv_self_attention(jnp.asarray(qkv), 2, 8)
    ours = ta.packed_qkv_self_attention(torch.from_numpy(qkv), 2, 8)
    np.testing.assert_allclose(to_np(ours), to_np(ref), atol=1e-5, rtol=1e-5)
