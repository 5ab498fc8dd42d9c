"""Attention primitives (counterpart of ``eilev_tpu/ops/attention.py``).

:func:`plain_attention` is the port of the JAX package's ``_xla_attention``:
the plain PyTorch attention that the Q-Former, the OPT decode step and the
reference version of the packed causal kernel all use. It keeps the numerical
knobs of the JAX function (query-side vs score-side scaling, fp32 softmax, one
``finfo(float32).min`` fill for causal + padding masking) so each caller keeps
its HF numerics.

Dispatch is by the tensor's device, not by backend: the packed ViT attention
goes to the hand-written CUDA kernel for a CUDA tensor and to its plain twin
for a CPU tensor (``ops/fused_attention.py``). The JAX ``dot_product_attention``
dispatcher has no counterpart yet: its FA2-style flash kernel is not ported,
and at the shapes of the greedy-narration path (Q-Former q=32, one-token
decode) its ``auto`` mode takes the plain path, so callers use
:func:`plain_attention` directly.
"""

from __future__ import annotations

from typing import Optional

import torch


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``like``'s dtype: a multiply by it rounds the
    scalar to that dtype first, as ``jnp.asarray(value, dtype)`` does."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def packed_qkv_self_attention(
    qkv: torch.Tensor,
    num_heads: int,
    head_dim: int,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Mask-free self-attention straight off a packed (B, S, 3*H*D) QKV tensor.

    The ViT hot path. A CUDA tensor runs the hand-written kernel, a CPU tensor
    its plain twin (see :func:`ops.fused_attention.packed_qkv_attention`).
    """
    from .fused_attention import packed_qkv_attention

    if scale is None:
        scale = head_dim**-0.5
    return packed_qkv_attention(qkv, num_heads, head_dim, scale=scale)


def plain_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    padding_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    q_offset: int = 0,
    scale: Optional[float] = None,
    scale_query_first: bool = False,
    softmax_in_fp32: bool = False,
) -> torch.Tensor:
    """Plain attention with the rounding points of ``_xla_attention``.

    q: (B, S, H, D); k, v: (B, L, H, D). Returns (B, S, H, D) in q.dtype.
    """
    orig_dtype = q.dtype
    if scale is not None and scale_query_first:
        q = q * _scalar(scale, q)
    scores = torch.einsum("bshd,blhd->bhsl", q, k)  # (B, H, S, L)
    if scale is not None and not scale_query_first:
        scores = scores * _scalar(scale, scores)
    if bias is not None:
        b4 = bias if bias.ndim != 3 else bias[None]
        scores = scores + b4.to(scores.dtype)
    # causal + padding fold into ONE fill, as in the JAX function
    keep = None
    if causal:
        s_len, l_len = q.shape[1], k.shape[1]
        q_pos = torch.arange(s_len, device=q.device)[:, None] + q_offset
        k_pos = torch.arange(l_len, device=q.device)[None, :]
        keep = (k_pos <= q_pos)[None, None]
    if padding_mask is not None:
        pm = padding_mask.bool()[:, None, None, :]
        keep = pm if keep is None else keep & pm
    if keep is not None:
        # finfo(float32).min in the score dtype: -inf in bf16, so a fully
        # masked row is NaN there, exactly as in the JAX function
        scores = torch.where(
            keep, scores, _scalar(torch.finfo(torch.float32).min, scores)
        )
    if softmax_in_fp32:
        probs = torch.softmax(scores.float(), dim=-1).to(orig_dtype)
    else:
        probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhsl,blhd->bshd", probs, v)


def mask_to_bias(mask: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Boolean keep-mask -> additive bias with the dtype's most-negative finite
    value (HF's ``_update_causal_mask`` convention)."""
    zero = torch.tensor(0.0, dtype=dtype, device=mask.device)
    neg = torch.tensor(torch.finfo(dtype).min, dtype=dtype, device=mask.device)
    return torch.where(mask.bool(), zero, neg)


def make_causal_bias(
    q_len: int,
    kv_len: int,
    *,
    offset: int = 0,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Additive causal bias of shape (1, 1, q_len, kv_len); ``offset`` is the
    absolute position of query 0 within the kv axis."""
    q_pos = torch.arange(q_len, device=device)[:, None] + offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    return mask_to_bias(k_pos <= q_pos, dtype)[None, None]
