"""Attention primitives (counterpart of ``eilev_tpu/ops/attention.py``).

:func:`dot_product_attention` is the JAX package's dispatcher with its
signature and modes: ``auto`` takes the flash kernel K5
(``ops/flash_attention.py``) for q >= 1024 and kv >= 2048 with no bias or an
(H, S, L) one, the same thresholds as the JAX package (chosen on a TPU v5e
and kept as they are), and the plain path otherwise; ``flash`` always takes
K5; ``xla`` and ``fused`` take the plain path, as in JAX. K5 runs its
hand-written CUDA kernel for a CUDA tensor and its plain twin for a CPU one.

:func:`plain_attention` is the port of the JAX package's ``_xla_attention``:
the plain PyTorch attention behind ``xla``, the OPT decode step's twin and
the reference version of the packed causal kernel. It keeps the numerical
knobs of the JAX function (query-side vs score-side scaling, fp32 softmax, one
``finfo(float32).min`` fill for causal + padding masking) so each caller keeps
its HF numerics.

The packed ViT attention goes to the hand-written CUDA kernel K1 for a CUDA
tensor and to its plain twin for a CPU tensor (``ops/fused_attention.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

_DEFAULT_IMPL = "auto"
# the JAX package's thresholds (eilev_tpu/ops/attention.py:33-34), measured on
# a TPU v5e; whether they suit the H100 is recorded in PERF.md
_FLASH_MIN_Q = 1024
_FLASH_MIN_KV = 2048


def set_default_attention_impl(impl: str) -> None:
    """Set the global attention implementation: 'auto' | 'xla' | 'flash' | 'fused'."""
    global _DEFAULT_IMPL
    if impl not in ("auto", "xla", "flash", "fused"):
        raise ValueError(f"unknown attention implementation {impl!r}")
    _DEFAULT_IMPL = impl


def get_default_attention_impl() -> str:
    return _DEFAULT_IMPL


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


def uses_flash(
    q_len: int, kv_len: int, bias: Optional[torch.Tensor] = None, implementation: Optional[str] = None
) -> bool:
    """Whether :func:`dot_product_attention` takes K5 for these lengths."""
    impl = implementation or _DEFAULT_IMPL
    if impl == "auto":
        return q_len >= _FLASH_MIN_Q and kv_len >= _FLASH_MIN_KV and (bias is None or bias.ndim == 3)
    return impl == "flash"


def dot_product_attention(
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
    implementation: Optional[str] = None,
) -> torch.Tensor:
    """Multi-head scaled dot-product attention, dispatched as in JAX.

    q: (B, S, H, D); k, v: (B, L, KVH, D), where KVH divides H (grouped-query
    attention: head h reads kv head h // (H // KVH); the plain path repeats
    the kv heads, as the JAX callers do before the call). Other arguments as
    for :func:`plain_attention`; ``implementation`` overrides the default
    'auto' | 'xla' | 'flash' | 'fused'. Returns (B, S, H, D) in q.dtype.
    """
    if uses_flash(q.shape[1], k.shape[1], bias, implementation):
        from .flash_attention import flash_attention

        if bias is not None and bias.ndim != 3:
            raise ValueError("the flash path takes an (H, S, L) bias")
        return flash_attention(
            q, k, v, padding_mask=padding_mask, bias=bias, causal=causal,
            q_offset=q_offset, scale=scale, scale_query_first=scale_query_first,
        )
    group = q.shape[2] // k.shape[2]
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    return plain_attention(
        q, k, v, bias=bias, padding_mask=padding_mask, causal=causal,
        q_offset=q_offset, scale=scale, scale_query_first=scale_query_first,
        softmax_in_fp32=softmax_in_fp32,
    )


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
