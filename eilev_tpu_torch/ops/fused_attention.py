"""Packed-QKV attention kernels (counterpart of ``eilev_tpu/ops/fused_attention.py``).

Two wrappers, each with a plain PyTorch twin in this module:

- :func:`packed_qkv_attention` (K1): bidirectional, mask-free attention off the
  packed (B, S, 3*H*D) QKV — the EVA-ViT attention.
- :func:`packed_qkv_causal_attention` (K2): causal + (B, S) key-padding
  attention off the packed QKV with queries at offset 0 — the OPT prefill.

A wrapper runs its plain twin for a CPU tensor. For a CUDA tensor it launches
the hand-written kernel of ``csrc/packed_attention.cu`` on the current stream
or raises; nothing falls back. Each wrapper counts its kernel launches in its
``launches`` attribute, a plain integer.

K1 keeps a head's K and V and a warp's whole score rows on chip, so it takes
S <= ``K1_MAX_SEQ`` (384: at D = 128, K and V take 208,896 of the 232,448
bytes of shared memory a block may use); every ViT geometry has S = 257. K2
keeps a query tile's bf16 scores in shared memory and takes S <=
``K2_MAX_SEQ`` (2,048, OPT's positions). Above either the wrapper raises
``ValueError``.

The twins carry the rounding points of the JAX kernels, which follow HF's bf16
numerics:

- K1: QK^T in fp32, rounded to the model dtype, scaled in the model dtype;
  fp32 softmax; probabilities rounded to the model dtype; PV in fp32.
- K2: q scaled and rounded to the model dtype before QK^T; scores rounded to
  the model dtype; masked with ``finfo(float32).min`` cast to the model dtype
  (``-inf`` in bf16, so a fully masked row is NaN there); fp32 softmax;
  probabilities in the model dtype; PV in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import _scalar, plain_attention

# the kernels' sequence limits (csrc/packed_attention.cu K1_MAX_S, K2_MAX_S)
K1_MAX_SEQ = 384
K2_MAX_SEQ = 2048
# grid dimensions y (heads) and z (batch rows)
_MAX_GRID = 65535


def packed_qkv_attention_reference(
    qkv: torch.Tensor, num_heads: int, head_dim: int, scale: float
) -> torch.Tensor:
    """Plain twin of K1 (the JAX ``_xla_packed_fallback``)."""
    b, s, _ = qkv.shape
    r = qkv.reshape(b, s, 3, num_heads, head_dim)
    q, k, v = r[:, :, 0], r[:, :, 1], r[:, :, 2]
    scores = torch.einsum("bshd,blhd->bhsl", q, k) * _scalar(scale, q)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhsl,blhd->bshd", probs, v)
    return out.reshape(b, s, num_heads * head_dim)


def packed_qkv_causal_attention_reference(
    qkv: torch.Tensor,
    num_heads: int,
    head_dim: int,
    padding_mask: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    """Plain twin of K2 (the JAX ``_xla_packed_causal_fallback``)."""
    b, s, _ = qkv.shape
    r = qkv.reshape(b, s, 3, num_heads, head_dim)
    q, k, v = r[:, :, 0], r[:, :, 1], r[:, :, 2]
    return plain_attention(
        q, k, v,
        padding_mask=padding_mask, causal=True, q_offset=0,
        scale=scale, scale_query_first=True, softmax_in_fp32=True,
    ).reshape(b, s, num_heads * head_dim)


def _check(qkv: torch.Tensor, num_heads: int, head_dim: int, max_seq: int) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if qkv.ndim != 3 or qkv.shape[2] != 3 * num_heads * head_dim:
        raise ValueError(
            f"qkv must be (B, S, 3*{num_heads}*{head_dim}), got {tuple(qkv.shape)}"
        )
    if qkv.shape[1] > max_seq:
        raise ValueError(f"the CUDA kernel takes sequences of at most {max_seq}, got {qkv.shape[1]}")
    if qkv.shape[0] > _MAX_GRID or num_heads > _MAX_GRID:
        raise ValueError(f"the CUDA kernel takes at most {_MAX_GRID} batch rows and heads")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 qkv, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous qkv")
    if head_dim % 8 or head_dim > 128:
        raise ValueError(f"the CUDA kernel takes head_dim % 8 == 0 and <= 128, got {head_dim}")
    if qkv.data_ptr() % 16:
        raise ValueError("the CUDA kernel takes a 16-byte aligned qkv")


def _launch(
    qkv: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_heads: int,
    head_dim: int,
    q_scale: float,
    s_scale: float,
    causal: bool,
) -> torch.Tensor:
    from ._build import packed_attention_lib

    b, s, _ = qkv.shape
    out = torch.empty(b, s, num_heads * head_dim, dtype=qkv.dtype, device=qkv.device)
    rc = packed_attention_lib().eilev_packed_attention_bf16(
        qkv.data_ptr(),
        None if mask is None else mask.data_ptr(),
        out.data_ptr(),
        b, s, num_heads, head_dim,
        q_scale, s_scale, int(causal),
        torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"packed attention kernel launch failed: cudaError_t {rc}")
    return out


def _bf16(value: float) -> float:
    """``value`` rounded to bf16, as the JAX kernels round a scale before use."""
    return float(torch.tensor(value, dtype=torch.bfloat16))


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"packed attention runs on cpu or cuda tensors, got {t.device}")
    return t.device.type


def packed_qkv_attention(
    qkv: torch.Tensor,
    num_heads: int,
    head_dim: int,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K1: bidirectional multi-head attention on a packed QKV tensor.

    qkv: (B, S, 3*num_heads*head_dim) laid out [q heads | k heads | v heads].
    Returns (B, S, num_heads*head_dim) in qkv.dtype. No masking.
    """
    if scale is None:
        scale = head_dim**-0.5
    if _device_kind(qkv) == "cpu":
        return packed_qkv_attention_reference(qkv, num_heads, head_dim, scale)
    _check(qkv, num_heads, head_dim, K1_MAX_SEQ)
    out = _launch(qkv, None, num_heads, head_dim, 1.0, _bf16(scale), causal=False)
    packed_qkv_attention.launches += 1
    return out


packed_qkv_attention.launches = 0


def packed_qkv_causal_attention(
    qkv: torch.Tensor,
    num_heads: int,
    head_dim: int,
    padding_mask: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K2: causal + key-padding attention off a packed (B, S, 3*H*D) QKV.

    padding_mask: (B, S) 0/1 keep-mask over keys. Queries are at offset 0.
    """
    if scale is None:
        scale = head_dim**-0.5
    if _device_kind(qkv) == "cpu":
        return packed_qkv_causal_attention_reference(
            qkv, num_heads, head_dim, padding_mask, scale
        )
    _check(qkv, num_heads, head_dim, K2_MAX_SEQ)
    b, s, _ = qkv.shape
    if padding_mask.shape != (b, s) or padding_mask.device != qkv.device:
        raise ValueError(
            f"padding_mask must be ({b}, {s}) on {qkv.device}, got "
            f"{tuple(padding_mask.shape)} on {padding_mask.device}"
        )
    mask = padding_mask.to(torch.int32).contiguous()
    out = _launch(qkv, mask, num_heads, head_dim, _bf16(scale), 1.0, causal=True)
    packed_qkv_causal_attention.launches += 1
    return out


packed_qkv_causal_attention.launches = 0
