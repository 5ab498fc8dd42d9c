"""Packed-QKV attention kernels (counterpart of ``eilev_tpu/ops/fused_attention.py``).

Two wrappers, each with a plain PyTorch twin in this module:

- :func:`packed_qkv_attention` (K1): bidirectional, mask-free attention off the
  packed (B, S, 3*H*D) QKV — the EVA-ViT attention.
- :func:`packed_qkv_causal_attention` (K2): causal + (B, S) key-padding
  attention off the packed QKV with queries at offset 0 — the OPT prefill.

A wrapper runs its plain twin for a CPU tensor. For a CUDA tensor it launches
a hand-written kernel on the current stream or raises; nothing falls back:
bf16 qkv goes to ``csrc/packed_attention.cu``, fp32 qkv (an fp32 model) to
the fp32 body of ``csrc/attention_f32.cu``; any other dtype raises
``TypeError``. Neither has a backward (nor has either JAX kernel): each raises
``RuntimeError`` when grad mode is on and its input requires grad
(:func:`refuse_grad`), on both devices. Each wrapper counts its kernel
launches in its ``launches`` attribute, a plain integer, the fp32 body's also in ``launches_f32`` and
the bf16 two-pass body's also in ``launches_two_pass``.

Which body a CUDA call takes is the written rule :func:`packed_body`. In
bf16, K1 keeps a head's K and V and a warp's whole score rows on chip up to
S = ``K1_MAX_SEQ`` (384: at D = 128, K and V take 208,896 of the 232,448
bytes of shared memory a block may use; every ViT geometry has S = 257);
past it K1 runs K2's body, which keeps a query tile's bf16 scores in shared
memory, with no causal frontier. Past ``K2_MAX_SEQ`` (2,048, OPT's
positions), where a tile's scores no longer fit, both take the two-pass body,
which keeps no score: pass 1 streams the keys for each row's max and sum,
pass 2 recomputes the rounded scores and accumulates PV. The fp32 body
streams the keys and takes any S.

The twins carry the rounding points of the JAX kernels, which follow HF's bf16
numerics:

- K1: QK^T in fp32, rounded to the model dtype, scaled in the model dtype;
  fp32 softmax; probabilities rounded to the model dtype; PV in fp32.
- K2: q scaled and rounded to the model dtype before QK^T; scores rounded to
  the model dtype; masked with ``finfo(float32).min`` cast to the model dtype
  (``-inf`` in bf16, so a fully masked row is NaN there; finite in fp32, so
  there a fully masked row is the uniform average of every V row); fp32
  softmax; probabilities in the model dtype; PV in fp32.

In fp32 every rounding to the model dtype is the identity and the scale is
the fp32 one.
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import _scalar, plain_attention

# the bf16 bodies' sequence limits (csrc/packed_attention.cu K1_MAX_S, K2_MAX_S)
K1_MAX_SEQ = 384
K2_MAX_SEQ = 2048
# grid dimensions y (heads) and z (batch rows); the two-pass body's query
# tiles, the z dimension of its grid
_MAX_GRID = 65535
TWO_PASS_BQ = 64


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


def packed_body(qkv: torch.Tensor, causal: bool) -> str:
    """Which body a CUDA call of K1 (``causal=False``) or K2 takes, the rule
    of ``csrc/packed_attention.cu``'s entry point and of the wrappers: "f32"
    (``csrc/attention_f32.cu``) for fp32 qkv; in bf16, K2 always and K1 past
    ``K1_MAX_SEQ`` "streamed" (K2's body: scores in shared memory), K1 up to
    it "whole_rows" (scores in registers); both past ``K2_MAX_SEQ``
    "two_pass" (no score kept). Reads the dtype and S only."""
    if qkv.dtype == torch.float32:
        return "f32"
    if qkv.shape[1] > K2_MAX_SEQ:
        return "two_pass"
    return "streamed" if causal or qkv.shape[1] > K1_MAX_SEQ else "whole_rows"


def _check(qkv: torch.Tensor, num_heads: int, head_dim: int) -> None:
    """Raise on anything the CUDA kernels do not take."""
    if qkv.ndim != 3 or qkv.shape[2] != 3 * num_heads * head_dim:
        raise ValueError(
            f"qkv must be (B, S, 3*{num_heads}*{head_dim}), got {tuple(qkv.shape)}"
        )
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA kernels take bf16 or fp32 qkv, got {qkv.dtype}")
    if qkv.shape[0] > _MAX_GRID or num_heads > _MAX_GRID:
        raise ValueError(f"the CUDA kernel takes at most {_MAX_GRID} batch rows and heads")
    if -(-qkv.shape[1] // TWO_PASS_BQ) > _MAX_GRID:
        raise ValueError(f"the CUDA kernel takes at most {_MAX_GRID * TWO_PASS_BQ} positions")
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
    """Launch the body :func:`packed_body` names; ``q_scale`` and ``s_scale``
    are already in the model dtype."""
    from ._build import attention_f32_lib, packed_attention_lib

    b, s, _ = qkv.shape
    hd = num_heads * head_dim
    out = torch.empty(b, s, hd, dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    mask_ptr = None if mask is None else mask.data_ptr()
    if packed_body(qkv, causal) == "f32":
        # q, k, v as three (B, S, H, D) views of the packed rows, 4-byte elements
        base, row = qkv.data_ptr(), 3 * hd
        rc = attention_f32_lib().eilev_attention_f32(
            base, base + 4 * hd, base + 8 * hd, mask_ptr, None, out.data_ptr(),
            b, s, s, num_heads, num_heads, head_dim,
            s * row, row, s * row, row, s * row, row, s * hd, hd,
            q_scale, s_scale, int(causal), 0, 1, stream,
        )
    else:
        rc = packed_attention_lib().eilev_packed_attention_bf16(
            qkv.data_ptr(), mask_ptr, out.data_ptr(), b, s, num_heads, head_dim,
            q_scale, s_scale, int(causal), stream,
        )
    if rc != 0:
        raise RuntimeError(f"packed attention kernel launch failed: cudaError_t {rc}")
    return out


def _bf16(value: float) -> float:
    """``value`` rounded to bf16, as the JAX kernels round a scale before use."""
    return float(torch.tensor(value, dtype=torch.bfloat16))


def _model_scale(value: float, dtype: torch.dtype) -> float:
    """A scale as the JAX kernels apply it in the model dtype
    (``jnp.asarray(scale, dtype)``): rounded to bf16 for a bf16 model, the
    fp32 value (ctypes rounds it to fp32) for an fp32 one."""
    return _bf16(value) if dtype == torch.bfloat16 else float(value)


def refuse_grad(wrapper: str, twin: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise ``RuntimeError`` when grad mode is on and an input requires grad.

    No kernel of this package has a backward, as no Pallas kernel has one in
    the JAX package: a kernel's output would leave the autograd graph without
    a word. Every wrapper calls this before it dispatches, so the same call
    fails in the same way on the CPU (where the wrapper would run its
    differentiable twin) and on the card. The twins stay differentiable."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{wrapper} has no backward: an input requires grad. Run it under "
            f"torch.no_grad(), or differentiate through its plain twin {twin}"
        )


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
    refuse_grad("packed_qkv_attention", "packed_qkv_attention_reference", qkv)
    if scale is None:
        scale = head_dim**-0.5
    if _device_kind(qkv) == "cpu":
        return packed_qkv_attention_reference(qkv, num_heads, head_dim, scale)
    _check(qkv, num_heads, head_dim)
    out = _launch(qkv, None, num_heads, head_dim, 1.0, _model_scale(scale, qkv.dtype), causal=False)
    body = packed_body(qkv, causal=False)
    packed_qkv_attention.launches += 1
    packed_qkv_attention.launches_f32 += body == "f32"
    packed_qkv_attention.launches_two_pass += body == "two_pass"
    return out


packed_qkv_attention.launches = 0
packed_qkv_attention.launches_f32 = 0
packed_qkv_attention.launches_two_pass = 0


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
    refuse_grad("packed_qkv_causal_attention", "packed_qkv_causal_attention_reference", qkv)
    if scale is None:
        scale = head_dim**-0.5
    if _device_kind(qkv) == "cpu":
        return packed_qkv_causal_attention_reference(
            qkv, num_heads, head_dim, padding_mask, scale
        )
    _check(qkv, num_heads, head_dim)
    b, s, _ = qkv.shape
    if padding_mask.shape != (b, s) or padding_mask.device != qkv.device:
        raise ValueError(
            f"padding_mask must be ({b}, {s}) on {qkv.device}, got "
            f"{tuple(padding_mask.shape)} on {padding_mask.device}"
        )
    mask = padding_mask.to(torch.int32).contiguous()
    out = _launch(qkv, mask, num_heads, head_dim, _model_scale(scale, qkv.dtype), 1.0, causal=True)
    body = packed_body(qkv, causal=True)
    packed_qkv_causal_attention.launches += 1
    packed_qkv_causal_attention.launches_f32 += body == "f32"
    packed_qkv_causal_attention.launches_two_pass += body == "two_pass"
    return out


packed_qkv_causal_attention.launches = 0
packed_qkv_causal_attention.launches_f32 = 0
packed_qkv_causal_attention.launches_two_pass = 0
