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
launches in its ``launches`` attribute, a plain integer, the fp32 body's also
in ``launches_f32`` and the bf16 Hopper bodies' (wgmma + TMA, both of them)
also in ``launches_sm90``.

Which body a CUDA call takes is the written rule :func:`packed_body`. In
bf16, K1 up to S = ``K1_MAX_SEQ`` (384) keeps a head's K and V in shared
memory and a warpgroup's whole score rows in registers ("sm90_rows"; every
ViT geometry has S = 257); K2, and K1 past that limit, take the two-pass body
("sm90"), which keeps no score: pass 1 streams the key tiles for each row's
max and sum, pass 2 recomputes the same rounded scores and accumulates PV, so
it takes any S. The fp32 body streams the keys and takes any S. Both bf16
bodies take 128-query tiles at most (``QUERY_TILE``), the fp32 body's grid
65,535 of them.

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

# the whole-row body's key capacity (csrc/packed_attention.cu K1_MAX_S)
K1_MAX_SEQ = 384
# batch rows and heads (csrc entry points); query tiles of QUERY_TILE rows
# (the fp32 body's grid z; the bf16 two-pass body's tiles); blocks of a 1-d
# bf16 grid
_MAX_GRID = 65535
QUERY_TILE = 128
_MAX_BLOCKS = 2**31 - 1
# dynamic shared memory a block may use on the H100
MAX_SMEM = 232448


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
    (``csrc/attention_f32.cu``) for fp32 qkv; in bf16 "sm90_rows" (whole rows
    in registers) for K1 up to ``K1_MAX_SEQ``, else "sm90" (the two-pass body
    with recomputed scores). Reads the dtype and S only."""
    if qkv.dtype == torch.float32:
        return "f32"
    return "sm90" if causal or qkv.shape[1] > K1_MAX_SEQ else "sm90_rows"


def part_widths(head_dim: int) -> tuple[int, int]:
    """The columns of the (one or two) parts the bf16 bodies cut a head into
    (csrc/packed_attention.cu ``Parts``): rows of 32, 64 or 128 bytes under
    the swizzle of that width, the second part 0 up to head_dim 64. D = 80
    is (64, 16), D = 88 (64, 32), D = 48 (64, 0)."""
    d16 = -(-head_dim // 16)
    w0 = 64 if d16 >= 3 else 16 * d16
    w1 = 0 if d16 <= 4 else {5: 16, 6: 32}.get(d16, 64)
    return w0, w1


def packed_smem_bytes(body: str, s: int, head_dim: int) -> int:
    """Dynamic shared memory of one block of a bf16 body, as
    ``csrc/packed_attention.cu`` lays it out (StreamLayout, RowsLayout):
    each part of a tile in whole 1 KB blocks, then the barriers and 1 KB to
    align the base. "sm90": a 128-row Q tile, 3 K and 2 V stages of 128 keys;
    "sm90_rows": K and V at 128, 272 or 384 keys (the least that holds S)
    and a 64-row Q buffer for each of its three warpgroups (two at 384)."""
    widths = part_widths(head_dim)

    def room(rows: int) -> int:
        return sum(-(-rows * 2 * w // 1024) * 1024 for w in widths)

    if body == "sm90":
        return 6 * room(128) + 128 + 1024
    keys = 128 if s <= 128 else 272 if s <= 272 else 384
    return 2 * room(keys) + (3 if keys <= 272 else 2) * room(64) + 64 + 1024


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
    tiles = -(-qkv.shape[1] // QUERY_TILE)
    if tiles > _MAX_GRID:
        raise ValueError(f"the CUDA kernel takes at most {_MAX_GRID * QUERY_TILE} positions")
    if tiles * num_heads * qkv.shape[0] > _MAX_BLOCKS:
        raise ValueError(f"the CUDA kernel takes at most {_MAX_BLOCKS} (query tile, head, batch row) blocks")
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
    packed_qkv_attention.launches_sm90 += body in ("sm90", "sm90_rows")
    return out


packed_qkv_attention.launches = 0
packed_qkv_attention.launches_f32 = 0
packed_qkv_attention.launches_sm90 = 0


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
    packed_qkv_causal_attention.launches_sm90 += body in ("sm90", "sm90_rows")
    return out


packed_qkv_causal_attention.launches = 0
packed_qkv_causal_attention.launches_f32 = 0
packed_qkv_causal_attention.launches_sm90 = 0
