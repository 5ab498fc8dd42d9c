"""Flash attention forward (counterpart of ``eilev_tpu/ops/flash_attention.py``).

K5: :func:`flash_attention` replaces the Pallas kernel ``flash_attention``
(``eilev_tpu/ops/flash_attention.py:157``, body ``_flash_kernel`` :52). Its
plain PyTorch twin, :func:`flash_attention_reference`, is in this module.
``ops/attention.py:dot_product_attention`` reaches it under ``impl='flash'``
and, in ``auto`` mode, for q >= 1024 and kv >= 2048 (the LLaMA prefill into a
long cache).

A CPU tensor runs the twin. A CUDA tensor launches a hand-written kernel on
the current stream or raises; nothing falls back. bf16 q, k, v go to
``csrc/flash_attention.cu``, whose entry point chooses between three bodies by
the rule :func:`k5_body` states: a decode body (a GEMV split over the key
tiles) for calls of at most ``DECODE_MAX_Q`` query rows, the T5 decoder's and
the serving engine's one-query steps; a Hopper body (wgmma + TMA) for head
dim 128 with no bias (the LLaMA prefill) and head dim 64 with no bias or a
bf16 bias in padded rows (the T5 encoder, VideoMAE, the Q-Former); and an
mma.sync body for the rest. The entry point says which body it launched.
The keep-mask (1-, 4- or 8-byte integers with contiguous keys) and the bias
(bf16 or fp32) are read in place through their strides: an expanded (1, L)
mask and a bias view need no copy. fp32 q, k, v (an fp32 model) go to the
fp32 body of ``csrc/attention_f32.cu`` (an fp32 bias, contiguous); other or
mixed dtypes raise ``TypeError``. The wrapper counts every launch in
``flash_attention.launches``, the Hopper body's also in
``flash_attention.launches_sm90``, the decode body's in
``flash_attention.launches_decode`` and the fp32 body's in
``flash_attention.launches_f32``. It has no backward, as the Pallas kernel
has none: with grad mode on, an input that requires grad raises
``RuntimeError`` on both devices.

What it computes is the Pallas body, not its blocking. The rounding points:

- q-side scale (``scale_query_first``): ``q * scale`` rounded to q's dtype
  before QK^T;
- QK^T accumulates in fp32 and is never rounded to the model dtype; a
  score-side scale multiplies the fp32 score by the fp32 scale; the (H, S, L)
  bias is added in fp32;
- masked keys (index >= kv_len, padding 0, causal ``k > q + q_offset``) take
  ``finfo(float32).min``;
- online softmax over key blocks of 128 from key 0: ``p = exp(s - m)`` zeroed
  where masked, cast to v's dtype un-normalised before PV; the fp32
  accumulator is rescaled by ``alpha`` as the running max moves;
- the output is ``acc / l`` with ``l == 0`` replaced by 1, so a fully masked
  row is exactly 0, never NaN (the plain path gives NaN there in bf16).

In fp32 the cast of p is the identity and a q-side scale is the fp32 one, so
the recurrence equals a softmax over the kept keys to fp32 rounding.

Because bf16 rounding of p depends on the running max, the twin runs the same
recurrence over the same 128-key blocks as the kernel.

What bounds it on the H100: at the LLaMA prefill (q 1,984 over a 2,048-slot
cache, 32 heads x 128, causal) one layer needs ~32 GFLOP of tensor-core work
against ~33 MB of traffic: compute-bound (33 us at 989 TFLOP/s, 10 us of
bytes). A one-query step is bound by bytes: every K and V row it keeps is
read once for 4 flops an element.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .attention import _scalar
from .fused_attention import _device_kind, _model_scale, refuse_grad

#: keys per block of the online softmax (the Pallas DEFAULT_BLOCK_KV)
BLOCK_KV = 128
NEG_INF = torch.finfo(torch.float32).min
#: the head dims of the Hopper body (a bias only at 64), the query rows the
#: decode body takes at most, and the shared memory one H100 block may use
SM90_HEAD_DIMS = (64, 128)
DECODE_MAX_Q = 4
SMEM_LIMIT = 227 * 1024


def _check_shapes(q, k, v, padding_mask, bias) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, S, H, D) and k, v (B, L, KVH, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    l, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kvh:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         "(kv heads must divide the query heads)")
    if padding_mask is not None and tuple(padding_mask.shape) != (b, l):
        raise ValueError(f"padding_mask must be ({b}, {l}), got {tuple(padding_mask.shape)}")
    if bias is not None and tuple(bias.shape) != (h, s, l):
        raise ValueError(f"bias must be (H, S, L) = ({h}, {s}, {l}), got {tuple(bias.shape)}")


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    padding_mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    causal: bool = False,
    q_offset: int = 0,
    scale: Optional[float] = None,
    scale_query_first: bool = False,
) -> torch.Tensor:
    """Plain twin of K5: the Pallas body's recurrence over 128-key blocks.

    q: (B, S, H, D); k, v: (B, L, KVH, D) with KVH dividing H (head h reads kv
    head h // (H // KVH)); padding_mask: (B, L) 0/1 keep-mask; bias: (H, S, L)
    additive, of any float dtype and strides, added in fp32. Returns (B, S, H,
    D) in q.dtype. The recurrence runs in fp32, or in fp64 for fp64 inputs
    (a yardstick for the fp32 body's numerics).
    """
    _check_shapes(q, k, v, padding_mask, bias)
    b, s, h, d = q.shape
    l, kvh = k.shape[1], k.shape[2]
    if scale is not None and scale_query_first:
        q = q * _scalar(scale, q)
    group = h // kvh
    work = torch.float64 if q.dtype == torch.float64 else torch.float32
    qh = q.permute(0, 2, 1, 3).to(work)  # (B, H, S, D)
    kh = k.permute(0, 2, 1, 3).to(work).repeat_interleave(group, dim=1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    q_pos = torch.arange(s, device=q.device)[:, None] + q_offset
    m = torch.full((b, h, s, 1), NEG_INF, dtype=work, device=q.device)
    l_sum = torch.zeros((b, h, s, 1), dtype=work, device=q.device)
    acc = torch.zeros((b, h, s, d), dtype=work, device=q.device)
    for k0 in range(0, l, BLOCK_KV):
        if causal and k0 > q_offset + s - 1:
            break  # every later block is wholly masked: a no-op in the recurrence
        k1 = min(k0 + BLOCK_KV, l)
        sc = qh @ kh[:, :, k0:k1].transpose(-1, -2)  # (B, H, S, bk) in `work`
        if scale is not None and not scale_query_first:
            sc = sc * scale
        if bias is not None:
            sc = sc + bias[None, :, :, k0:k1].to(work)
        masked = torch.zeros(1, 1, s, k1 - k0, dtype=torch.bool, device=q.device)
        if padding_mask is not None:
            masked = masked | (padding_mask[:, None, None, k0:k1] == 0)
        if causal:
            k_pos = torch.arange(k0, k1, device=q.device)[None, :]
            masked = masked | (k_pos > q_pos)[None, None]
        sc = torch.where(masked, NEG_INF, sc)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        ref = torch.where(m_new == NEG_INF, 0.0, m_new)
        p = torch.where(masked, 0.0, torch.exp(sc - ref))
        alpha = torch.where(m == NEG_INF, 0.0, torch.exp(m - ref))
        l_sum = alpha * l_sum + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).to(work) @ vh[:, :, k0:k1].to(work)
        m = m_new
    out = acc / torch.where(l_sum == 0.0, 1.0, l_sum)
    return out.to(q.dtype).permute(0, 2, 1, 3)


def _check_cuda(q, k, v, padding_mask, bias) -> None:
    """Raise on anything the CUDA kernels do not take."""
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the CUDA kernels take q, k, v all bf16 or all fp32, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    d = q.shape[3]
    if d > 128 or (q.dtype == torch.bfloat16 and d % 8):
        # the fp32 body pads the head dim itself: any head_dim up to 128
        raise ValueError(f"the CUDA kernel takes head_dim <= 128, and % 8 == 0 in bf16, got {d}")
    others = [t for t in (k, v, padding_mask, bias) if t is not None]
    if any(t.device != q.device for t in others):
        raise ValueError("q, k, v, the padding mask and the bias must be on one device")
    step = 8 if q.dtype == torch.bfloat16 else 1
    for name, t in (("q", q), ("k", k), ("v", v)):
        # bf16 rows are read with 16-byte loads: (B, rows, heads, D) with the
        # heads and D packed, the row and batch strides multiples of 8 elements
        # (the fp32 body reads elements: any row and batch strides)
        if t.stride(3) != 1 or t.stride(2) != d or t.stride(1) % step or t.stride(0) % step:
            raise ValueError(f"the CUDA kernel takes {name} with packed (heads, D) rows "
                             f"and strides that are multiples of 8, got {t.stride()}")
        if t.data_ptr() % (16 if step == 8 else 4):
            raise ValueError(f"the CUDA kernel takes an aligned {name}")


def sm90_smem_bytes(kv_len: int, head_dim: int = 128, bias: bool = False) -> int:
    """Dynamic shared memory of one block of the Hopper body (csrc
    ``hopper::smem_bytes``): at head dim 128 a block of 128 queries, at 64 of
    64; Q, two K and two V tiles of 128 keys x ``head_dim`` bf16, two bias
    tiles of the block's queries x 128 keys bf16 with a bias, the mbarriers,
    4 keep-bit words and one list entry per 128-key tile, and 1 KB to align
    the base."""
    tiles = -(-kv_len // BLOCK_KV)
    rows = 128 if head_dim == 128 else 64
    fixed = (head_dim // 64) * (rows + 4 * BLOCK_KV) * 64 * 2 + (2 * rows * BLOCK_KV * 2 if bias else 0)
    return fixed + 128 + tiles * 4 * 4 + tiles * 4 + 1024


def decode_smem_bytes(kv_len: int) -> int:
    """Dynamic shared memory of one block of the decode body (csrc
    ``decode::smem_bytes``): each 128-key tile's fp32 scores, up to 16
    segment maxima and its running max, and 16 warps' partial output rows
    (128 floats) and sums."""
    tiles = -(-kv_len // BLOCK_KV)
    return tiles * BLOCK_KV * 4 + tiles * 16 * 4 + tiles * 4 + 16 * (128 + 1) * 4


def _sm90_bias_ok(bias: torch.Tensor) -> bool:
    """A bias the Hopper body's tensor map reads: bf16, contiguous keys, rows
    and heads on 16-byte boundaries (the T5 module's padded rows)."""
    return (bias.dtype == torch.bfloat16 and bias.stride(2) == 1 and bias.stride(1) % 8 == 0
            and bias.stride(0) % 8 == 0 and bias.data_ptr() % 16 == 0)


def k5_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> str:
    """Which body of K5 a CUDA call takes: the rule of the source's
    ``choose_body``, which decides, stated here for the tests. Reads dtypes,
    shapes, strides and the bias's alignment only; first match wins:

    - ``"f32"``: fp32 q, k, v (``csrc/attention_f32.cu``);
    - ``"decode"``: at most ``DECODE_MAX_Q`` query rows whose key tiles'
      scores fit in shared memory (any head dim, bias or strides);
    - ``"sm90"``: head dim 128 with no bias, or 64 with no bias or a bf16
      bias of contiguous keys whose rows and heads start on 16-byte
      boundaries; each of q, k, v with rows and batches that do not overlap
      (row stride >= heads * head_dim, batch stride >= rows * row stride);
      the block's shared memory fits at the key length;
    - ``"mma"``: everything else (other head dims, head dim 128 with a
      bias, an fp32 bias, overlapping strides).
    """
    if q.dtype == torch.float32:
        return "f32"
    s, d, l = q.shape[1], q.shape[3], k.shape[1]
    if s <= DECODE_MAX_Q and decode_smem_bytes(l) <= SMEM_LIMIT:
        return "decode"
    if d not in SM90_HEAD_DIMS or (bias is not None and (d != 64 or not _sm90_bias_ok(bias))):
        return "mma"
    for t in (q, k, v):
        batch, rows, heads = t.shape[:3]
        if t.stride(1) < heads * d or (batch > 1 and t.stride(0) < rows * t.stride(1)):
            return "mma"
    return "sm90" if sm90_smem_bytes(l, d, bias is not None) <= SMEM_LIMIT else "mma"


def uses_sm90_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> bool:
    """Whether a CUDA call takes the Hopper body: :func:`k5_body`'s
    ``"sm90"`` case."""
    return k5_body(q, k, v, bias) == "sm90"


def _mask_in_place(padding_mask: torch.Tensor) -> torch.Tensor:
    """The keep-mask as the bf16 bodies read it: 1-, 4- or 8-byte integers
    (bool included) with contiguous keys, read in place through the batch
    stride (0 for a (1, L) mask expanded to (B, L)); anything else converted
    to int32."""
    if padding_mask.element_size() in (1, 4, 8) and not padding_mask.is_floating_point() \
            and padding_mask.stride(1) == 1:
        return padding_mask
    return padding_mask.to(torch.int32).contiguous()


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    padding_mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    causal: bool = False,
    q_offset: int = 0,
    scale: Optional[float] = None,
    scale_query_first: bool = False,
) -> torch.Tensor:
    """K5: flash attention forward. Arguments as for the twin.

    On the card q, k, v are all bf16 or all fp32 and read in place through
    their strides (a layer slice of the stacked cache needs no copy); in bf16
    so are the keep-mask and the bias (bf16 or fp32).
    """
    refuse_grad("flash_attention", "flash_attention_reference", q, k, v, bias)
    if _device_kind(q) == "cpu":
        return flash_attention_reference(
            q, k, v, padding_mask=padding_mask, bias=bias, causal=causal,
            q_offset=q_offset, scale=scale, scale_query_first=scale_query_first,
        )
    from ._build import attention_f32_lib, flash_attention_lib

    _check_shapes(q, k, v, padding_mask, bias)
    _check_cuda(q, k, v, padding_mask, bias)
    b, s, h, d = q.shape
    l, kvh = k.shape[1], k.shape[2]
    q_scale, s_scale = 1.0, 1.0
    if scale is not None and scale_query_first:
        q_scale = _model_scale(scale, q.dtype)  # jnp.asarray(scale, q.dtype)
    elif scale is not None:
        s_scale = float(scale)  # an fp32 multiply of the fp32 score
    out = torch.empty(b, s, h, d, dtype=q.dtype, device=q.device)
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.float32:
        mask = None if padding_mask is None else padding_mask.to(torch.int32).contiguous()
        bias32 = None if bias is None else bias.to(torch.float32).contiguous()
        rc = attention_f32_lib().eilev_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
            None if bias32 is None else bias32.data_ptr(), out.data_ptr(),
            b, s, l, h, kvh, d, *strides, s * h * d, h * d, q_scale, s_scale, int(causal),
            int(q_offset), 0, stream,
        )
        if rc != 0:
            raise RuntimeError(f"flash attention kernel launch failed: cudaError_t {rc}")
        flash_attention.launches += 1
        flash_attention.launches_f32 += 1
        return out
    mask = None if padding_mask is None else _mask_in_place(padding_mask)
    mask_args = (None, 0, 4) if mask is None else (mask.data_ptr(), mask.stride(0), mask.element_size())
    if bias is None:
        bias_args = (None, 0, 0, 0, 0)
    else:
        if bias.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"the bf16 kernel takes a bf16 or fp32 bias, got {bias.dtype}")
        bias_args = (bias.data_ptr(), *bias.stride(), int(bias.dtype == torch.bfloat16))
    body = ctypes.c_int(0)  # which body the kernel launched: 0 mma.sync, 1 Hopper, 2 decode
    rc = flash_attention_lib().eilev_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *mask_args, *bias_args, out.data_ptr(),
        b, s, l, h, kvh, d, *strides, q_scale, s_scale, int(causal), int(q_offset), stream,
        ctypes.byref(body),
    )
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError_t {rc}")
    flash_attention.launches += 1
    flash_attention.launches_sm90 += body.value == 1
    flash_attention.launches_decode += body.value == 2
    return out


flash_attention.launches = 0
flash_attention.launches_sm90 = 0
flash_attention.launches_decode = 0
flash_attention.launches_f32 = 0
