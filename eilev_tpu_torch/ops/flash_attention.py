"""Flash attention forward (counterpart of ``eilev_tpu/ops/flash_attention.py``).

K5: :func:`flash_attention` replaces the Pallas kernel ``flash_attention``
(``eilev_tpu/ops/flash_attention.py:157``, body ``_flash_kernel`` :52). Its
plain PyTorch twin, :func:`flash_attention_reference`, is in this module.
``ops/attention.py:dot_product_attention`` reaches it under ``impl='flash'``
and, in ``auto`` mode, for q >= 1024 and kv >= 2048 (the LLaMA prefill into a
long cache).

A CPU tensor runs the twin. A CUDA tensor launches a hand-written kernel on
the current stream or raises; nothing falls back. bf16 q, k, v go to
``csrc/flash_attention.cu``, whose entry point chooses between two bodies by
the rule :func:`uses_sm90_body` states: a Hopper body (wgmma + TMA) for D =
128 with no bias, the form the LLaMA prefill calls, and an mma.sync body for
the rest; the entry point says which body it launched. fp32 q, k, v (an fp32
model) go to the fp32 body of ``csrc/attention_f32.cu``; other or mixed
dtypes raise ``TypeError``. The wrapper counts every launch in
``flash_attention.launches``, the Hopper body's also in
``flash_attention.launches_sm90`` and the fp32 body's in
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
bytes).
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
#: the head dim of the Hopper body, and the shared memory one H100 block may use
SM90_HEAD_DIM = 128
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
    additive, fp32. Returns (B, S, H, D) in q.dtype. The recurrence runs in
    fp32, or in fp64 for fp64 inputs (a yardstick for the fp32 body's
    numerics).
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


def sm90_smem_bytes(kv_len: int) -> int:
    """Dynamic shared memory of one block of the Hopper body (csrc
    ``hopper::smem_bytes``): Q, two K and two V tiles of 128 x 128 bf16, the
    mbarriers, 4 keep-bit words and one list entry per 128-key tile, and 1 KB
    to align the base."""
    tiles = -(-kv_len // BLOCK_KV)
    return 5 * 128 * SM90_HEAD_DIM * 2 + 128 + tiles * 4 * 4 + tiles * 4 + 1024


def uses_sm90_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> bool:
    """Which body of ``csrc/flash_attention.cu`` a bf16 CUDA call takes: the
    rule of the source's ``hopper::takes``, which decides, stated here for
    the tests. The Hopper body (wgmma + TMA) takes head_dim 128 with
    no bias, where each of q, k, v has rows and batches that do not overlap
    (row stride >= heads * head_dim, batch stride >= rows * row stride) and
    the block's shared memory fits at the key length. Everything else (head
    dims other than 128, an (H, S, L) bias, other strides) takes the
    mma.sync body, and fp32 takes neither (``csrc/attention_f32.cu``). Reads
    the dtype, shapes and strides only."""
    d = q.shape[3]
    if q.dtype != torch.bfloat16 or d != SM90_HEAD_DIM or bias is not None:
        return False
    for t in (q, k, v):
        batch, rows, heads = t.shape[:3]
        if t.stride(1) < heads * d or (batch > 1 and t.stride(0) < rows * t.stride(1)):
            return False
    return sm90_smem_bytes(k.shape[1]) <= SMEM_LIMIT


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
    their strides (a layer slice of the stacked cache needs no copy).
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
    mask = None if padding_mask is None else padding_mask.to(torch.int32).contiguous()
    bias32 = None if bias is None else bias.to(torch.float32).contiguous()
    q_scale, s_scale = 1.0, 1.0
    if scale is not None and scale_query_first:
        q_scale = _model_scale(scale, q.dtype)  # jnp.asarray(scale, q.dtype)
    elif scale is not None:
        s_scale = float(scale)  # an fp32 multiply of the fp32 score
    out = torch.empty(b, s, h, d, dtype=q.dtype, device=q.device)
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.float32:
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
    sm90 = ctypes.c_int(0)  # which body the kernel launched
    rc = flash_attention_lib().eilev_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
        None if bias32 is None else bias32.data_ptr(), out.data_ptr(),
        b, s, l, h, kvh, d, *strides, q_scale, s_scale, int(causal), int(q_offset), stream,
        ctypes.byref(sm90),
    )
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError_t {rc}")
    flash_attention.launches += 1
    flash_attention.launches_sm90 += sm90.value
    return out


flash_attention.launches = 0
flash_attention.launches_sm90 = 0
flash_attention.launches_f32 = 0
