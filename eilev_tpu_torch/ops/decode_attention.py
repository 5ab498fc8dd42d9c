"""Decode-step attention over the stacked KV cache (counterpart of
``eilev_tpu/ops/decode_attention.py``).

One wrapper, :func:`decode_attention_stacked`, with its plain PyTorch twin
:func:`decode_attention_stacked_reference` in this module. It attends one new
query token against layer ``layer`` of the stacked (L, B, S, KVH*hd) cache
under a (B, S) keep-mask, for both cache types:

- K3: a model-dtype cache;
- K4: an int8 cache with bf16 per-(position, kv-head) scales, dequantized to
  the model dtype before each dot.

A CPU tensor runs the twin. A CUDA tensor launches the hand-written kernel of
``csrc/decode_attention.cu`` on the current stream or raises; nothing falls
back. The model dtype is bf16 or fp32: a bf16 query over a bf16 or int8
cache, or an fp32 query over an fp32 or int8 cache; anything else raises
``TypeError``. The wrapper counts its launches by cache in
``decode_attention_stacked.launches_bf16`` (K3, bf16 cache),
``.launches_f32`` (K3, fp32 cache) and ``.launches_int8`` (K4), and the K4
launches with an fp32 query also in ``.launches_int8_f32``. It has no
backward: with grad mode on, an input that requires grad raises
``RuntimeError`` on both devices.

On the card a bf16 model runs the split body for K4, and for K3 where the
written rule :func:`k3_split` says so: the S slots are split over a
thread-block cluster of :func:`cluster_size` blocks per (head, row), which
exchange the row's max and sum through distributed shared memory, all in
one launch (see the source's notes). The other bf16 K3 calls run one
256-thread block per (head, batch row). An fp32 model runs the fp32 body
for K3 and K4 alike (:func:`decode_body`): 8 values a lane (D / 8 lanes a
row), a cluster of :func:`f32_cluster_size` blocks, each reduced to a
flash-decoding state (its max, sum and unnormalised output; p's rounding to
fp32 is the identity), which one exchange combines in rank order. Where
:func:`f32_staged` says so a block first copies its kept K and V rows into
shared memory; else it streams them through registers over a compacted list
of its kept slots. A row with no kept slot takes a rare path after the
exchange that reads every V row.

Rounding points, as in the JAX kernel bodies: ``scale_query=True`` (HF OPT)
rounds ``q * bf16(scale)`` to the model dtype before QK^T; QK^T accumulates in
fp32 and is rounded to the model dtype; ``scale_query=False`` (HF LLaMA)
multiplies the rounded scores by ``bf16(scale)``; masked slots take
``finfo(float32).min`` in the model dtype (``-inf`` in bf16, so a fully masked
row is NaN there; finite in fp32, so there a fully masked row is the uniform
average of every slot's V row); fp32 softmax; probabilities rounded to the
model dtype; PV accumulates in fp32. Head ``h`` reads kv head
``h // (num_heads // kv_heads)``. In fp32 every rounding to the model dtype
is the identity and the scale is the fp32 one.

The int8 write side, :func:`quantize_kv`, gives the same int8 values and bf16
scales as the JAX function, bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import plain_attention
from .fused_attention import _device_kind, _model_scale, refuse_grad

#: dynamic shared memory one block may use on an H100 (232,448 bytes)
SMEM_LIMIT = 227 * 1024
#: threads per block of the CUDA kernels (csrc/decode_attention.cu THREADS)
THREADS = 256
WARPS = THREADS // 32
#: streaming multiprocessors of an H100 SXM, and the largest portable cluster
SMS = 132
MAX_CLUSTER = 8
#: shared memory of one SM (233,472 bytes), and what the card reserves of it for each block
SM_SMEM = 228 * 1024
BLOCK_RESERVED = 1024
#: blocks of the fp32 body one SM holds at most (its registers: __launch_bounds__(256, 3))
F32_BLOCKS = 3
#: the clusters of C blocks of the fp32 body one wave of an H100 SXM holds
#: (cudaOccupancyMaxActiveClusters at F32_BLOCKS blocks an SM; a cluster's
#: blocks share a GPC), C = 1 .. 8
F32_WAVE_CLUSTERS = (0, 396, 198, 124, 92, 69, 62, 47, 45)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., H, hd) model-dtype K or V rows -> (int8 values (..., H, hd), bf16
    per-head scales (..., H)) for the int8 cache buffers."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).to(torch.bfloat16)
    sf = scale.float()
    inv = torch.where(sf > 0, 1.0 / sf, torch.zeros_like(sf))[..., None]
    vals = torch.clamp(torch.round(xf * inv), -127, 127).to(torch.int8)
    return vals, scale


def dequantize_kv(
    vals: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """(..., H, hd) int8 + (..., H) scales -> (..., H, hd) in ``dtype``."""
    return (vals.float() * scale.float()[..., None]).to(dtype)


def _shapes(q, k_buf, v_buf, mask, layer, num_heads, head_dim, kv_heads, k_scale, v_scale):
    """Raise on shapes the function does not take; return (B, S)."""
    b, d = q.shape
    n_layers, bb, s_len, packed = k_buf.shape
    if bb != b or packed != kv_heads * head_dim or d != num_heads * head_dim:
        raise ValueError(
            f"q {tuple(q.shape)} and cache {tuple(k_buf.shape)} do not fit "
            f"{num_heads} heads x {head_dim} over {kv_heads} kv heads"
        )
    if num_heads % kv_heads:
        raise ValueError(f"num_heads ({num_heads}) must be a multiple of kv_heads ({kv_heads})")
    if v_buf.shape != k_buf.shape or v_buf.dtype != k_buf.dtype:
        raise ValueError("k_buf and v_buf must have the same shape and dtype")
    if tuple(mask.shape) != (b, s_len):
        raise ValueError(f"mask must be ({b}, {s_len}), got {tuple(mask.shape)}")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} out of range for {n_layers} cache layers")
    is_int8 = k_buf.dtype == torch.int8
    if (k_scale is not None) != is_int8 or (v_scale is not None) != is_int8:
        raise ValueError("k_scale/v_scale go with an int8 cache, and only with one")
    if is_int8:
        want = (n_layers, b, s_len, kv_heads)
        if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
            raise ValueError(f"k_scale/v_scale must be {want}")
    return b, s_len


def decode_attention_stacked_reference(
    q: torch.Tensor,
    k_buf: torch.Tensor,
    v_buf: torch.Tensor,
    mask: torch.Tensor,
    layer: int,
    *,
    num_heads: int,
    head_dim: int,
    kv_heads: Optional[int] = None,
    scale: Optional[float] = None,
    scale_query: bool = True,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain twin of K3/K4: the JAX dequant + ``_xla_attention`` decode step.

    q: (B, num_heads*head_dim); k_buf/v_buf: (L, B, S, kv_heads*head_dim) in
    the model dtype, or int8 with ``k_scale``/``v_scale`` (L, B, S, kv_heads);
    mask: (B, S) 0/1 keep-mask. Returns (B, num_heads*head_dim) in q.dtype.
    """
    kv_heads = kv_heads or num_heads
    if scale is None:
        scale = head_dim**-0.5
    b, s_len = _shapes(q, k_buf, v_buf, mask, layer, num_heads, head_dim, kv_heads, k_scale, v_scale)
    k = k_buf[layer].reshape(b, s_len, kv_heads, head_dim)
    v = v_buf[layer].reshape(b, s_len, kv_heads, head_dim)
    if k_scale is not None:
        k = dequantize_kv(k, k_scale[layer], q.dtype)
        v = dequantize_kv(v, v_scale[layer], q.dtype)
    group = num_heads // kv_heads
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    out = plain_attention(
        q.reshape(b, 1, num_heads, head_dim), k, v,
        padding_mask=mask, scale=scale, scale_query_first=scale_query, softmax_in_fp32=True,
    )
    return out.reshape(b, num_heads * head_dim)


def k3_split(batch: int, heads: int, s_len: int) -> bool:
    """Whether a bf16 K3 call runs the split body, the written rule of
    ``csrc/decode_attention.cu:k3_split``: when one block per (head, row)
    would leave at least half of the SMs idle, 2 * batch * heads <= 132 (the
    text LM's and the narration's batch-1 decode split; the narration's
    batch 4, 128 blocks, does not: there the split was slower on an H100,
    see the source). It depends on the shape only. (K4 and fp32 K3 always
    run the split.)"""
    return 2 * batch * heads <= SMS


def cluster_size(batch: int, heads: int, s_len: int) -> int:
    """Blocks the split gives one (head, batch row), the written rule of
    ``csrc/decode_attention.cu:cluster_size``: the smallest C with
    batch * heads * C >= 2 x 132 SMs, capped at 8 (the portable cluster
    size) and at the number of 32-slot chunks. It depends on the shape only,
    so a shape always sums in the same order."""
    c = -(-2 * SMS // (batch * heads))
    return max(1, min(c, MAX_CLUSTER, -(-s_len // 32)))


def split_smem_bytes(s_len: int, head_dim: int, cluster: int) -> int:
    """Shared memory of one block of the split in a cluster of ``cluster`` (csrc
    ``split_smem_bytes``): its n = ceil(S / cluster) fp32 scores and keep
    bits, each warp's PV partial sums, the partial outputs rank 0 gathers (one
    row of head_dim per rank), reduction scratch, and the max and sum every
    rank receives."""
    n = -(-s_len // cluster)
    return 4 * (n + -(-n // 32) + WARPS * head_dim + MAX_CLUSTER * head_dim + WARPS + 2 * MAX_CLUSTER)


#: the fp32 body's blocks take the cache's slots in groups of this many
#: (csrc F32_GROUP), block rank r every cluster-th group from the r-th
F32_GROUP = 8


def f32_slots(s_len: int, cluster: int) -> int:
    """The most slots one block of the fp32 body takes (csrc ``f32_slots``):
    ``F32_GROUP`` times ceil(ceil(S / F32_GROUP) / cluster)."""
    return F32_GROUP * -(-(-(-s_len // F32_GROUP)) // cluster)


def f32_k_stride(head_dim: int, elem: int) -> int:
    """A staged K row's stride in elements in the fp32 body (csrc
    ``f32_k_stride``): the row's 16-byte chunks rounded up to an odd number,
    so threads reading consecutive rows 16 bytes at a time hit distinct
    shared-memory banks."""
    return (head_dim * elem // 16 | 1) * 16 // elem


def f32_smem_bytes(s_len: int, head_dim: int, cluster: int, int8: bool, staged: bool) -> int:
    """Shared memory of one block of the fp32 body (csrc ``f32_smem_bytes``):
    the (max, sum) pairs of the 8 warps and of up to 8 ranks; when
    ``staged``, its n = :func:`f32_slots` slots of K (at
    :func:`f32_k_stride`) and of V (fp32, or int8 for an int8 cache), the
    query and their scores, else the kept slots' indices and their counts
    before each 32-slot word; reduction scratch, each warp's partial output,
    the partial outputs rank 0 gathers, the keep bits, and for an int8 cache
    the slots' two scales in fp32."""
    n = f32_slots(s_len, cluster)
    words = -(-n // 32)
    elem = 1 if int8 else 4
    rows = n * (f32_k_stride(head_dim, elem) + head_dim) * elem + 4 * (n + head_dim) if staged else 4 * (words + n)
    return (8 * (WARPS + MAX_CLUSTER) + rows
            + 4 * (WARPS + (WARPS + MAX_CLUSTER) * head_dim + words + (2 * n if int8 else 0)))


def f32_cluster_size(batch: int, heads: int, s_len: int) -> int:
    """Blocks the fp32 body gives one (head, batch row), the written rule of
    ``csrc/decode_attention.cu:f32_cluster_size``: :func:`cluster_size`,
    lowered while the batch * heads clusters would not fit one wave
    (``F32_WAVE_CLUSTERS``)."""
    c = cluster_size(batch, heads, s_len)
    while c > 1 and batch * heads > F32_WAVE_CLUSTERS[c]:
        c -= 1
    return c


def f32_staged(batch: int, heads: int, s_len: int, head_dim: int, int8: bool) -> bool:
    """Whether the fp32 body first copies a block's kept K and V rows into
    shared memory (one round of copies) instead of streaming them through
    registers, the written rule of ``csrc/decode_attention.cu:f32_staged``:
    where that costs no occupancy, i.e. the block's shared memory with them
    stays within the SM's 228 KB over the ``F32_BLOCKS`` blocks its registers
    allow, less the 1 KB reserved a block (76,800 bytes). It depends on the
    shape only."""
    cluster = f32_cluster_size(batch, heads, s_len)
    return f32_smem_bytes(s_len, head_dim, cluster, int8, True) <= SM_SMEM // F32_BLOCKS - BLOCK_RESERVED


def smem_bytes(s_len: int, head_dim: int) -> int:
    """Dynamic shared memory of one block of the one-block bf16 K3 body (csrc
    ``smem_bytes``): fp32 scores of all S slots, the scaled query, the PV
    partial sums and the reduction scratch."""
    return 4 * (s_len + head_dim + THREADS * 8 + 32)


def uses_split(q: torch.Tensor, k_buf: torch.Tensor, head_dim: int) -> bool:
    """Whether a CUDA call splits S over a cluster of :func:`cluster_size`
    blocks: always with an fp32 model (its own body, :func:`decode_body`) and
    over an int8 cache; over a bf16 cache where :func:`k3_split` says so.
    Reads dtypes and shapes only."""
    b, s_len = q.shape[0], k_buf.shape[2]
    return k_buf.dtype != torch.bfloat16 or k3_split(b, q.shape[1] // head_dim, s_len)


def decode_body(q: torch.Tensor, k_buf: torch.Tensor, head_dim: int) -> tuple[str, int, int]:
    """The body a CUDA call takes, its cluster size and the shared memory one
    block of it uses: ``"f32"`` with an fp32 model (over an fp32 or int8
    cache: 8 values a lane, one online-softmax pass, :func:`f32_staged`), ``"split"``
    for a bf16 model over an int8 cache or where :func:`k3_split` says so,
    ``"one_block"`` otherwise. Reads dtypes and shapes only."""
    b, nh, s_len = q.shape[0], q.shape[1] // head_dim, k_buf.shape[2]
    if q.dtype == torch.float32:
        int8 = k_buf.dtype == torch.int8
        cluster = f32_cluster_size(b, nh, s_len)
        staged = f32_staged(b, nh, s_len, head_dim, int8)
        return "f32", cluster, f32_smem_bytes(s_len, head_dim, cluster, int8, staged)
    if uses_split(q, k_buf, head_dim):
        cluster = cluster_size(b, nh, s_len)
        return "split", cluster, split_smem_bytes(s_len, head_dim, cluster)
    return "one_block", 1, smem_bytes(s_len, head_dim)


def _check_cuda(q, k_buf, v_buf, mask, k_scale, v_scale, head_dim, s_len) -> None:
    """Raise on anything the CUDA kernel does not take."""
    is_int8 = k_buf.dtype == torch.int8
    if q.dtype not in (torch.bfloat16, torch.float32) or not (is_int8 or k_buf.dtype == q.dtype):
        raise TypeError(
            f"the CUDA kernel takes a bf16 or fp32 query over a cache of the same dtype "
            f"or int8, got {q.dtype} and {k_buf.dtype}"
        )
    tensors = [q, k_buf, v_buf, mask] + ([k_scale, v_scale] if is_int8 else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, the cache, its scales and the mask must be on one device")
    if is_int8 and (k_scale.dtype != torch.bfloat16 or v_scale.dtype != torch.bfloat16):
        raise TypeError("the int8 cache's scales must be bf16")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    step = 16 if is_int8 else 8  # elements in one 16-byte load (fp32: in two)
    if head_dim % step or head_dim > 128:
        raise ValueError(
            f"the CUDA kernel takes head_dim % {step} == 0 and <= 128 for a "
            f"{k_buf.dtype} cache, got {head_dim}"
        )
    if any(t.data_ptr() % 16 for t in (q, k_buf, v_buf)):
        raise ValueError("the CUDA kernel takes 16-byte aligned q and cache")
    body, cluster, need = decode_body(q, k_buf, head_dim)
    per = f" (a cluster of {cluster})" if body != "one_block" else ""
    if need > SMEM_LIMIT:
        raise ValueError(
            f"S={s_len} needs {need} bytes of shared memory per block{per}, above the "
            f"{SMEM_LIMIT} an H100 block can use"
        )


def decode_attention_stacked(
    q: torch.Tensor,
    k_buf: torch.Tensor,
    v_buf: torch.Tensor,
    mask: torch.Tensor,
    layer: int,
    *,
    num_heads: int,
    head_dim: int,
    kv_heads: Optional[int] = None,
    scale: Optional[float] = None,
    scale_query: bool = True,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K3 (model-dtype cache) / K4 (int8 cache): one-token attention against
    layer ``layer`` of the stacked cache. Arguments as for the twin.

    ``layer`` is a run-time int: on the card it is a pointer offset into the
    stacked buffers, so no per-layer slice is materialized.
    """
    refuse_grad("decode_attention_stacked", "decode_attention_stacked_reference",
                q, k_buf, v_buf, k_scale, v_scale)
    kv_heads = kv_heads or num_heads
    if scale is None:
        scale = head_dim**-0.5
    if _device_kind(q) == "cpu":
        return decode_attention_stacked_reference(
            q, k_buf, v_buf, mask, layer, num_heads=num_heads, head_dim=head_dim,
            kv_heads=kv_heads, scale=scale, scale_query=scale_query,
            k_scale=k_scale, v_scale=v_scale,
        )
    from ._build import decode_attention_lib

    b, s_len = _shapes(q, k_buf, v_buf, mask, layer, num_heads, head_dim, kv_heads, k_scale, v_scale)
    mask = mask.to(torch.int32).contiguous()
    _check_cuda(q, k_buf, v_buf, mask, k_scale, v_scale, head_dim, s_len)
    is_int8 = k_buf.dtype == torch.int8
    f32 = q.dtype == torch.float32
    out = torch.empty_like(q)
    rc = decode_attention_lib().eilev_decode_attention(
        q.data_ptr(), k_buf.data_ptr(), v_buf.data_ptr(),
        k_scale.data_ptr() if is_int8 else None,
        v_scale.data_ptr() if is_int8 else None,
        mask.data_ptr(), out.data_ptr(),
        b, s_len, num_heads, kv_heads, head_dim, layer,
        _model_scale(scale, q.dtype), int(scale_query), int(is_int8), int(f32),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"decode attention kernel launch failed: cudaError_t {rc}")
    if is_int8:
        decode_attention_stacked.launches_int8 += 1
        decode_attention_stacked.launches_int8_f32 += f32
    elif f32:
        decode_attention_stacked.launches_f32 += 1
    else:
        decode_attention_stacked.launches_bf16 += 1
    return out


decode_attention_stacked.launches_bf16 = 0
decode_attention_stacked.launches_f32 = 0
decode_attention_stacked.launches_int8 = 0
decode_attention_stacked.launches_int8_f32 = 0
