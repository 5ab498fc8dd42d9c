"""LLaMA-family decoder-only LM with the stacked KV cache (counterpart of
``eilev_tpu/models/llama.py``).

Parity target: ``transformers.LlamaForCausalLM``, the model of the
reference's Llama-2-chat sentence-ification utilities. HF numerics kept as in
the JAX module: RMSNorm statistics in fp32 with the weight applied after the
cast back; rotary tables in fp32, cast to the activation dtype before the
rotate; scores scaled by head_dim**-0.5 AFTER the QK matmul, fp32 softmax;
SwiGLU MLP ``down(silu(gate(x)) * up(x))``; no biases.

The cache is the shared stacked layout of ``models/opt.py:init_cache``: k/v
(num_layers, B, max_len, kv_heads, hd), keys stored post-RoPE. As in the
port's OPT, the cache is UPDATED IN PLACE and the same dict is returned.

- A multi-token forward into a fresh cache (the prefill) writes its rows, then
  attends over the whole layer slice ``k_buf[li]`` (a view, no copy) under
  the cache mask through ``ops/attention.dot_product_attention``: the JAX
  dispatch and kv length, so ``auto`` takes kernel K5 for a prompt of >= 1024
  tokens into a cache of >= 2048 slots. An int8 cache is dequantized first,
  as in JAX.
- A one-token decode step runs ``ops/decode_attention.decode_attention_stacked``
  with score-side scale and ``kv_heads``: K3 for a model-dtype cache, K4 for
  an int8 one (on the CPU its plain twin, the same numbers as the JAX plain
  path). The JAX module gates its decode kernel behind ``EILEV_DECODE_KERNEL``,
  a TPU v5e measurement; the port runs the kernel on the card with no switch.

- A multi-token append into a partly filled cache (``cache_append=True``,
  the speculative verify pass) attends the whole layer slice through the
  additive (B, 1, S, L) bias of ``models/opt.append_bias``, by plain
  attention, as in JAX.

Grouped-query attention stores only the kv heads; the attention functions
read kv head h // (heads // kv_heads), which equals the JAX ``jnp.repeat``.
A multi-token write into a filled cache without ``cache_append`` raises
``NotImplementedError``.

Tensor parallelism (``tp``, ``parallel/tensor.py``; inference): rank r holds q
heads ``[r H/tp, (r+1) H/tp)`` and kv heads ``[r KVH/tp, ...)`` of the packed
``qkv_proj`` (tp must divide KVH), so K5 and K3/K4 run on the local heads and
the cache holds the local kv heads; ``gate_proj``/``up_proj`` are
column-parallel, ``o_proj``/``down_proj`` row-parallel; ``embed_tokens`` and
``lm_head`` are vocab-parallel, the logits gathered on every rank.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import LlamaConfig
from ..ops.attention import dot_product_attention
from ..ops.decode_attention import decode_attention_stacked, dequantize_kv, quantize_kv
from ..ops.quantization import dense_cls
from ..parallel.tensor import gather_vocab, row_parallel, tower_tp, vocab_block, vocab_embedding
from .opt import append_bias

Cache = dict[str, Any]


def llama_position_ids(attention_mask: torch.Tensor) -> torch.Tensor:
    """Mask-derived positions for left-padded batches: real tokens count from 0;
    padding slots get position 1, as HF ``prepare_inputs_for_generation``."""
    mask = attention_mask.to(torch.int32)
    pos = torch.cumsum(mask, dim=1, dtype=torch.int32) - 1
    return torch.where(mask == 0, 1, pos)


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for the given positions, float32, shape (..., head_dim)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (theta**exponents)
    freqs = positions.float()[..., None] * inv_freq  # (..., hd/2)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, hd). HF rotate_half convention."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return x * c + rotated * s


class LlamaRMSNorm(nn.Module):
    def __init__(self, hidden_size: int, eps: float = 1e-5, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        xf = xf * torch.rsqrt(var + self.eps)
        # the weight multiplies the normalised rows in the activation dtype;
        # an fp32 weight promotes, and the result is cast back, as in JAX
        return (self.weight * xf.to(x.dtype)).to(x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, *, tp=None, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = {"device": device, "dtype": dtype}
        hd = config.head_dim
        dense = dense_cls(config)  # nn.Linear, or Int8Dense when opted in
        size = tp.size if tp else 1
        self.num_heads, self.kv_heads = config.num_attention_heads // size, config.num_key_value_heads // size
        # packed [q (nh*hd) | k (nkv*hd) | v (nkv*hd)] projection
        packed = (self.num_heads + 2 * self.kv_heads) * hd
        self.qkv_proj = dense(config.hidden_size, packed, bias=False, **kw)
        self.o_proj = row_parallel(dense, tp)(self.num_heads * hd, config.hidden_size, bias=False, **kw)

    def forward(
        self,
        hidden_states: torch.Tensor,
        cos: torch.Tensor,
        sin: torch.Tensor,
        attn: dict,
        cache_kv: Optional[tuple] = None,
        cache_index: Optional[int] = None,
    ) -> torch.Tensor:
        """``cache_kv`` is (k_buf, v_buf, k_scale, v_scale, layer_idx) of the
        stacked cache (the scales are None for a model-dtype cache); the fresh
        rows are written into it in place at ``cache_index``."""
        b, s, _ = hidden_states.shape
        nh, nkv, hd = self.num_heads, self.kv_heads, self.config.head_dim
        qkv = self.qkv_proj(hidden_states)
        dq, dkv = nh * hd, nkv * hd
        q = apply_rope(qkv[..., :dq].reshape(b, s, nh, hd), cos, sin)
        k = apply_rope(qkv[..., dq : dq + dkv].reshape(b, s, nkv, hd), cos, sin)
        v = qkv[..., dq + dkv :].reshape(b, s, nkv, hd)

        if cache_kv is not None:
            k_buf, v_buf, ks_buf, vs_buf, li = cache_kv
            rows = slice(cache_index, cache_index + s)
            if ks_buf is not None:
                k_buf[li, :, rows], ks_buf[li, :, rows] = quantize_kv(k)
                v_buf[li, :, rows], vs_buf[li, :, rows] = quantize_kv(v)
            else:
                k_buf[li, :, rows] = k
                v_buf[li, :, rows] = v
            if s == 1:
                n_layers, _, s_len = k_buf.shape[:3]
                out = decode_attention_stacked(
                    q.reshape(b, dq),
                    k_buf.view(n_layers, b, s_len, dkv),
                    v_buf.view(n_layers, b, s_len, dkv),
                    attn["padding_mask"],
                    li,
                    num_heads=nh,
                    head_dim=hd,
                    kv_heads=nkv,
                    scale=hd**-0.5,
                    scale_query=False,  # HF LLaMA scales the scores
                    k_scale=ks_buf,
                    v_scale=vs_buf,
                )
                return self.o_proj(out[:, None, :])
            if ks_buf is not None:
                k = dequantize_kv(k_buf[li], ks_buf[li], dtype=hidden_states.dtype)
                v = dequantize_kv(v_buf[li], vs_buf[li], dtype=hidden_states.dtype)
            else:
                k, v = k_buf[li], v_buf[li]

        out = dot_product_attention(
            q,
            k,
            v,
            scale=hd**-0.5,
            scale_query_first=False,  # HF LLaMA scales the scores
            softmax_in_fp32=True,
            **attn,
        )
        return self.o_proj(out.reshape(b, s, dq))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, *, tp=None, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        dense = dense_cls(config)
        d, ffn = config.hidden_size, config.intermediate_size // (tp.size if tp else 1)
        self.gate_proj = dense(d, ffn, bias=False, **kw)
        self.up_proj = dense(d, ffn, bias=False, **kw)
        self.down_proj = row_parallel(dense, tp)(ffn, d, bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, *, tp=None, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.self_attn = LlamaAttention(config, tp=tp, **kw)
        self.mlp = LlamaMLP(config, tp=tp, **kw)
        self.input_layernorm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        self.post_attention_layernorm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps, **kw)

    def forward(
        self,
        hidden_states: torch.Tensor,
        cos: torch.Tensor,
        sin: torch.Tensor,
        attn: dict,
        cache_kv: Optional[tuple] = None,
        cache_index: Optional[int] = None,
    ) -> torch.Tensor:
        x = self.input_layernorm(hidden_states)
        x = hidden_states + self.self_attn(x, cos, sin, attn, cache_kv=cache_kv, cache_index=cache_index)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaForCausalLM(nn.Module):
    """LLaMA with an explicit cache argument: the method surface of
    :class:`models.opt.OPTForCausalLM`, so the decoding loops drive both.
    ``tp`` (a ``parallel.tensor.TensorParallel``) shards it."""

    def __init__(self, config: LlamaConfig, *, tp=None, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.tp = tp = tower_tp(tp, config)
        kw = {"device": device, "dtype": dtype}
        self.embed_tokens = vocab_embedding(config.vocab_size, config.hidden_size, tp, **kw)
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(config, tp=tp, **kw) for _ in range(config.num_hidden_layers)
        )
        self.norm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        rows = config.vocab_size if tp is None else vocab_block(config.vocab_size, tp)
        self.lm_head = (
            None if config.tie_word_embeddings
            else nn.Linear(config.hidden_size, rows, bias=False, **kw)
        )

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(x)
        if self.lm_head is not None:
            logits = self.lm_head(x)
        else:
            logits = F.linear(x, self.embed_tokens.weight)  # tied, as flax Embed.attend
        return logits if self.tp is None else gather_vocab(logits, self.tp, self.config.vocab_size)

    def forward(
        self,
        inputs_embeds: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        cache: Optional[Cache] = None,
        cache_append: bool = False,
    ) -> tuple[torch.Tensor, Optional[Cache]]:
        """inputs_embeds: (B, S, hidden). Returns (logits, cache).

        Without cache: ``attention_mask`` is the (B, S) padding mask. With
        cache: the S tokens are written at ``cache['index']`` and the cache is
        updated in place. S > 1 goes into a fresh cache (the prefill) or, with
        ``cache_append``, into a partly filled one (query j attends the
        filled slots up to ``index + j``); S == 1 is a decode step over
        everything filled so far.
        """
        cfg = self.config
        b, s, _ = inputs_embeds.shape
        if attention_mask is None:
            attention_mask = torch.ones(b, s, dtype=torch.int32, device=inputs_embeds.device)
        attention_mask = attention_mask.to(torch.int32)

        if cache is None:
            position_ids = llama_position_ids(attention_mask)
            attn = {"causal": True, "padding_mask": attention_mask}
            cache_index = None
        else:
            index = cache["index"]
            if s > 1 and index != 0 and not cache_append:
                raise NotImplementedError(
                    "a multi-token write into a filled cache needs cache_append=True"
                )
            cache["mask"][:, index : index + s] = attention_mask
            new_counts = torch.cumsum(attention_mask, dim=1, dtype=torch.int32)
            pos = cache["pos"][:, None] + new_counts - 1
            position_ids = torch.where(attention_mask == 0, 1, pos)
            if s > 1 and cache_append:
                attn = {"bias": append_bias(cache["mask"], index, s), "causal": False}
            else:
                attn = {"causal": s > 1, "padding_mask": cache["mask"]}
            cache_index = index

        cos, sin = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta)
        x = inputs_embeds
        for i, layer in enumerate(self.layers):
            ckv = None
            if cache is not None:
                ckv = (cache["k"], cache["v"], cache.get("k_scale"), cache.get("v_scale"), i)
            x = layer(x, cos, sin, attn, cache_kv=ckv, cache_index=cache_index)

        logits = self._head(x)
        if cache is not None:
            cache["pos"] += new_counts[:, -1]
            cache["index"] = cache_index + s
        return logits, cache
