"""OPT decoder-only LM with a stacked KV cache (counterpart of ``eilev_tpu/models/opt.py``).

Parity target: ``transformers.OPTForCausalLM``. HF numerics kept as in the JAX
module: learned positions offset by 2 and derived from the mask cumsum; q
scaled by head_dim**-0.5 before QK^T; fp32 softmax; masking with
``finfo(float32).min`` in the model dtype.

The cache is the JAX layout: ``k``/``v`` (num_layers, B, max_len, H, hd),
``index`` (filled positions), ``mask`` (B, max_len) and ``pos`` (B,). Unlike
the JAX module, which returns new arrays, the port UPDATES THE CACHE IN PLACE
and returns the same dict: each layer writes its rows of the stacked buffers,
and ``index``/``mask``/``pos`` are advanced by the forward.

A multi-token forward into a fresh cache (the generation prefill) runs the
packed causal kernel K2 (``ops/fused_attention.py``) on the unquantized k/v;
the one-token decode step attends over the cache through
``ops/decode_attention.decode_attention_stacked``, K3 for a model-dtype cache
and K4 for an int8 one (on the CPU its plain twin, the same math as the JAX
dequant + plain-attention path).

Serving modes, as in the JAX module: ``quantize_matmuls`` (+ ``w8a8_prefill``)
makes the projection and FFN matmuls int8 layers (``ops/quantization.py``);
``int8_kv_cache`` stores k/v as int8 with bf16 per-(position, head) scales
(``k_scale``/``v_scale``, (num_layers, B, max_len, H)), quantized as they are
written.

A multi-token append into a partly filled cache (``cache_append=True``, the
verify pass of speculative decoding) attends the whole cache through one
additive (B, 1, S, L) bias, ``slots <= index + j`` for query j and the
cache mask, by plain attention, as the JAX module does in XLA (no Pallas
kernel there, so none here); an int8 cache is dequantized layer by layer
for it. ``with_hidden=True`` also returns the final hidden states (HF
``hidden_states[-1]``), contrastive search's context vectors.

Training (the no-cache forward): dropout at the JAX module's three sites
(after the position embeddings, after attention, after fc2), active in
training mode when the forward is given a mask source ``rng``
(``ops/dropout.py``). With ``config.remat`` each layer runs under
``torch.utils.checkpoint``: only the layer boundaries are saved for
backward and the layer is recomputed there, drawing the same dropout masks
(the mask source is rewound to the layer's entry), so the step is the one
without remat, bit for bit.

Class scoring (``score_with_prefix``, the ICL classify path) attends (B, C,
L) class continuations to the shared (B, P) prompt cache with a class axis,
as the JAX module does: the prompt cache is read, never written or
duplicated per class. Its attention is plain einsums with additive biases,
as in JAX (no Pallas kernel there, so none here).

Tensor parallelism (``tp``, ``parallel/tensor.py``; inference): each rank
holds its heads of the packed ``qkv_proj`` and its block of ``fc1``, so K2,
K3 and K4 run with ``num_heads = H / tp`` and the cache (:func:`init_cache`
with ``tp``) holds the local heads; ``out_proj`` and ``fc2`` are
row-parallel; ``embed_tokens`` is vocab-parallel and the tied head's logits
are gathered (:func:`parallel.tensor.gather_vocab`), so every rank returns
the same full-vocab logits. ``score_with_prefix`` runs on the local heads
too, and returns the rank's vocab block with ``local_logits``. In training
(the frozen LM under a graph, the gradient flowing to the video features)
the inputs of ``qkv_proj``, ``fc1`` and the tied head go through
``parallel.tensor.copy_to_model``, and ``forward(local_logits=True)`` gives
the rank's vocab block to the vocab-parallel loss, with no full-vocab
gather. Every dropout site is after a row-parallel sum, replicated.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs import OPTConfig
from ..ops.attention import _scalar, dot_product_attention, make_causal_bias, mask_to_bias
from ..ops.decode_attention import decode_attention_stacked, dequantize_kv, quantize_kv
from ..ops.dropout import Dropout, MaskSource
from ..ops.fused_attention import packed_qkv_causal_attention
from ..ops.quantization import dense_cls
from ..parallel.tensor import copy_to_model, gather_vocab, row_parallel, tower_tp, vocab_embedding
from .mixed_precision import MixedLayerNorm, MixedLinear, mixed_dense_cls

Cache = dict[str, Any]


def opt_position_ids(attention_mask: torch.Tensor) -> torch.Tensor:
    """HF OPT position ids: cumsum(mask) * mask - 1 (padding gets -1, which maps
    to embedding row 1 after the +2 offset)."""
    mask = attention_mask.to(torch.int32)
    return torch.cumsum(mask, dim=1, dtype=torch.int32) * mask - 1


def init_cache(
    config: OPTConfig,
    batch: int,
    max_len: int,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
    tp=None,
) -> Cache:
    """Preallocate the stacked KV cache. ``index`` is a Python int.

    With ``config.int8_kv_cache`` k/v are int8 and ``k_scale``/``v_scale``
    hold their bf16 per-(position, head) scales; ``dtype`` is then unused.
    Under ``tp`` (the model's ``tp``) it holds the rank's kv heads.
    """
    kv_heads = getattr(config, "num_key_value_heads", config.num_attention_heads)
    tp = tower_tp(tp, config)
    kv_heads //= tp.size if tp else 1
    shape = (config.num_hidden_layers, batch, max_len, kv_heads, config.head_dim)
    cache: Cache = {
        "index": 0,
        "mask": torch.zeros(batch, max_len, dtype=torch.int32, device=device),
        "pos": torch.zeros(batch, dtype=torch.int32, device=device),
    }
    if getattr(config, "int8_kv_cache", False):
        for key in ("k", "v"):
            cache[key] = torch.zeros(shape, dtype=torch.int8, device=device)
            cache[f"{key}_scale"] = torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device)
        return cache
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"the KV cache takes float32 or bfloat16, got {dtype}")
    cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def append_bias(cache_mask: torch.Tensor, index: int, s: int) -> torch.Tensor:
    """The (B, 1, S, L) additive bias of an S-token append at slot ``index``:
    query j may attend slot t iff ``t <= index + j`` and the (already
    updated) cache mask keeps t; ``finfo(float32).min`` elsewhere, in fp32."""
    slots = torch.arange(cache_mask.shape[1], device=cache_mask.device)[None, None, None, :]
    qpos = torch.arange(s, device=cache_mask.device)[None, None, :, None]
    keep = (slots <= index + qpos) & cache_mask.bool()[:, None, None, :]
    return mask_to_bias(keep)


class OPTAttention(nn.Module):
    def __init__(self, config: OPTConfig, *, tp=None, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.tp = tp
        d = config.hidden_size
        kw = {"device": device, "dtype": dtype}
        dense = mixed_dense_cls(dense_cls(config))  # or Int8Dense when opted in
        self.num_heads = config.num_attention_heads // (tp.size if tp else 1)
        inner = self.num_heads * config.head_dim
        # packed [q | k | v] projection: one GEMM instead of three
        self.qkv_proj = dense(d, 3 * inner, **kw)
        self.out_proj = row_parallel(dense, tp)(inner, d, **kw)

    def forward(
        self,
        hidden_states: torch.Tensor,
        attn: dict,
        cache_kv: Optional[tuple] = None,
        cache_index: Optional[int] = None,
    ) -> torch.Tensor:
        """``cache_kv`` is (k_buf, v_buf, k_scale, v_scale, layer_idx) of the
        stacked cache (the scales are None for a model-dtype cache); the fresh
        k/v rows are written into it in place at ``cache_index``, quantized
        first for an int8 cache. With a cache, S is the whole prompt into a
        fresh cache (``attn['prefill_fresh']``), one decode token, or an
        append (``attn['bias']``) that attends the whole cache under the
        bias, dequantized first for an int8 cache."""
        b, s, _ = hidden_states.shape
        nh, hd = self.num_heads, self.config.head_dim
        d = nh * hd  # the local heads' width
        qkv = self.qkv_proj(copy_to_model(hidden_states, self.tp))
        q = qkv[..., :d].reshape(b, s, nh, hd)
        k = qkv[..., d : 2 * d].reshape(b, s, nh, hd)
        v = qkv[..., 2 * d :].reshape(b, s, nh, hd)
        prefill_fresh = attn.get("prefill_fresh", False)

        if cache_kv is not None:
            k_buf, v_buf, ks_buf, vs_buf, li = cache_kv
            rows = slice(cache_index, cache_index + s)
            if ks_buf is not None:
                k_buf[li, :, rows], ks_buf[li, :, rows] = quantize_kv(k)
                v_buf[li, :, rows], vs_buf[li, :, rows] = quantize_kv(v)
            else:
                k_buf[li, :, rows] = k
                v_buf[li, :, rows] = v
            if "bias" in attn:
                if ks_buf is not None:
                    k = dequantize_kv(k_buf[li], ks_buf[li], dtype=hidden_states.dtype)
                    v = dequantize_kv(v_buf[li], vs_buf[li], dtype=hidden_states.dtype)
                else:
                    k, v = k_buf[li], v_buf[li]
            elif not prefill_fresh:
                n_layers, _, s_len = k_buf.shape[:3]
                out = decode_attention_stacked(
                    qkv[:, 0, :d].contiguous(),
                    k_buf.view(n_layers, b, s_len, d),
                    v_buf.view(n_layers, b, s_len, d),
                    attn["padding_mask"],
                    li,
                    num_heads=nh,
                    head_dim=hd,
                    scale=hd**-0.5,
                    scale_query=True,  # HF OPT scales q before the matmul
                    k_scale=ks_buf,
                    v_scale=vs_buf,
                )
                return self.out_proj(out[:, None, :])

        if prefill_fresh:
            out = packed_qkv_causal_attention(
                qkv, nh, hd, attn["padding_mask"], scale=hd**-0.5
            )
            return self.out_proj(out)

        out = dot_product_attention(
            q,
            k,
            v,
            bias=attn.get("bias"),
            padding_mask=attn.get("padding_mask"),
            causal=attn["causal"],
            scale=hd**-0.5,
            scale_query_first=True,  # HF OPT scales q before the matmul
            softmax_in_fp32=True,
        )
        return self.out_proj(out.reshape(b, s, d))

    def shared_prefix(
        self,
        hidden_states: torch.Tensor,
        prefix_k: torch.Tensor,
        prefix_v: torch.Tensor,
        prefix_bias: torch.Tensor,
        self_bias: torch.Tensor,
    ) -> torch.Tensor:
        """Attention for (B, C, L, D) class tokens over a shared (B, P) prompt
        cache (``prefix_k``/``prefix_v``: (B, P, H, hd)) and, causally, their
        own continuation. ``prefix_bias`` broadcasts to (B, C, H, L, P),
        ``self_bias`` to (B, C, H, L, L); both are fp32 and ADDED to the
        model-dtype scores, as in JAX (so the scores are fp32 from there on,
        and a NaN k/v row of the prompt cache reaches every class score)."""
        b, c, l, _ = hidden_states.shape
        nh, hd = self.num_heads, self.config.head_dim
        d = nh * hd  # the local heads' width
        qkv = self.qkv_proj(hidden_states)
        # the scale rounded to the model dtype first, as JAX's weak-typed product does
        q = (qkv[..., :d] * _scalar(hd**-0.5, qkv)).reshape(b, c, l, nh, hd)
        k = qkv[..., d : 2 * d].reshape(b, c, l, nh, hd)
        v = qkv[..., 2 * d :].reshape(b, c, l, nh, hd)
        scores_p = torch.einsum("bclhd,bphd->bchlp", q, prefix_k) + prefix_bias
        scores_s = torch.einsum("bclhd,bcmhd->bchlm", q, k) + self_bias
        scores = torch.cat([scores_p, scores_s], dim=-1).float()
        probs = torch.softmax(scores, dim=-1).to(hidden_states.dtype)
        p_len = prefix_k.shape[1]
        ctx = torch.einsum("bchlp,bphd->bclhd", probs[..., :p_len], prefix_v) + torch.einsum(
            "bchlm,bcmhd->bclhd", probs[..., p_len:], v
        )
        return self.out_proj(ctx.reshape(b, c, l, d))


class OPTDecoderLayer(nn.Module):
    def __init__(self, config: OPTConfig, *, tp=None, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.tp = tp
        kw = {"device": device, "dtype": dtype}
        d, eps = config.hidden_size, config.layer_norm_eps
        self.self_attn = OPTAttention(config, tp=tp, **kw)
        self.self_attn_layer_norm = MixedLayerNorm(d, eps=eps, **kw)
        self.final_layer_norm = MixedLayerNorm(d, eps=eps, **kw)
        dense = mixed_dense_cls(dense_cls(config))
        ffn = config.ffn_dim // (tp.size if tp else 1)
        self.fc1 = dense(d, ffn, **kw)
        self.fc2 = row_parallel(dense, tp)(ffn, d, **kw)
        self.dropout_layer = Dropout(config.dropout)

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        if self.config.activation_function == "relu":
            return F.relu(x)
        return F.gelu(x, approximate="none")

    def _mlp(self, x: torch.Tensor, rng: Optional[MaskSource] = None) -> torch.Tensor:
        pre_ln = self.config.do_layer_norm_before
        residual = x
        if pre_ln:
            x = self.final_layer_norm(x)
        x = residual + self.dropout_layer(self.fc2(self._act(self.fc1(copy_to_model(x, self.tp)))), rng)
        if not pre_ln:
            x = self.final_layer_norm(x)
        return x

    def forward(
        self,
        hidden_states: torch.Tensor,
        attn: dict,
        cache_kv: Optional[tuple] = None,
        cache_index: Optional[int] = None,
        rng: Optional[MaskSource] = None,
    ) -> torch.Tensor:
        pre_ln = self.config.do_layer_norm_before
        x = self.self_attn_layer_norm(hidden_states) if pre_ln else hidden_states
        x = self.self_attn(x, attn, cache_kv=cache_kv, cache_index=cache_index)
        x = hidden_states + self.dropout_layer(x, rng)
        if not pre_ln:
            x = self.self_attn_layer_norm(x)
        return self._mlp(x, rng)

    def shared_prefix(
        self,
        hidden_states: torch.Tensor,
        prefix_k: torch.Tensor,
        prefix_v: torch.Tensor,
        prefix_bias: torch.Tensor,
        self_bias: torch.Tensor,
    ) -> torch.Tensor:
        pre_ln = self.config.do_layer_norm_before
        x = self.self_attn_layer_norm(hidden_states) if pre_ln else hidden_states
        x = hidden_states + self.self_attn.shared_prefix(x, prefix_k, prefix_v, prefix_bias, self_bias)
        if not pre_ln:
            x = self.self_attn_layer_norm(x)
        return self._mlp(x)


def _remat_layer(layer: OPTDecoderLayer, x: torch.Tensor, attn: dict,
                 rng: Optional[MaskSource]) -> torch.Tensor:
    """One layer under ``torch.utils.checkpoint``: its input is saved, its
    insides are recomputed in backward. ``checkpoint`` restores only the
    global generators' states, so the mask source is rewound here: each run
    of the layer (the forward and the recompute) starts from the source's
    state at the layer's entry, and a recompute leaves the source where it
    found it, even one that ``checkpoint`` stops early. After the forward the
    source stands where the layer left it, as without remat."""
    if rng is None:
        return checkpoint(layer, x, attn, use_reentrant=False, preserve_rng_state=False)
    entry = rng.get_state()
    exit_state = []

    def run(h: torch.Tensor) -> torch.Tensor:
        before = rng.get_state()
        rng.set_state(entry)
        try:
            out = layer(h, attn, rng=rng)
            exit_state.append(rng.get_state())
            return out
        finally:  # also when checkpoint stops a recompute early, by raising
            rng.set_state(before)

    out = checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
    rng.set_state(exit_state[0])
    return out


class OPTForCausalLM(nn.Module):
    """OPT with an explicit cache argument and the tied ``lm_head``. It
    computes in ``compute_dtype``: the embeddings are cast to it and every
    layer casts its parameters at use. ``None`` (the default) follows the
    parameters' dtype, also after a ``.to(dtype)`` of the module. ``tp`` (a
    ``parallel.tensor.TensorParallel``) shards it where the model axis
    divides its heads and FFN width."""

    def __init__(self, config: OPTConfig, *, tp=None, device=None, dtype=None, compute_dtype=None):
        super().__init__()
        self.config = config
        self.compute_dtype = compute_dtype
        self.tp = tp = tower_tp(tp, config)
        kw = {"device": device, "dtype": dtype}
        self.embed_tokens = vocab_embedding(config.vocab_size, config.word_embed_proj_dim, tp, **kw)
        # +2 offset slots, like torch's OPTLearnedPositionalEmbedding
        self.embed_positions = nn.Embedding(
            config.max_position_embeddings + 2, config.hidden_size, **kw
        )
        if config.word_embed_proj_dim != config.hidden_size:
            self.project_in = MixedLinear(
                config.word_embed_proj_dim, config.hidden_size, bias=False, **kw
            )
            self.project_out = MixedLinear(
                config.hidden_size, config.word_embed_proj_dim, bias=False, **kw
            )
        else:
            self.project_in = None
            self.project_out = None
        self.layers = nn.ModuleList(
            OPTDecoderLayer(config, tp=tp, **kw) for _ in range(config.num_hidden_layers)
        )
        self.embed_dropout = Dropout(config.dropout)
        self.final_norm = (
            MixedLayerNorm(config.hidden_size, eps=config.layer_norm_eps, **kw)
            if config.do_layer_norm_before
            else None
        )

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        embeds = self.embed_tokens(input_ids)
        return embeds if self.compute_dtype is None else embeds.to(self.compute_dtype)

    # ---- pipeline-parallel plumbing (parallel/pipeline.py): the layer
    # trunk runs as a GPipe schedule over the layer modules; these two
    # methods are everything around it

    def pre_layers(self, inputs_embeds: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Everything ``forward`` does before the layer stack, with no cache
        and no dropout (the pipeline trunk runs the frozen LM without it)."""
        position_ids = opt_position_ids(attention_mask)
        x = inputs_embeds
        if self.project_in is not None:
            x = self.project_in(x)
        return x + self.embed_positions(position_ids.long() + 2).to(x.dtype)

    def post_layers(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm, out-projection and tied lm head after the layer stack."""
        return self.lm_head(self._pre_head(x))

    def lm_head(self, hidden: torch.Tensor, local: bool = False) -> torch.Tensor:
        """The tied head's logits: the full vocabulary on every rank, or with
        ``local`` (under ``tp``) this rank's block of it."""
        # tied to embed_tokens, like OPTForCausalLM
        hidden = copy_to_model(hidden, self.tp)
        logits = F.linear(hidden, self.embed_tokens.weight.to(hidden.dtype))
        if self.tp is None or local:
            return logits
        return gather_vocab(logits, self.tp, self.config.vocab_size)

    def _pre_head(self, x: torch.Tensor) -> torch.Tensor:
        if self.final_norm is not None:
            x = self.final_norm(x)
        if self.project_out is not None:
            x = self.project_out(x)
        return x

    def forward(
        self,
        inputs_embeds: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        cache: Optional[Cache] = None,
        cache_append: bool = False,
        rng: Optional[MaskSource] = None,
        with_hidden: bool = False,
        local_logits: bool = False,
    ) -> tuple:
        """inputs_embeds: (B, S, word_embed_proj_dim). Returns (logits, cache),
        or (logits, hidden, cache) with ``with_hidden`` (hidden: the final
        norm and out-projection's output, HF ``hidden_states[-1]``); with
        ``local_logits`` under ``tp`` the logits are this rank's vocab block.

        Without cache: ``attention_mask`` is the (B, S) padding mask. With
        cache: the S tokens are written at ``cache['index']`` and the cache is
        updated in place, ``mask``, ``pos`` and ``index`` as the JAX module's
        functional update gives them. S > 1 goes into a fresh cache (the
        prefill) or, with ``cache_append``, into a partly filled one, query j
        attending the filled slots up to ``index + j``; S == 1 is a decode
        step over everything filled so far. ``rng`` is the dropout mask
        source (training mode only).
        """
        b, s, _ = inputs_embeds.shape
        device = inputs_embeds.device
        if attention_mask is None:
            attention_mask = torch.ones(b, s, dtype=torch.int32, device=device)
        attention_mask = attention_mask.to(torch.int32)

        if cache is None:
            position_ids = opt_position_ids(attention_mask)
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
            position_ids = (cache["pos"][:, None] + new_counts) * attention_mask - 1
            if s > 1 and cache_append:
                attn = {"bias": append_bias(cache["mask"], index, s), "causal": False}
            elif s > 1:
                # prefill-at-0: the fresh (B, S) k/v under the short mask is the
                # same math as the padded cache buffers, and runs kernel K2
                attn = {"causal": True, "padding_mask": attention_mask, "prefill_fresh": True}
            else:
                attn = {"causal": False, "padding_mask": cache["mask"]}
            cache_index = index

        x = inputs_embeds
        if self.project_in is not None:
            x = self.project_in(x)
        x = x + self.embed_positions(position_ids.long() + 2).to(x.dtype)
        x = self.embed_dropout(x, rng)

        remat = cache is None and self.config.remat and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:
                x = _remat_layer(layer, x, attn, rng)
                continue
            ckv = None
            if cache is not None:
                ckv = (cache["k"], cache["v"], cache.get("k_scale"), cache.get("v_scale"), i)
            x = layer(x, attn, cache_kv=ckv, cache_index=cache_index, rng=rng)

        hidden = self._pre_head(x)
        logits = self.lm_head(hidden, local=local_logits)
        if cache is not None:
            cache["pos"] += new_counts[:, -1]
            cache["index"] = cache_index + s
        if with_hidden:
            return logits, hidden, cache
        return logits, cache

    def score_with_prefix(
        self,
        class_embeds: torch.Tensor,
        class_attention_mask: torch.Tensor,
        cache: Cache,
        return_hidden: bool = False,
        local_logits: bool = False,
    ):
        """Run (B, C, L) class continuations against the shared prompt cache.

        ``class_embeds``: (B, C, L, word_embed_proj_dim). Returns the (B, C, L,
        vocab) logits, or this rank's vocab block of them with
        ``local_logits`` under ``tp`` (and the (B, C, L, D) final hidden
        states with ``return_hidden``). The cache is read only: positions continue from
        ``cache['pos']``, the prompt's padding and unfilled slots are masked
        by ``cache['mask']``, and an int8 cache is dequantized layer by layer
        (materialized, as in JAX)."""
        b, c, l, _ = class_embeds.shape
        device = class_embeds.device
        cls_mask = class_attention_mask.to(torch.int32)  # (B, C, L)
        position_ids = (
            cache["pos"][:, None, None] + torch.cumsum(cls_mask, dim=-1, dtype=torch.int32)
        ) * cls_mask - 1
        x = class_embeds
        if self.project_in is not None:
            x = self.project_in(x)
        x = x + self.embed_positions(position_ids.long() + 2).to(x.dtype)

        # (B, 1, 1, 1, P) prompt padding / unfilled-slot bias
        prefix_bias = mask_to_bias(cache["mask"].bool())[:, None, None, None, :]
        # (1, 1, 1, L, L) causal + (B, C, 1, 1, L) class padding, in fp32
        # (two finfo.min terms sum to -inf, as in JAX)
        self_bias = (
            make_causal_bias(l, l, device=device)[None]
            + mask_to_bias(cls_mask.bool())[:, :, None, None, :]
        )
        int8_cache = "k_scale" in cache
        for i, layer in enumerate(self.layers):
            if int8_cache:
                pk = dequantize_kv(cache["k"][i], cache["k_scale"][i], dtype=x.dtype)
                pv = dequantize_kv(cache["v"][i], cache["v_scale"][i], dtype=x.dtype)
            else:
                pk, pv = cache["k"][i], cache["v"][i]
            x = layer.shared_prefix(x, pk, pv, prefix_bias, self_bias)
        hidden = self._pre_head(x)
        logits = self.lm_head(hidden, local=local_logits)
        if return_hidden:
            return logits, hidden
        return logits
