"""T5 encoder-decoder LM, flan-t5 flavour (counterpart of ``eilev_tpu/models/t5.py``).

Parity target: ``transformers.T5ForConditionalGeneration``. The JAX module's
numerics are kept: the RMS norm's variance in fp32, its output rounded to the
model dtype before the scale multiplies it and rounded again after; no
attention scale; one relative-position bias, owned by layer 0 of each stack
and shared down it; the gated-gelu FFN with the tanh gelu ("gelu_new", never
the process-wide switch of ``ops/gelu.py``); an untied LM head for flan
checkpoints (a tied one scales the hidden by d_model**-0.5 first).

Every attention call goes through ``ops/attention.dot_product_attention``
with ``scale=None``, as in JAX: the encoder's self-attention with the (H, S,
S) relative bias and the (B, S) padding mask, the decoder's with the causal
flag (no cache) or with the bias at ``q_offset = index`` and the filled-slot
mask (cached), and the cross-attention with the encoder's padding mask. So
under ``auto`` at the narration's lengths they take the plain path, and
kernel K5 (``ops/flash_attention.py``, its bias form) under
``set_default_attention_impl("flash")`` or where q >= 1024 and kv >= 2048.
The decode step does not use K3/K4, which take no bias, as JAX's does not.
The relative bias is built once a forward (once a step, with a cache) in the
model dtype, in a buffer whose rows of keys are padded to a multiple of 8
(:meth:`T5Attention.compute_bias`), so K5 reads it in place; its values are
those of JAX's ``compute_bias``.

The decode cache is JAX's layout: ``k``/``v`` (num_decoder_layers, B,
max_len, H, hd), ``cross_k``/``cross_v`` (num_decoder_layers, B, P, H, hd),
projected once by :meth:`T5ForConditionalGeneration.init_decode_cache`, and
``index`` (a Python int). Unlike JAX, which returns new arrays, the port
writes each step's k/v rows into the buffers IN PLACE and advances ``index``.
The filled-slot mask, (1, max_len) in JAX, is expanded to (B, max_len), which
K5 requires; the values are the same.

Class scoring (:meth:`T5ForConditionalGeneration.score_classes`, the seq2seq
classify) runs (B, C, L) class continuations over the SHARED (B, S) encoder
states with plain einsums and additive fp32 biases, as in JAX (no Pallas
kernel there, so none here); where two ``finfo.min`` terms meet they sum to
-inf, as in JAX.

Training (the no-cache forward): dropout at the JAX module's sites (the
encoder's and decoder's input and final norm output, each attention output,
the FFN's activation and output), drawn from the mask source ``rng`` in
JAX's call order, active in training mode (``ops/dropout.py``). With
``config.remat`` each encoder and decoder layer runs under
``torch.utils.checkpoint`` (``models/opt.py:_remat_layer``, the mask source
rewound to the layer's entry for the recompute); a decoder layer projects
its cross K/V inside, so only the encoder states are saved.

The serving engine's slot cache (``serving/engine.py``) carries a per-row
attendable ``mask`` (slots, max_len): the cached decoder step then attends
the slots that mask keeps plus the ones it writes, and ``spec_append`` /
``decode_append`` run a multi-token verify block over it with intra-block
causality and a relative bias over ATTENDED-token distances, so that
rejection holes collapse out of the distances (as in JAX).

Contrastive search's helpers, as in JAX: ``decode_step_hidden`` (a decode
step that also returns the final norm's output) and ``candidates`` (C
one-token candidates at the next position over the shared decode cache,
through each layer's ``shared_prefix``: plain einsums, the prefix and self
scores softmaxed together in fp32, the cache read and never written). JAX's
``generate`` refuses T5 contrastive search, and so does the port's; nothing
in either package calls these.

The pipeline plumbing (``encoder_rel_bias`` ... ``decoder_post``) exposes
what runs around the layer trunks under pipeline parallelism
(``training/pipeline_step.py``).

Tensor parallelism (``tp``, ``parallel/tensor.py``; inference): each rank
holds its heads of ``q``/``k``/``v`` and its block of ``wi_0``/``wi_1`` (or
``wi``); ``o`` and ``wo`` are row-parallel; the relative-position bias is read
for the rank's heads only (the table stays whole); the decode and
cross caches hold the local heads; ``shared`` and ``lm_head`` are
vocab-parallel, the logits gathered on every rank (``score_classes`` returns
the rank's block with ``local_logits``). In training the inputs of ``q``,
``k``, ``v`` (self and cross), ``wi_0``/``wi_1`` (``wi``) and the head go
through ``parallel.tensor.copy_to_model``; ``forward(local_logits=True)``
gives the rank's vocab block to the vocab-parallel loss; the FFN's hidden
dropout, on the rank's block of d_ff, draws the unsharded mask
(``ops/dropout.py``). The other dropout sites are replicated.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import T5Config
from ..ops.attention import _scalar, dot_product_attention, make_causal_bias, mask_to_bias
from ..ops.dropout import Dropout, MaskSource
from ..parallel.tensor import (copy_to_model, gather_vocab, row_parallel, tower_tp, vocab_block,
                               vocab_embedding)
from .mixed_precision import MixedLinear
from .opt import _remat_layer

Cache = dict[str, Any]


def distance_buckets(bidirectional: bool, num_buckets: int, max_distance: int) -> torch.Tensor:
    """JAX's formula for a distance n >= 0 (before the sign's half of the
    buckets), at every n in [0, max_distance], on the CPU in fp32: the fp32
    ``log``, the truncating cast and the ``maximum(n, 1)`` clamp. Every n past
    max_distance falls in the last bucket."""
    if bidirectional:
        num_buckets //= 2
    max_exact = num_buckets // 2
    n = torch.arange(max_distance + 1, dtype=torch.int32)
    ratio = torch.clamp(n, min=1).to(torch.float32) / max_exact
    scale = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32))
    large = max_exact + (torch.log(ratio) / scale * (num_buckets - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=num_buckets - 1)
    return torch.where(n < max_exact, n, large)


def _lookup_buckets(relative_position: torch.Tensor, table: torch.Tensor, bidirectional: bool,
                    num_buckets: int, max_distance: int) -> torch.Tensor:
    """Buckets of ``relative_position`` from :func:`distance_buckets`'s
    ``table`` on the positions' device: integer ops only."""
    rp = relative_position.to(torch.int32)
    if bidirectional:
        n = rp.abs()
        sign = (rp > 0).to(torch.int32) * (num_buckets // 2)
    else:
        n = -torch.clamp(rp, max=0)
        sign = 0
    return table[torch.clamp(n, max=max_distance).long()] + sign


def relative_position_bucket(
    relative_position: torch.Tensor, *, bidirectional: bool, num_buckets: int, max_distance: int
) -> torch.Tensor:
    """HF's ``T5Attention._relative_position_bucket`` as the JAX module
    computes it, bit for bit: the distance -> bucket map is evaluated on the
    CPU (:func:`distance_buckets`), so a card gathers from the CPU's fp32
    ``log``, not its own."""
    table = distance_buckets(bidirectional, num_buckets, max_distance).to(relative_position.device)
    return _lookup_buckets(relative_position, table, bidirectional, num_buckets, max_distance)


def relative_positions(q_len: int, k_len: int, q_offset: int = 0, device=None) -> torch.Tensor:
    """memory_position - query_position, (q_len, k_len) int32."""
    ctx = torch.arange(q_len, dtype=torch.int32, device=device)[:, None] + q_offset
    mem = torch.arange(k_len, dtype=torch.int32, device=device)[None, :]
    return mem - ctx


class T5LayerNorm(nn.Module):
    """T5's RMS norm (flax ``scale`` -> ``weight``): the variance in fp32,
    ``y`` rounded to the input's dtype, times the scale in fp32, rounded
    again."""

    def __init__(self, d: int, eps: float, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        y = (xf * torch.rsqrt(var + self.eps)).to(x.dtype)
        # the product in fp32: an fp32 scale promotes, a bf16 one multiplies
        # in fp32 and rounds once, as flax's fp32 scale times y then the cast
        return (self.weight * y).to(x.dtype)


class T5Attention(nn.Module):
    def __init__(self, config: T5Config, has_relative_attention_bias: bool = False,
                 bidirectional: bool = True, *, tp=None, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.bidirectional = bidirectional
        self.tp = tp
        kw = {"device": device, "dtype": dtype}
        # this rank's heads [head_start, head_start + num_heads)
        self.num_heads, self.head_start = tp.block(config.num_heads) if tp else (config.num_heads, 0)
        self.inner = inner = self.num_heads * config.d_kv
        self.q = MixedLinear(config.d_model, inner, bias=False, **kw)
        self.k = MixedLinear(config.d_model, inner, bias=False, **kw)
        self.v = MixedLinear(config.d_model, inner, bias=False, **kw)
        self.o = row_parallel(MixedLinear, tp)(inner, config.d_model, bias=False, **kw)
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Embedding(
                config.relative_attention_num_buckets, config.num_heads, **kw)
            # distance_buckets by device, copied there once: a copy from the
            # host each step would wait for the queued work
            self._bucket_tables: dict = {}

    def compute_bias(self, q_len: int, k_len: int, q_offset: int = 0, *,
                     dtype: torch.dtype, device=None) -> torch.Tensor:
        """(1, heads, q_len, k_len) relative position bias in ``dtype`` (flax
        ``Embed(dtype=...)``: the table cast, then gathered). It is gathered
        once, straight into an (heads, q_len, k_pad) buffer with k_pad the
        multiple of 8 at or above k_len, and returned as its [..., :k_len]
        view: keys contiguous and every row on a 16-byte boundary in bf16,
        the layout K5 reads in place (its Hopper body by TMA, which does not
        take a 1,532-byte row of 766 bf16 keys)."""
        k_pad = -(-k_len // 8) * 8
        buckets = self._buckets(relative_positions(q_len, k_pad, q_offset, device=device))
        table = self._table(dtype).t().contiguous()  # (heads, buckets)
        bias = torch.index_select(table, 1, buckets.reshape(-1).long()).view(self.num_heads, q_len, k_pad)
        return bias[:, :, :k_len][None]

    def bias_at(self, relative_position: torch.Tensor, *, dtype: torch.dtype) -> torch.Tensor:
        """(..., H) relative position bias of ``relative_position`` (memory -
        query, any shape) in ``dtype``, for this rank's heads."""
        return F.embedding(self._buckets(relative_position).long(), self._table(dtype))

    def _table(self, dtype: torch.dtype) -> torch.Tensor:
        """(num_buckets, H) bias table of this rank's heads in ``dtype``."""
        return self.relative_attention_bias.weight[:, self.head_start:self.head_start + self.num_heads].to(dtype)

    def _buckets(self, relative_position: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        nb, md = cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance
        where = relative_position.device
        if where not in self._bucket_tables:
            self._bucket_tables[where] = distance_buckets(self.bidirectional, nb, md).to(where)
        return _lookup_buckets(relative_position, self._bucket_tables[where], self.bidirectional, nb, md)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*x.shape[:-1], self.num_heads, self.config.d_kv)

    def forward(
        self,
        hidden_states: torch.Tensor,
        attn: Optional[dict] = None,
        cache_kv: Optional[tuple] = None,
        cache_index: Optional[int] = None,
    ) -> torch.Tensor:
        """Self-attention; ``cache_kv`` (k_buf, v_buf, layer) of the stacked
        cache takes this step's k/v rows at ``cache_index``, in place, and
        the attention reads the whole layer slice."""
        b, s, _ = hidden_states.shape
        x = copy_to_model(hidden_states, self.tp)
        q = self._heads(self.q(x))
        k = self._heads(self.k(x))
        v = self._heads(self.v(x))
        if cache_kv is not None:
            k_buf, v_buf, li = cache_kv
            k_buf[li, :, cache_index : cache_index + s] = k
            v_buf[li, :, cache_index : cache_index + s] = v
            k, v = k_buf[li], v_buf[li]
        out = dot_product_attention(q, k, v, scale=None, **(attn or {}))  # T5: no scaling
        return self.o(out.reshape(b, s, self.inner))

    def cross_kv(self, encoder_hidden: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = copy_to_model(encoder_hidden, self.tp)
        return self._heads(self.k(x)), self._heads(self.v(x))

    def self_classes(self, hidden: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """Causal self-attention within (B, C, L) class continuations; ``bias``
        broadcasts to (B, C, H, L, L) and is cast to the model dtype before
        it is added, as in JAX; no scaling."""
        q, k, v = (self._heads(proj(hidden)) for proj in (self.q, self.k, self.v))
        scores = torch.einsum("bclhd,bcmhd->bchlm", q, k) + bias.to(q.dtype)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bchlm,bcmhd->bclhd", probs, v)
        return self.o(ctx.reshape(*hidden.shape[:3], self.inner))

    def cross_classes(self, hidden: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      enc_bias: torch.Tensor) -> torch.Tensor:
        """(B, C, L) class queries over the SHARED (B, S, H, hd) encoder K/V:
        nothing is copied per class."""
        q = self._heads(self.q(hidden))
        scores = torch.einsum("bclhd,bshd->bchls", q, k) + enc_bias.to(q.dtype)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bchls,bshd->bclhd", probs, v)
        return self.o(ctx.reshape(*hidden.shape[:3], self.inner))

    def shared_prefix(self, hidden: torch.Tensor, prefix_k: torch.Tensor, prefix_v: torch.Tensor,
                      prefix_bias: torch.Tensor, self_bias: torch.Tensor) -> torch.Tensor:
        """(B, C, L) continuation tokens over a SHARED, read-only (B, P, H, hd)
        decoder prefix (the cache's K/V: nothing is copied per continuation)
        plus causal self-attention within each continuation: contrastive
        search's candidate expansion is this with C = top_k, L = 1.
        ``prefix_bias`` broadcasts to (B, C, H, L, P), ``self_bias`` to (B,
        C, H, L, L). As in JAX: each bias cast to the query dtype and added,
        the two score blocks concatenated and softmaxed in fp32, the
        probabilities cast back to the hidden dtype, the context the sum of
        the two products; no scaling."""
        q, k, v = (self._heads(proj(hidden)) for proj in (self.q, self.k, self.v))
        scores_p = torch.einsum("bclhd,bphd->bchlp", q, prefix_k) + prefix_bias.to(q.dtype)
        scores_s = torch.einsum("bclhd,bcmhd->bchlm", q, k) + self_bias.to(q.dtype)
        probs = torch.softmax(torch.cat([scores_p, scores_s], dim=-1).float(), dim=-1).to(hidden.dtype)
        p = prefix_k.shape[1]
        ctx = (torch.einsum("bchlp,bphd->bclhd", probs[..., :p], prefix_v)
               + torch.einsum("bchlm,bcmhd->bclhd", probs[..., p:], v))
        return self.o(ctx.reshape(*hidden.shape[:3], self.inner))

    def cross_attend(self, hidden_states: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, s, _ = hidden_states.shape
        q = self._heads(self.q(copy_to_model(hidden_states, self.tp)))
        out = dot_product_attention(q, k, v, padding_mask=padding_mask, scale=None)
        return self.o(out.reshape(b, s, self.inner))


class T5FF(nn.Module):
    def __init__(self, config: T5Config, *, tp=None, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.tp = tp
        kw = {"device": device, "dtype": dtype}
        self.layer_norm = T5LayerNorm(config.d_model, config.layer_norm_epsilon, **kw)
        d_ff = config.d_ff // (tp.size if tp else 1)
        if config.is_gated_act:
            self.wi_0 = MixedLinear(config.d_model, d_ff, bias=False, **kw)
            self.wi_1 = MixedLinear(config.d_model, d_ff, bias=False, **kw)
        else:
            self.wi = MixedLinear(config.d_model, d_ff, bias=False, **kw)
        self.wo = row_parallel(MixedLinear, tp)(d_ff, config.d_model, bias=False, **kw)
        self.dropout = Dropout(config.dropout_rate)

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        if self.config.dense_act_fn == "gelu_new":
            return F.gelu(x, approximate="tanh")
        if self.config.dense_act_fn == "relu":
            return F.relu(x)
        return F.gelu(x, approximate="none")

    def forward(self, x: torch.Tensor, rng: Optional[MaskSource] = None) -> torch.Tensor:
        h = copy_to_model(self.layer_norm(x), self.tp)
        if self.config.is_gated_act:
            h = self._act(self.wi_0(h)) * self.wi_1(h)
        else:
            h = self._act(self.wi(h))
        # HF T5LayerFF: dropout after the activation (on this rank's block of
        # d_ff under tp), then on the residual branch
        h = self.dropout(h, rng, (-1, self.tp))
        return x + self.dropout(self.wo(h), rng)


class T5SelfAttentionLayer(nn.Module):
    def __init__(self, config: T5Config, has_relative_attention_bias: bool = False,
                 bidirectional: bool = True, *, tp=None, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.layer_norm = T5LayerNorm(config.d_model, config.layer_norm_epsilon, **kw)
        self.attention = T5Attention(config, has_relative_attention_bias, bidirectional, tp=tp, **kw)
        self.dropout = Dropout(config.dropout_rate)

    def forward(self, x, attn=None, cache_kv=None, cache_index=None, rng=None):
        out = self.attention(self.layer_norm(x), attn=attn, cache_kv=cache_kv, cache_index=cache_index)
        return x + self.dropout(out, rng)

    def classes(self, x, bias):
        return x + self.attention.self_classes(self.layer_norm(x), bias)

    def shared_prefix(self, x, prefix_k, prefix_v, prefix_bias, self_bias):
        return x + self.attention.shared_prefix(self.layer_norm(x), prefix_k, prefix_v, prefix_bias, self_bias)


class T5CrossAttentionLayer(nn.Module):
    def __init__(self, config: T5Config, *, tp=None, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.layer_norm = T5LayerNorm(config.d_model, config.layer_norm_epsilon, **kw)
        self.attention = T5Attention(config, bidirectional=True, tp=tp, **kw)
        self.dropout = Dropout(config.dropout_rate)

    def forward(self, x, k, v, padding_mask=None, rng=None):
        out = self.attention.cross_attend(self.layer_norm(x), k, v, padding_mask)
        return x + self.dropout(out, rng)

    def classes(self, x, k, v, enc_bias):
        return x + self.attention.cross_classes(self.layer_norm(x), k, v, enc_bias)

    def kv(self, encoder_hidden):
        return self.attention.cross_kv(encoder_hidden)


class T5EncoderLayer(nn.Module):
    def __init__(self, config: T5Config, has_relative_attention_bias: bool = False, *, tp=None,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.self_attention = T5SelfAttentionLayer(config, has_relative_attention_bias, True, tp=tp, **kw)
        self.ff = T5FF(config, tp=tp, **kw)

    def forward(self, x, attn, rng=None):
        return self.ff(self.self_attention(x, attn=attn, rng=rng), rng)


class T5DecoderLayer(nn.Module):
    def __init__(self, config: T5Config, has_relative_attention_bias: bool = False, *, tp=None,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.self_attention = T5SelfAttentionLayer(config, has_relative_attention_bias, False, tp=tp, **kw)
        self.cross_attention = T5CrossAttentionLayer(config, tp=tp, **kw)
        self.ff = T5FF(config, tp=tp, **kw)

    def forward(self, x, self_attn, cross_k, cross_v, cross_padding_mask,
                cache_kv=None, cache_index=None, rng=None):
        x = self.self_attention(x, attn=self_attn, cache_kv=cache_kv, cache_index=cache_index, rng=rng)
        x = self.cross_attention(x, cross_k, cross_v, padding_mask=cross_padding_mask, rng=rng)
        return self.ff(x, rng)

    def classes(self, x, self_bias, cross_k, cross_v, enc_bias):
        x = self.self_attention.classes(x, self_bias)
        x = self.cross_attention.classes(x, cross_k, cross_v, enc_bias)
        return self.ff(x)

    def shared_prefix(self, x, prefix_k, prefix_v, prefix_bias, self_bias, cross_k, cross_v, enc_bias):
        x = self.self_attention.shared_prefix(x, prefix_k, prefix_v, prefix_bias, self_bias)
        x = self.cross_attention.classes(x, cross_k, cross_v, enc_bias)
        return self.ff(x)


def _remat(config: T5Config) -> bool:
    """Per-layer remat where the forward builds a graph (training), as the
    OPT trunk's."""
    return config.remat and torch.is_grad_enabled()


class T5Encoder(nn.Module):
    def __init__(self, config: T5Config, *, tp=None, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = {"device": device, "dtype": dtype}
        self.layers = nn.ModuleList(
            T5EncoderLayer(config, has_relative_attention_bias=(i == 0), tp=tp, **kw)
            for i in range(config.num_layers)
        )
        self.final_layer_norm = T5LayerNorm(config.d_model, config.layer_norm_epsilon, **kw)
        self.dropout = Dropout(config.dropout_rate)

    def forward(self, inputs_embeds: torch.Tensor, attention_mask: Optional[torch.Tensor],
                rng: Optional[MaskSource] = None) -> torch.Tensor:
        s = inputs_embeds.shape[1]
        rel = self.layers[0].self_attention.attention
        bias = rel.compute_bias(s, s, dtype=inputs_embeds.dtype, device=inputs_embeds.device)[0]
        attn = {"bias": bias, "padding_mask": attention_mask}
        x = self.dropout(inputs_embeds, rng)
        remat = _remat(self.config)
        for layer in self.layers:
            x = _remat_layer(layer, x, attn, rng) if remat else layer(x, attn, rng=rng)
        return self.dropout(self.final_layer_norm(x), rng)


class T5Decoder(nn.Module):
    def __init__(self, config: T5Config, *, tp=None, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = {"device": device, "dtype": dtype}
        self.layers = nn.ModuleList(
            T5DecoderLayer(config, has_relative_attention_bias=(i == 0), tp=tp, **kw)
            for i in range(config.num_decoder_layers)
        )
        self.final_layer_norm = T5LayerNorm(config.d_model, config.layer_norm_epsilon, **kw)
        self.dropout = Dropout(config.dropout_rate)

    def forward(
        self,
        inputs_embeds: torch.Tensor,
        encoder_hidden: Optional[torch.Tensor],
        encoder_attention_mask: Optional[torch.Tensor],
        decoder_attention_mask: Optional[torch.Tensor] = None,
        cache: Optional[Cache] = None,
        rng: Optional[MaskSource] = None,
    ) -> tuple[torch.Tensor, Optional[Cache]]:
        """Without a cache: causal self-attention over the (B, S) decoder
        tokens (``decoder_attention_mask`` their padding) and cross-attention
        to ``encoder_hidden``. With a cache: the S tokens are written at
        ``cache['index']`` and attend every slot filled so far (causality is
        the filled-slot mask), the cross K/V come from the cache and
        ``encoder_hidden`` is not read; the cache is updated in place and
        returned."""
        b, s, _ = inputs_embeds.shape
        dtype, device = inputs_embeds.dtype, inputs_embeds.device
        rel = self.layers[0].self_attention.attention
        remat = cache is None and _remat(self.config)
        index = None
        if cache is None:
            self_attn = {
                "bias": rel.compute_bias(s, s, dtype=dtype, device=device)[0],
                "causal": True,
                "padding_mask": decoder_attention_mask,
            }
            # under remat the cross K/V are projected inside each layer's body
            cross = None if remat else [layer.cross_attention.kv(encoder_hidden) for layer in self.layers]
        else:
            index = cache["index"]
            max_len = cache["k"].shape[2]
            if "mask" in cache:
                # the serving engine's slot cache: rows admitted at different
                # times keep a PER-ROW attendable mask whose dead prefix
                # stays 0; the written slots join every row's mask, in place
                # (T5's relative bias is translation-invariant, so a row
                # whose first token sits at any slot sees a fresh cache's
                # distances)
                cache["mask"][:, index : index + s] = 1
                padding_mask = cache["mask"]
            else:
                # decode appends left to right, so "filled" is "attendable";
                # JAX's (1, max_len) mask expanded to the (B, max_len) K5 takes
                filled = (torch.arange(max_len, device=device) < index + s).to(torch.int32)
                padding_mask = filled[None].expand(b, max_len)
            self_attn = {
                "bias": rel.compute_bias(s, max_len, q_offset=index, dtype=dtype, device=device)[0],
                "padding_mask": padding_mask,
            }
            cross = [(cache["cross_k"][i], cache["cross_v"][i]) for i in range(len(self.layers))]

        x = self.dropout(inputs_embeds, rng)
        for i, layer in enumerate(self.layers):
            if remat:
                def body(h, attn, rng=None, layer=layer):
                    ck, cv = layer.cross_attention.kv(encoder_hidden)
                    return layer(h, attn, ck, cv, encoder_attention_mask, rng=rng)

                x = _remat_layer(body, x, self_attn, rng)
                continue
            ckv = None if cache is None else (cache["k"], cache["v"], i)
            x = layer(x, self_attn, *cross[i], encoder_attention_mask, cache_kv=ckv, cache_index=index, rng=rng)
        x = self.dropout(self.final_layer_norm(x), rng)
        if cache is not None:
            cache["index"] = index + s
        return x, cache

    def spec_append(
        self,
        dec_embeds: torch.Tensor,
        encoder_attention_mask: Optional[torch.Tensor],
        cache: Cache,
        active: torch.Tensor,
    ) -> tuple[torch.Tensor, Cache]:
        """A multi-token cached append over the serving slot cache (with its
        per-row ``mask``): the (B, s) block ``dec_embeds`` is written at
        ``cache['index']``; query j sees the kept slots up to its own (no
        later draft of the block) and always itself. The relative bias is
        taken over ATTENDED-token positions (the cumsum of the row's mask),
        so rejection holes collapse out of T5's distance buckets as in a
        fresh contiguous cache. ``active`` (B,) gates whole rows, or (B, s)
        single block positions (the evict-replay block's pad tail): gated
        writes stay out of the persisted mask. The bias is (B, H, s, L) in
        fp32, so the attention takes the plain path (K5 takes an (H, S, L)
        bias only, as JAX's Pallas kernel). Returns (final norm output,
        cache), the cache updated in place."""
        b, s, _ = dec_embeds.shape
        device, dtype = dec_embeds.device, dec_embeds.dtype
        index = cache["index"]
        max_len = cache["k"].shape[2]
        active2 = active[:, None] if active.ndim == 1 else active
        mask = cache["mask"]
        mask[:, index : index + s] = torch.maximum(mask[:, index : index + s],
                                                   active2.expand(b, s).to(mask.dtype))
        tok_pos = torch.cumsum(mask, dim=1) - 1  # (B, L): holes collapse out of the distances
        qpos = tok_pos[:, index : index + s]
        rel = self.layers[0].self_attention.attention
        bias = rel.bias_at(tok_pos[:, None, :] - qpos[:, :, None], dtype=dtype)  # (B, s, L, H)
        bias = bias.permute(0, 3, 1, 2).float()
        slot_pos = torch.arange(max_len, device=device)[None, :]
        q_slot = index + torch.arange(s, device=device)[:, None]
        attend = ((mask[:, None, :] > 0) & (slot_pos <= q_slot)[None]) | (slot_pos == q_slot)[None]
        bias = torch.where(attend[:, None], bias, torch.finfo(torch.float32).min)
        x = dec_embeds
        for i, layer in enumerate(self.layers):
            x = layer(x, {"bias": bias}, cache["cross_k"][i], cache["cross_v"][i], encoder_attention_mask,
                      cache_kv=(cache["k"], cache["v"], i), cache_index=index)
        cache["index"] = index + s
        return self.final_layer_norm(x), cache

    def make_cross_kv(self, encoder_hidden: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Every layer's cross K/V, stacked: (num_decoder_layers, B, P, H, hd) each."""
        ks, vs = zip(*(layer.cross_attention.kv(encoder_hidden) for layer in self.layers))
        return torch.stack(ks), torch.stack(vs)

    def score_classes(
        self,
        class_embeds: torch.Tensor,
        class_attention_mask: torch.Tensor,
        encoder_hidden: torch.Tensor,
        encoder_attention_mask: Optional[torch.Tensor],
    ) -> torch.Tensor:
        """(B, C, L) class continuations against the SHARED (B, S) encoder
        states; returns the final norm's output (B, C, L, D)."""
        b, c, l, _ = class_embeds.shape
        device = class_embeds.device
        rel = self.layers[0].self_attention.attention
        cls_mask = class_attention_mask.bool()  # (B, C, L) or (C, L)
        if cls_mask.ndim == 2:
            cls_mask = cls_mask[None].expand(b, c, l)
        # (1, 1, H, L, L) relative + (1, 1, 1, L, L) causal + (B, C, 1, 1, L)
        # padding, each fp32 and ADDED (two finfo.min terms give -inf, as in JAX)
        self_bias = (
            rel.compute_bias(l, l, dtype=class_embeds.dtype, device=device)[None].float()
            + make_causal_bias(l, l, device=device)[None]
            + mask_to_bias(cls_mask)[:, :, None, None, :]
        )
        if encoder_attention_mask is not None:
            enc_bias = mask_to_bias(encoder_attention_mask.bool())[:, None, None, None, :]
        else:
            enc_bias = torch.zeros(b, 1, 1, 1, encoder_hidden.shape[1], device=device)
        x = class_embeds
        for layer in self.layers:
            ck, cv = layer.cross_attention.kv(encoder_hidden)
            x = layer.classes(x, self_bias, ck, cv, enc_bias)
        return self.final_layer_norm(x)

    def candidates(self, cand_embeds: torch.Tensor, encoder_attention_mask: Optional[torch.Tensor],
                   cache: Cache) -> torch.Tensor:
        """Contrastive search's candidate expansion over the decode cache: the
        (B, C, 1, D) ``cand_embeds`` are C one-token candidates, all at
        decoder position ``cache['index']``, read against the shared self
        cache and the cached cross K/V (nothing copied per candidate, nothing
        committed: the cache is not written). As in JAX, the filled slots are
        ``slot < index`` (a contiguous decode prefix; a serving cache's
        per-row ``mask`` is not read). Returns the final norm's output (B, C,
        1, D), HF's ``decoder_hidden_states[-1]`` of each candidate."""
        b, c, l, _ = cand_embeds.shape
        dtype, device = cand_embeds.dtype, cand_embeds.device
        index = cache["index"]
        max_len = cache["k"].shape[2]
        rel = self.layers[0].self_attention.attention
        filled = (torch.arange(max_len, device=device) < index).expand(b, max_len)
        # (1, 1, H, 1, P) relative bias of a query at position index + (B, 1,
        # 1, 1, P) unfilled-slot mask, both fp32 and ADDED, as in JAX
        prefix_bias = (rel.compute_bias(1, max_len, q_offset=index, dtype=dtype, device=device)[None].float()
                       + mask_to_bias(filled)[:, None, None, None, :])
        # each candidate attends itself at distance 0
        self_bias = rel.compute_bias(1, 1, dtype=dtype, device=device)[None].float()
        if encoder_attention_mask is not None:
            enc_bias = mask_to_bias(encoder_attention_mask.bool())[:, None, None, None, :]
        else:
            enc_bias = torch.zeros(b, 1, 1, 1, cache["cross_k"].shape[2], device=device)
        x = cand_embeds
        for i, layer in enumerate(self.layers):
            x = layer.shared_prefix(x, cache["k"][i], cache["v"][i], prefix_bias, self_bias,
                                    cache["cross_k"][i], cache["cross_v"][i], enc_bias)
        return self.final_layer_norm(x)


class T5ForConditionalGeneration(nn.Module):
    """T5 with an explicit decode cache. It computes in ``compute_dtype``: the
    embeddings are cast to it and every layer casts its parameters at use.
    ``None`` (the default) follows the parameters' dtype. ``tp`` (a
    ``parallel.tensor.TensorParallel``) shards it where the model axis
    divides its heads and FFN width."""

    def __init__(self, config: T5Config, *, tp=None, device=None, dtype=None, compute_dtype=None):
        super().__init__()
        self.config = config
        self.compute_dtype = compute_dtype
        self.tp = tp = tower_tp(tp, config)
        kw = {"device": device, "dtype": dtype}
        self.shared = vocab_embedding(config.vocab_size, config.d_model, tp, **kw)
        self.encoder = T5Encoder(config, tp=tp, **kw)
        self.decoder = T5Decoder(config, tp=tp, **kw)
        rows = config.vocab_size if tp is None else vocab_block(config.vocab_size, tp)
        self.lm_head = None if config.tie_word_embeddings else MixedLinear(config.d_model, rows, bias=False, **kw)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        embeds = self.shared(input_ids)
        return embeds if self.compute_dtype is None else embeds.to(self.compute_dtype)

    def _head(self, hidden: torch.Tensor, local: bool = False) -> torch.Tensor:
        """The logits: the full vocabulary on every rank, or with ``local``
        (under ``tp``) this rank's block of it."""
        hidden = copy_to_model(hidden, self.tp)
        if self.config.tie_word_embeddings:
            hidden = hidden * _scalar(self.config.d_model**-0.5, hidden)
            logits = F.linear(hidden, self.shared.weight.to(hidden.dtype))
        else:
            logits = self.lm_head(hidden)
        if self.tp is None or local:
            return logits
        return gather_vocab(logits, self.tp, self.config.vocab_size)

    def encode(self, inputs_embeds: torch.Tensor, attention_mask: Optional[torch.Tensor],
               rng: Optional[MaskSource] = None) -> torch.Tensor:
        return self.encoder(inputs_embeds, attention_mask, rng)

    # ---- pipeline-parallel plumbing (parallel/pipeline.py): the encoder
    # and decoder layer trunks run as GPipe schedules over the layer
    # modules; the shared relative-position biases are computed here, from
    # layer 0's embedding, and passed to every stage whole

    def _rel_bias(self, stack, s: int) -> torch.Tensor:
        """(H, s, s) relative bias of ``stack``'s layer 0 in the compute
        dtype, on the device of its bias table."""
        attention = stack.layers[0].self_attention.attention
        dtype = self.compute_dtype or self.shared.weight.dtype
        return attention.compute_bias(s, s, dtype=dtype, device=attention.relative_attention_bias.weight.device)[0]

    def encoder_rel_bias(self, s: int) -> torch.Tensor:
        return self._rel_bias(self.encoder, s)

    def decoder_rel_bias(self, s: int) -> torch.Tensor:
        return self._rel_bias(self.decoder, s)

    def encoder_post(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder.final_layer_norm(x)

    def decoder_post(self, x: torch.Tensor) -> torch.Tensor:
        """The final decoder norm and the lm head after the decoder trunk."""
        return self._head(self.decoder.final_layer_norm(x))

    def forward(
        self,
        encoder_inputs_embeds: torch.Tensor,
        encoder_attention_mask: Optional[torch.Tensor] = None,
        decoder_input_ids: Optional[torch.Tensor] = None,
        decoder_attention_mask: Optional[torch.Tensor] = None,
        rng: Optional[MaskSource] = None,
        local_logits: bool = False,
    ) -> torch.Tensor:
        """The training / scoring forward: (B, S_dec, vocab) logits (with
        ``local_logits`` under ``tp``, this rank's vocab block of them)."""
        encoder_hidden = self.encoder(encoder_inputs_embeds, encoder_attention_mask, rng)
        hidden, _ = self.decoder(
            self.embed(decoder_input_ids), encoder_hidden, encoder_attention_mask,
            decoder_attention_mask, rng=rng,
        )
        return self._head(hidden, local=local_logits)

    def init_decode_cache(self, encoder_hidden: torch.Tensor, max_len: int) -> Cache:
        """The decode cache of ``max_len`` self-attention slots, with every
        layer's cross K/V projected once from ``encoder_hidden``."""
        cfg = self.config
        cross_k, cross_v = self.decoder.make_cross_kv(encoder_hidden)
        heads = cross_k.shape[3]  # this rank's under tp
        shape = (cfg.num_decoder_layers, encoder_hidden.shape[0], max_len, heads, cfg.d_kv)
        kw = {"dtype": encoder_hidden.dtype, "device": encoder_hidden.device}
        return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw),
                "cross_k": cross_k, "cross_v": cross_v, "index": 0}

    def score_classes(
        self,
        class_decoder_ids: torch.Tensor,
        class_attention_mask: torch.Tensor,
        encoder_hidden: torch.Tensor,
        encoder_attention_mask: Optional[torch.Tensor],
        local_logits: bool = False,
    ) -> torch.Tensor:
        """(B, C, L, vocab) logits of class continuations over the shared
        encoder states (this rank's vocab block with ``local_logits`` under
        ``tp``); ``class_decoder_ids`` (C, L) or (B, C, L) are already
        shifted right."""
        b = encoder_hidden.shape[0]
        c, l = class_decoder_ids.shape[-2:]
        emb = self.embed(class_decoder_ids)
        if emb.ndim == 3:  # (C, L, D) shared across the batch
            emb = emb[None].expand(b, c, l, emb.shape[-1])
        hidden = self.decoder.score_classes(emb, class_attention_mask, encoder_hidden, encoder_attention_mask)
        return self._head(hidden, local=local_logits)

    def decode_step(
        self,
        decoder_input_ids: torch.Tensor,
        encoder_hidden: Optional[torch.Tensor],
        encoder_attention_mask: Optional[torch.Tensor],
        cache: Cache,
    ) -> tuple[torch.Tensor, Cache]:
        """(logits, cache) of the decoder tokens written at ``cache['index']``
        (``encoder_hidden`` is not read: the cross K/V are in the cache)."""
        logits, _, cache = self.decode_step_hidden(decoder_input_ids, encoder_hidden, encoder_attention_mask, cache)
        return logits, cache

    def decode_step_hidden(
        self,
        decoder_input_ids: torch.Tensor,
        encoder_hidden: Optional[torch.Tensor],
        encoder_attention_mask: Optional[torch.Tensor],
        cache: Cache,
    ) -> tuple[torch.Tensor, torch.Tensor, Cache]:
        """:meth:`decode_step` that also returns the final norm's output (HF's
        ``decoder_hidden_states[-1]``): (logits, hidden, cache), contrastive
        search's context."""
        hidden, cache = self.decoder(self.embed(decoder_input_ids), encoder_hidden, encoder_attention_mask,
                                     cache=cache)
        return self._head(hidden), hidden, cache

    def candidates(self, cand_ids: torch.Tensor, encoder_attention_mask: Optional[torch.Tensor],
                   cache: Cache) -> torch.Tensor:
        """(B, C, D) final-norm hidden of the (B, C) candidate tokens, all at
        the next decoder position, over the shared decode cache
        (:meth:`T5Decoder.candidates`; the cache is not written)."""
        hidden = self.decoder.candidates(self.embed(cand_ids)[:, :, None], encoder_attention_mask, cache)
        return hidden[:, :, 0]

    def decode_append(
        self,
        decoder_input_ids: torch.Tensor,
        encoder_attention_mask: Optional[torch.Tensor],
        cache: Cache,
        active: torch.Tensor,
    ) -> tuple[torch.Tensor, Cache]:
        """(B, s, vocab) logits of a speculative verify block over the
        serving slot cache (:meth:`T5Decoder.spec_append`)."""
        hidden, cache = self.decoder.spec_append(self.embed(decoder_input_ids), encoder_attention_mask, cache,
                                                 active)
        return self._head(hidden), cache
