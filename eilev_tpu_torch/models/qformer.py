"""Q-Former (counterpart of ``eilev_tpu/models/qformer.py``).

Parity target: ``transformers.Blip2QFormerModel`` on the query-token-only path,
the only path EILeV uses. Post-LN BERT blocks: self-attention ->
cross-attention on layers where ``i % cross_attention_frequency == 0`` ->
query FFN. Attention goes through ``ops/attention.dot_product_attention`` with
score-side scaling, as in JAX: at q=32 queries ``auto`` takes the plain path.
The FFN's gelu is always exact erf, as in the JAX module (the fast-gelu
serving switch is the vision tower's). With ``config.quantize_matmuls``
(serving mode) every matmul is a W8A8 int8 layer (``ops/quantization.py``).

Dropout sits where the JAX module has it (``ops/dropout.py``): the embedding
LayerNorm's output, each attention's OUTPUT (B, q, heads, head_dim) (the
JAX module's choice: HF drops the probabilities), each self-output dense and
the FFN output. It is active in training mode when the forward is given a
mask source ``rng``.

Every layer computes in its input's dtype (``models/mixed_precision.py``):
the training recipe holds this subtree in fp32 master weights inside a bf16
model, and the activations stay bf16, as flax's ``dtype`` keeps them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import QFormerConfig
from ..ops.attention import dot_product_attention
from ..ops.dropout import Dropout, MaskSource
from ..ops.quantization import vision_dense_cls
from .mixed_precision import MixedLayerNorm, MixedLinear


def _dense_cls(config: QFormerConfig) -> type:
    """The W8A8 layer in serving mode, else a layer that computes in its
    input's dtype."""
    cls = vision_dense_cls(config)
    return MixedLinear if cls is nn.Linear else cls


class QFormerMultiHeadAttention(nn.Module):
    def __init__(self, config: QFormerConfig, is_cross_attention: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = {"device": device, "dtype": dtype}
        d = config.hidden_size
        inner = config.num_attention_heads * config.head_dim
        kv_in = config.encoder_hidden_size if is_cross_attention else d
        dense = _dense_cls(config)
        self.query = dense(d, inner, **kw)
        self.key = dense(kv_in, inner, **kw)
        self.value = dense(kv_in, inner, **kw)
        self.dropout = Dropout(config.attention_probs_dropout_prob)

    def forward(
        self,
        hidden_states: torch.Tensor,
        kv_states: Optional[torch.Tensor] = None,
        padding_mask: Optional[torch.Tensor] = None,
        rng: Optional[MaskSource] = None,
    ) -> torch.Tensor:
        cfg = self.config
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        kv = kv_states if kv_states is not None else hidden_states
        b, s, _ = hidden_states.shape
        l = kv.shape[1]
        q = self.query(hidden_states).reshape(b, s, nh, hd)
        k = self.key(kv).reshape(b, l, nh, hd)
        v = self.value(kv).reshape(b, l, nh, hd)
        out = dot_product_attention(q, k, v, padding_mask=padding_mask, scale=hd**-0.5)
        return self.dropout(out, rng).reshape(b, s, nh * hd)


class QFormerSelfOutput(nn.Module):
    """dense -> residual add -> LayerNorm (post-LN BERT)."""

    def __init__(self, config: QFormerConfig, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        d = config.hidden_size
        self.dense = _dense_cls(config)(d, d, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.layer_norm = MixedLayerNorm(d, eps=config.layer_norm_eps, **kw)

    def forward(
        self, hidden_states: torch.Tensor, input_tensor: torch.Tensor,
        rng: Optional[MaskSource] = None,
    ) -> torch.Tensor:
        return self.layer_norm(self.dropout(self.dense(hidden_states), rng) + input_tensor)


class QFormerAttention(nn.Module):
    def __init__(self, config: QFormerConfig, is_cross_attention: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.attention = QFormerMultiHeadAttention(config, is_cross_attention, **kw)
        self.output = QFormerSelfOutput(config, **kw)

    def forward(
        self,
        hidden_states: torch.Tensor,
        kv_states: Optional[torch.Tensor] = None,
        padding_mask: Optional[torch.Tensor] = None,
        rng: Optional[MaskSource] = None,
    ) -> torch.Tensor:
        attn_out = self.attention(hidden_states, kv_states=kv_states, padding_mask=padding_mask, rng=rng)
        return self.output(attn_out, hidden_states, rng)


class QFormerFFN(nn.Module):
    """intermediate (dense + gelu) -> output (dense -> residual -> LayerNorm)."""

    def __init__(self, config: QFormerConfig, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        d = config.hidden_size
        dense = _dense_cls(config)
        self.intermediate = dense(d, config.intermediate_size, **kw)
        self.output = dense(config.intermediate_size, d, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.layer_norm = MixedLayerNorm(d, eps=config.layer_norm_eps, **kw)

    def forward(self, hidden_states: torch.Tensor, rng: Optional[MaskSource] = None) -> torch.Tensor:
        x = self.output(F.gelu(self.intermediate(hidden_states), approximate="none"))
        return self.layer_norm(self.dropout(x, rng) + hidden_states)


class QFormerLayer(nn.Module):
    def __init__(self, config: QFormerConfig, has_cross_attention: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.attention = QFormerAttention(config, **kw)
        self.crossattention = (
            QFormerAttention(config, is_cross_attention=True, **kw)
            if has_cross_attention
            else None
        )
        self.ffn_query = QFormerFFN(config, **kw)

    def forward(
        self,
        hidden_states: torch.Tensor,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        encoder_padding_mask: Optional[torch.Tensor] = None,
        rng: Optional[MaskSource] = None,
    ) -> torch.Tensor:
        x = self.attention(hidden_states, rng=rng)
        if self.crossattention is not None:
            if encoder_hidden_states is None:
                raise ValueError("a cross-attention layer needs encoder_hidden_states")
            x = self.crossattention(
                x, kv_states=encoder_hidden_states, padding_mask=encoder_padding_mask, rng=rng
            )
        return self.ffn_query(x, rng)


class QFormerModel(nn.Module):
    """Query-token-only Q-Former.

    ``query_embeds``: (B, num_query_tokens, hidden); ``encoder_hidden_states``:
    (B, kv_len, encoder_hidden_size); optional ``encoder_attention_mask``:
    (B, kv_len), 1 = attend. Returns (B, num_query_tokens, hidden) in the
    dtype of ``encoder_hidden_states``, the compute dtype (flax casts the
    query embeddings to its ``dtype``); ``rng`` is the dropout mask source.
    """

    def __init__(self, config: QFormerConfig, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.layernorm = MixedLayerNorm(config.hidden_size, eps=config.layer_norm_eps, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.layers = nn.ModuleList(
            QFormerLayer(config, i % config.cross_attention_frequency == 0, **kw)
            for i in range(config.num_hidden_layers)
        )

    def forward(
        self,
        query_embeds: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        encoder_attention_mask: Optional[torch.Tensor] = None,
        rng: Optional[MaskSource] = None,
    ) -> torch.Tensor:
        x = self.dropout(self.layernorm(query_embeds.to(encoder_hidden_states.dtype)), rng)
        for layer in self.layers:
            x = layer(x, encoder_hidden_states, encoder_attention_mask, rng)
        return x
