"""Q-Former (counterpart of ``eilev_tpu/models/qformer.py``).

Parity target: ``transformers.Blip2QFormerModel`` on the query-token-only path,
the only path EILeV uses. Post-LN BERT blocks: self-attention ->
cross-attention on layers where ``i % cross_attention_frequency == 0`` ->
query FFN. Attention goes through ``ops/attention.dot_product_attention`` with
score-side scaling, as in JAX: at q=32 queries ``auto`` takes the plain path. Inference only, so
no dropout. The FFN's gelu is always exact erf, as in the JAX module (the
fast-gelu serving switch is the vision tower's). With
``config.quantize_matmuls`` (serving mode) every matmul is a W8A8 int8 layer
(``ops/quantization.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import QFormerConfig
from ..ops.attention import dot_product_attention
from ..ops.quantization import vision_dense_cls


class QFormerMultiHeadAttention(nn.Module):
    def __init__(self, config: QFormerConfig, is_cross_attention: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = {"device": device, "dtype": dtype}
        d = config.hidden_size
        inner = config.num_attention_heads * config.head_dim
        kv_in = config.encoder_hidden_size if is_cross_attention else d
        dense = vision_dense_cls(config)
        self.query = dense(d, inner, **kw)
        self.key = dense(kv_in, inner, **kw)
        self.value = dense(kv_in, inner, **kw)

    def forward(
        self,
        hidden_states: torch.Tensor,
        kv_states: Optional[torch.Tensor] = None,
        padding_mask: Optional[torch.Tensor] = None,
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
        return out.reshape(b, s, nh * hd)


class QFormerSelfOutput(nn.Module):
    """dense -> residual add -> LayerNorm (post-LN BERT)."""

    def __init__(self, config: QFormerConfig, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        d = config.hidden_size
        self.dense = vision_dense_cls(config)(d, d, **kw)
        self.layer_norm = nn.LayerNorm(d, eps=config.layer_norm_eps, **kw)

    def forward(self, hidden_states: torch.Tensor, input_tensor: torch.Tensor) -> torch.Tensor:
        return self.layer_norm(self.dense(hidden_states) + input_tensor)


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
    ) -> torch.Tensor:
        attn_out = self.attention(hidden_states, kv_states=kv_states, padding_mask=padding_mask)
        return self.output(attn_out, hidden_states)


class QFormerFFN(nn.Module):
    """intermediate (dense + gelu) -> output (dense -> residual -> LayerNorm)."""

    def __init__(self, config: QFormerConfig, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        d = config.hidden_size
        dense = vision_dense_cls(config)
        self.intermediate = dense(d, config.intermediate_size, **kw)
        self.output = dense(config.intermediate_size, d, **kw)
        self.layer_norm = nn.LayerNorm(d, eps=config.layer_norm_eps, **kw)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        x = self.output(F.gelu(self.intermediate(hidden_states), approximate="none"))
        return self.layer_norm(x + hidden_states)


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
    ) -> torch.Tensor:
        x = self.attention(hidden_states)
        if self.crossattention is not None:
            if encoder_hidden_states is None:
                raise ValueError("a cross-attention layer needs encoder_hidden_states")
            x = self.crossattention(
                x, kv_states=encoder_hidden_states, padding_mask=encoder_padding_mask
            )
        return self.ffn_query(x)


class QFormerModel(nn.Module):
    """Query-token-only Q-Former.

    ``query_embeds``: (B, num_query_tokens, hidden); ``encoder_hidden_states``:
    (B, kv_len, encoder_hidden_size); optional ``encoder_attention_mask``:
    (B, kv_len), 1 = attend. Returns (B, num_query_tokens, hidden).
    """

    def __init__(self, config: QFormerConfig, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.layernorm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps, **kw)
        self.layers = nn.ModuleList(
            QFormerLayer(config, i % config.cross_attention_frequency == 0, **kw)
            for i in range(config.num_hidden_layers)
        )

    def forward(
        self,
        query_embeds: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        encoder_attention_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        x = self.layernorm(query_embeds.to(self.layernorm.weight.dtype))
        for layer in self.layers:
            x = layer(x, encoder_hidden_states, encoder_attention_mask)
        return x
