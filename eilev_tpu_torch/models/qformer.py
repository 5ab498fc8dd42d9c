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

Under tensor parallelism (``tp``, ``parallel/tensor.py``) the self- and
cross-attention's ``query``/``key``/``value`` and the FFN's ``intermediate``
are column-parallel (the rank's heads, its block of the FFN), ``dense`` and
the FFN's ``output`` row-parallel: the all_reduce comes before each residual
add and LayerNorm. A model axis that does not divide the heads (12 at tp 8)
leaves the Q-Former whole on every rank. In training the column inputs go
through ``parallel.tensor.copy_to_model`` (their gradient summed over the
model group), and the attention output's dropout, whose heads are sharded,
draws the unsharded mask and keeps the rank's heads (``ops/dropout.py``).
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
from ..parallel.tensor import copy_to_model, row_parallel, tower_tp
from .mixed_precision import MixedLayerNorm, mixed_dense_cls


def _dense_cls(config: QFormerConfig) -> type:
    """The W8A8 layer in serving mode, else a layer that computes in its
    input's dtype."""
    return mixed_dense_cls(vision_dense_cls(config))


class QFormerMultiHeadAttention(nn.Module):
    def __init__(self, config: QFormerConfig, is_cross_attention: bool = False, *, tp=None,
                 device=None, dtype=None):
        super().__init__()
        self.config = config
        self.tp = tp
        kw = {"device": device, "dtype": dtype}
        d = config.hidden_size
        self.num_heads = config.num_attention_heads // (tp.size if tp else 1)
        inner = self.num_heads * config.head_dim
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
        nh, hd = self.num_heads, self.config.head_dim
        x = copy_to_model(hidden_states, self.tp)
        kv = copy_to_model(kv_states, self.tp) if kv_states is not None else x
        b, s, _ = hidden_states.shape
        l = kv.shape[1]
        q = self.query(x).reshape(b, s, nh, hd)
        k = self.key(kv).reshape(b, l, nh, hd)
        v = self.value(kv).reshape(b, l, nh, hd)
        out = dot_product_attention(q, k, v, padding_mask=padding_mask, scale=hd**-0.5)
        return self.dropout(out, rng, (2, self.tp)).reshape(b, s, nh * hd)


class QFormerSelfOutput(nn.Module):
    """dense -> residual add -> LayerNorm (post-LN BERT)."""

    def __init__(self, config: QFormerConfig, *, tp=None, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        d = config.hidden_size
        self.dense = row_parallel(_dense_cls(config), tp)(d // (tp.size if tp else 1), d, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.layer_norm = MixedLayerNorm(d, eps=config.layer_norm_eps, **kw)

    def forward(
        self, hidden_states: torch.Tensor, input_tensor: torch.Tensor,
        rng: Optional[MaskSource] = None,
    ) -> torch.Tensor:
        return self.layer_norm(self.dropout(self.dense(hidden_states), rng) + input_tensor)


class QFormerAttention(nn.Module):
    def __init__(self, config: QFormerConfig, is_cross_attention: bool = False, *, tp=None,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.attention = QFormerMultiHeadAttention(config, is_cross_attention, tp=tp, **kw)
        self.output = QFormerSelfOutput(config, tp=tp, **kw)

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

    def __init__(self, config: QFormerConfig, *, tp=None, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.tp = tp
        d = config.hidden_size
        dense = _dense_cls(config)
        ffn = config.intermediate_size // (tp.size if tp else 1)
        self.intermediate = dense(d, ffn, **kw)
        self.output = row_parallel(dense, tp)(ffn, d, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.layer_norm = MixedLayerNorm(d, eps=config.layer_norm_eps, **kw)

    def forward(self, hidden_states: torch.Tensor, rng: Optional[MaskSource] = None) -> torch.Tensor:
        x = self.output(F.gelu(self.intermediate(copy_to_model(hidden_states, self.tp)), approximate="none"))
        return self.layer_norm(self.dropout(x, rng) + hidden_states)


class QFormerLayer(nn.Module):
    def __init__(self, config: QFormerConfig, has_cross_attention: bool = False, *, tp=None,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.attention = QFormerAttention(config, tp=tp, **kw)
        self.crossattention = (
            QFormerAttention(config, is_cross_attention=True, tp=tp, **kw)
            if has_cross_attention
            else None
        )
        self.ffn_query = QFormerFFN(config, tp=tp, **kw)

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
    ``tp`` (a ``parallel.tensor.TensorParallel``) shards it where the model
    axis divides its heads and FFN width.
    """

    def __init__(self, config: QFormerConfig, *, tp=None, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        tp = tower_tp(tp, config)
        self.layernorm = MixedLayerNorm(config.hidden_size, eps=config.layer_norm_eps, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.layers = nn.ModuleList(
            QFormerLayer(config, i % config.cross_attention_frequency == 0, tp=tp, **kw)
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
