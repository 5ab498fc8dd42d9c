"""Bidirectional text encoders for the model-based quality metrics
(counterpart of ``eilev_tpu/eval/encoder.py``).

The original EILeV's metric suite (its scripts/general/generation_eval.py:
14-72) runs three pretrained encoders through sentence-transformers and
torchmetrics:
  - STS bi-encoder: ``all-mpnet-base-v2`` (MPNet, mean pooling, cosine),
  - STS cross-encoder: ``cross-encoder/stsb-roberta-large`` (RoBERTa +
    regression head, sigmoid),
  - BERTScore: greedy token matching over contextual embeddings
    (torchmetrics default model: roberta-large).

This module holds all three model families as the JAX module has them (BERT
/ RoBERTa / MPNet share one post-LayerNorm encoder body; MPNet adds a shared
relative-attention bias, RoBERTa/MPNet offset positions past the padding
idx), with the JAX module's names, so a flax tree maps onto it by
``models/convert.flax_to_state_dict``'s rule and an HF state dict by
:func:`convert_encoder`. The attention is plain ``torch.matmul`` work with an
additive mask bias of ``finfo(float32).min``, as JAX computes it outside any
kernel. MPNet's relative buckets come from ``models/t5.relative_position_bucket``,
whose distance -> bucket map is evaluated on the CPU, so they are bit-equal
to JAX's on any device.

:class:`SentenceEncoder` reads an HF ``save_pretrained`` directory (its
``*.safetensors`` through ``models/safetensors_io.py``, the tokenizer through
``models/auto.load_tokenizer``) onto ``device``, the card unless the caller
asks for the CPU. :func:`bertscore_native` is BERTScore's greedy cosine
matching on the host, in numpy, as in JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.t5 import relative_position_bucket


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    model_type: str = "bert"  # bert | roberta | mpnet
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    relative_attention_num_buckets: int = 32  # mpnet
    hidden_act: str = "gelu"
    num_labels: int = 0  # >0 adds the sequence-classification head (cross-encoder)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def encoder_config_from_hf(hf: dict, *, num_labels: int = 0) -> EncoderConfig:
    return EncoderConfig(
        model_type=hf.get("model_type", "bert"),
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf.get("max_position_embeddings", 512),
        type_vocab_size=hf.get("type_vocab_size", 2),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
        pad_token_id=hf.get("pad_token_id", 1 if hf.get("model_type") in ("roberta", "mpnet") else 0),
        relative_attention_num_buckets=hf.get("relative_attention_num_buckets", 32),
        hidden_act=hf.get("hidden_act", "gelu"),
        num_labels=num_labels,
    )


class _SelfAttention(nn.Module):
    def __init__(self, config: EncoderConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        d, kw = config.hidden_size, {"device": device, "dtype": dtype}
        self.query = nn.Linear(d, d, **kw)
        self.key = nn.Linear(d, d, **kw)
        self.value = nn.Linear(d, d, **kw)
        self.dense = nn.Linear(d, d, **kw)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor, position_bias: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.config
        b, s, d = x.shape
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        q = self.query(x).reshape(b, s, nh, hd).transpose(1, 2)  # (B, H, S, hd)
        k = self.key(x).reshape(b, s, nh, hd).transpose(1, 2)
        v = self.value(x).reshape(b, s, nh, hd).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(float(hd))  # (B, H, S, L)
        if position_bias is not None:
            scores = scores + position_bias
        scores = scores + mask_bias
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.matmul(probs.to(v.dtype), v).transpose(1, 2).reshape(b, s, d)
        return self.dense(ctx)


class _Layer(nn.Module):
    def __init__(self, config: EncoderConfig, *, device=None, dtype=None):
        super().__init__()
        d, eps, kw = config.hidden_size, config.layer_norm_eps, {"device": device, "dtype": dtype}
        self.attention = _SelfAttention(config, **kw)
        self.attention_layer_norm = nn.LayerNorm(d, eps=eps, **kw)
        self.intermediate = nn.Linear(d, config.intermediate_size, **kw)
        self.output = nn.Linear(config.intermediate_size, d, **kw)
        self.output_layer_norm = nn.LayerNorm(d, eps=eps, **kw)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor, position_bias: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.attention_layer_norm(x + self.attention(x, mask_bias, position_bias))
        h = self.output(F.gelu(self.intermediate(x)))
        return self.output_layer_norm(x + h)


class TextEncoder(nn.Module):
    """BERT/RoBERTa/MPNet body. Returns all hidden states (num_layers+1, B, S, D)
    so BERTScore can pick its per-model layer."""

    def __init__(self, config: EncoderConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        d, kw = config.hidden_size, {"device": device, "dtype": dtype}
        self.word_embeddings = nn.Embedding(config.vocab_size, d, **kw)
        self.position_embeddings = nn.Embedding(config.max_position_embeddings, d, **kw)
        if config.model_type in ("bert", "roberta"):
            self.token_type_embeddings = nn.Embedding(config.type_vocab_size, d, **kw)
        self.embeddings_layer_norm = nn.LayerNorm(d, eps=config.layer_norm_eps, **kw)
        if config.model_type == "mpnet":
            self.relative_attention_bias = nn.Embedding(
                config.relative_attention_num_buckets, config.num_attention_heads, **kw)
        self.layers = nn.ModuleList(_Layer(config, **kw) for _ in range(config.num_hidden_layers))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, s = input_ids.shape
        mask = attention_mask.to(torch.int32)
        if cfg.model_type in ("roberta", "mpnet"):
            # HF create_position_ids_from_input_ids: past the padding idx
            positions = torch.cumsum(mask, dim=1, dtype=torch.int32) * mask + cfg.pad_token_id
        else:
            positions = torch.arange(s, device=input_ids.device).expand(b, s)
        x = self.word_embeddings(input_ids) + self.position_embeddings(positions.long())
        if cfg.model_type in ("bert", "roberta"):
            x = x + self.token_type_embeddings(torch.zeros_like(input_ids))
        x = self.embeddings_layer_norm(x)

        neg = torch.tensor(torch.finfo(torch.float32).min, device=x.device)
        mask_bias = torch.where(mask.bool(), torch.zeros((), device=x.device), neg)[:, None, None, :]

        position_bias = None
        if cfg.model_type == "mpnet":
            # shared relative-attention bias table (MPNetEncoder.compute_position_bias)
            ctx = torch.arange(s, dtype=torch.int32, device=x.device)[:, None]
            mem = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
            buckets = relative_position_bucket(
                mem - ctx, bidirectional=True, num_buckets=cfg.relative_attention_num_buckets, max_distance=128)
            table = self.relative_attention_bias(buckets.long())  # (S, S, H)
            position_bias = table.permute(2, 0, 1)[None]  # (1, H, S, S)

        hiddens = [x]
        for layer in self.layers:
            x = layer(x, mask_bias, position_bias)
            hiddens.append(x)
        return torch.stack(hiddens)


class CrossEncoderModel(nn.Module):
    """RoBERTa sequence-classification head over the first token: the
    cross-encoder path (sentence-transformers CrossEncoder semantics:
    sigmoid for num_labels == 1)."""

    def __init__(self, config: EncoderConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        d, kw = config.hidden_size, {"device": device, "dtype": dtype}
        self.encoder = TextEncoder(config, **kw)
        self.classifier_dense = nn.Linear(d, d, **kw)
        self.classifier_out_proj = nn.Linear(d, config.num_labels, **kw)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        hidden = self.encoder(input_ids, attention_mask)[-1]
        x = torch.tanh(self.classifier_dense(hidden[:, 0]))
        logits = self.classifier_out_proj(x)
        if self.config.num_labels == 1:
            return torch.sigmoid(logits[:, 0])
        return logits


# ---------------------------------------------------------------------------
# HF state-dict conversion
# ---------------------------------------------------------------------------


def convert_encoder(sd: Mapping[str, torch.Tensor], cfg: EncoderConfig) -> dict[str, torch.Tensor]:
    """HF BertModel / RobertaModel / MPNetModel (optionally
    *ForSequenceClassification) state dict -> the state dict of
    :class:`TextEncoder`, or of :class:`CrossEncoderModel` when
    ``cfg.num_labels`` > 0. HF's Linear weights are (out, in), as the port's."""
    # *ForSequenceClassification prefixes the body with the model type
    prefix = ""
    for p in (f"{cfg.model_type}.", "bert.", "roberta.", "mpnet.", ""):
        if f"{p}embeddings.word_embeddings.weight" in sd:
            prefix = p
            break

    out: dict[str, torch.Tensor] = {}

    def copy(ours: str, theirs: str, bias: bool = True) -> None:
        out[f"{ours}.weight"] = sd[f"{theirs}.weight"]
        if bias:
            out[f"{ours}.bias"] = sd[f"{theirs}.bias"]

    copy("word_embeddings", f"{prefix}embeddings.word_embeddings", bias=False)
    copy("position_embeddings", f"{prefix}embeddings.position_embeddings", bias=False)
    copy("embeddings_layer_norm", f"{prefix}embeddings.LayerNorm")
    if cfg.model_type in ("bert", "roberta"):
        copy("token_type_embeddings", f"{prefix}embeddings.token_type_embeddings", bias=False)
    if cfg.model_type == "mpnet":
        copy("relative_attention_bias", f"{prefix}encoder.relative_attention_bias", bias=False)
    for i in range(cfg.num_hidden_layers):
        base, ours = f"{prefix}encoder.layer.{i}", f"layers.{i}"
        if cfg.model_type == "mpnet":
            for name, hf in (("query", "q"), ("key", "k"), ("value", "v"), ("dense", "o")):
                copy(f"{ours}.attention.{name}", f"{base}.attention.attn.{hf}")
            copy(f"{ours}.attention_layer_norm", f"{base}.attention.LayerNorm")
        else:
            for name in ("query", "key", "value"):
                copy(f"{ours}.attention.{name}", f"{base}.attention.self.{name}")
            copy(f"{ours}.attention.dense", f"{base}.attention.output.dense")
            copy(f"{ours}.attention_layer_norm", f"{base}.attention.output.LayerNorm")
        copy(f"{ours}.intermediate", f"{base}.intermediate.dense")
        copy(f"{ours}.output", f"{base}.output.dense")
        copy(f"{ours}.output_layer_norm", f"{base}.output.LayerNorm")

    if cfg.num_labels > 0:  # cross-encoder: the body nests under "encoder"
        out = {f"encoder.{k}": v for k, v in out.items()}
        copy("classifier_dense", "classifier.dense")
        copy("classifier_out_proj", "classifier.out_proj")
    return out


# ---------------------------------------------------------------------------
# High-level sentence encoder (tokenizer + batching + pooling)
# ---------------------------------------------------------------------------


class SentenceEncoder:
    """Local-checkpoint sentence encoder: the replacement for
    sentence-transformers' bi-encoder and cross-encoder and BERTScore's
    embedding model. ``path`` is an HF ``save_pretrained`` dir (safetensors);
    the model runs on ``device`` (the card by default) in ``dtype``."""

    def __init__(self, path: str, *, cross_encoder: bool = False, dtype=torch.float32, device="cuda"):
        from ..models.auto import load_tokenizer
        from ..models.safetensors_io import SafetensorsDirectory

        # sentence-transformers layouts keep config.json at the root; plain HF too
        with open(os.path.join(path, "config.json")) as f:
            hf = json.load(f)
        num_labels = 0
        if cross_encoder:
            num_labels = len(hf.get("id2label", {})) or 1
        config = encoder_config_from_hf(hf, num_labels=num_labels)
        with SafetensorsDirectory(path) as src:
            tensors = {name: src.get_tensor(name) for name in src.keys()}
        self._setup(config, convert_encoder(tensors, config), load_tokenizer(path), dtype, device)

    @classmethod
    def _from_parts(cls, config: EncoderConfig, state_dict: Mapping[str, torch.Tensor], tokenizer, *,
                    dtype=torch.float32, device="cuda") -> "SentenceEncoder":
        """An encoder from its config, a state dict of :class:`TextEncoder` (or
        :class:`CrossEncoderModel` when ``config.num_labels`` > 0) and a
        tokenizer, without a checkpoint directory."""
        self = cls.__new__(cls)
        self._setup(config, state_dict, tokenizer, dtype, device)
        return self

    def _setup(self, config: EncoderConfig, state_dict: Mapping[str, torch.Tensor], tokenizer, dtype,
               device) -> None:
        self.config = config
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        cls = CrossEncoderModel if config.num_labels > 0 else TextEncoder
        module = cls(config, device="meta")
        module.load_state_dict({k: v.to(self.device) for k, v in state_dict.items()}, strict=True, assign=True)
        if dtype is not None:
            module = module.to(dtype)
        self.module = module.eval().requires_grad_(False)

    def _apply_fn(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """One forward (hidden states or classification scores) -> numpy."""
        with torch.inference_mode():
            out = self.module(torch.as_tensor(ids, device=self.device), torch.as_tensor(mask, device=self.device))
        return out.float().cpu().numpy()

    def _tokenize(self, texts: Sequence[str], pair: Optional[Sequence[str]] = None):
        enc = self.tokenizer(
            list(texts),
            text_pair=list(pair) if pair is not None else None,
            padding=True,
            truncation=True,
            max_length=min(self.config.max_position_embeddings - 2, 384),
            return_tensors="np",
        )
        return enc["input_ids"], enc["attention_mask"]

    def hidden_states(self, texts: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """(num_layers+1, B, S, D) hidden states + (B, S) mask."""
        ids, mask = self._tokenize(texts)
        return self._apply_fn(ids, mask), mask

    def encode(self, texts: Sequence[str], batch_size: int = 32) -> np.ndarray:
        """Mean-pooled L2-normalized sentence embeddings (the all-mpnet-base-v2
        pipeline: Transformer -> mean Pooling -> Normalize)."""
        out = []
        for i in range(0, len(texts), batch_size):
            hiddens, mask = self.hidden_states(texts[i : i + batch_size])
            last = hiddens[-1]
            m = mask[:, :, None].astype(np.float32)
            emb = (last * m).sum(1) / np.maximum(m.sum(1), 1e-9)
            emb = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
            out.append(emb)
        return np.concatenate(out, axis=0)

    def predict_pairs(self, pairs: Sequence[tuple[str, str]], batch_size: int = 32) -> np.ndarray:
        """Cross-encoder scores for (a, b) pairs (sigmoid for 1 label)."""
        out = []
        for i in range(0, len(pairs), batch_size):
            chunk = pairs[i : i + batch_size]
            ids, mask = self._tokenize([a for a, _ in chunk], [b for _, b in chunk])
            out.append(self._apply_fn(ids, mask))
        return np.concatenate(out, axis=0)


# ---------------------------------------------------------------------------
# native BERTScore (greedy matching; torchmetrics/bert_score semantics)
# ---------------------------------------------------------------------------

# Known best layers (bert_score's model2layer table, the torchmetrics default)
_BERTSCORE_LAYER = {"roberta-large": 17, "bert-base-uncased": 9, "roberta-base": 10}


def bertscore_native(
    predictions: Sequence[str],
    references: Sequence[str],
    encoder: SentenceEncoder,
    *,
    num_layers: Optional[int] = None,
    baseline: Optional[float] = None,
    batch_size: int = 32,
) -> np.ndarray:
    """Per-pair BERTScore F1 via greedy cosine matching of layer-``num_layers``
    token embeddings (special tokens zero-weighted, like bert_score with
    idf=False). ``baseline`` applies bert_score's rescale_with_baseline:
    (f1 - b) / (1 - b); pass the model's published baseline value."""
    f1s = []
    for i in range(0, len(predictions), batch_size):
        p_chunk = list(predictions[i : i + batch_size])
        r_chunk = list(references[i : i + batch_size])
        ph, pm = encoder.hidden_states(p_chunk)
        rh, rm = encoder.hidden_states(r_chunk)
        layer = num_layers if num_layers is not None else ph.shape[0] - 1
        pe, re_ = ph[layer], rh[layer]
        pe = pe / np.maximum(np.linalg.norm(pe, axis=-1, keepdims=True), 1e-12)
        re_ = re_ / np.maximum(np.linalg.norm(re_, axis=-1, keepdims=True), 1e-12)
        # zero weight for special tokens ([CLS]/[SEP]/<s>/</s>) and padding
        pw = _content_weights(encoder, p_chunk, pm)
        rw = _content_weights(encoder, r_chunk, rm)
        sim = np.einsum("bsd,bld->bsl", pe, re_)
        sim = np.where(pm[:, :, None].astype(bool) & rm[:, None, :].astype(bool), sim, -1e9)
        precision = (sim.max(axis=2) * pw).sum(1) / np.maximum(pw.sum(1), 1e-9)
        recall = (sim.max(axis=1) * rw).sum(1) / np.maximum(rw.sum(1), 1e-9)
        f1 = 2 * precision * recall / np.maximum(precision + recall, 1e-9)
        f1s.append(f1)
    out = np.concatenate(f1s, axis=0)
    if baseline is not None:
        out = (out - baseline) / (1.0 - baseline)
    return out


def _content_weights(encoder: SentenceEncoder, texts: Sequence[str], mask: np.ndarray) -> np.ndarray:
    ids, _ = encoder._tokenize(texts)
    special = np.zeros_like(ids, bool)
    for tid in encoder.tokenizer.all_special_ids:
        special |= ids == tid
    return (mask.astype(bool) & ~special).astype(np.float32)
