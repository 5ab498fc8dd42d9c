"""VideoBLIP / EILeV top-level model (counterpart of ``eilev_tpu/models/video_blip.py``).

Time-flattened vision tower -> Q-Former over T*S image tokens -> linear
projection -> video features scattered into the token embeddings at the
positions flagged by ``video_input_mask`` -> OPT (causal) or T5 (seq2seq,
``models/t5.py``).

The training forward (``forward`` with ``labels``) returns ``{"logits",
"loss"}``: for OPT the loss is HF's causal-LM cross entropy
(:func:`masked_cross_entropy` of the logits shifted by one); for T5 the
decoder inputs are the labels shifted right (:func:`shift_tokens_right`,
-100 -> pad) unless given, and the loss is the unshifted cross entropy. Dropout is active in training mode when a mask
source ``dropout_rng`` is given (``ops/dropout.py``). The vision tower runs
without a graph when none of its parameters requires grad (the recipe
freezes it), so its attention kernel K1, which has no backward, never sees a
tensor that requires grad; the features that do require grad keep their
graph through the scatter into the embeddings.

Mixed precision as flax has it: ``dtype`` is the compute dtype;
``param_dtype`` (default: ``dtype``) is that of the frozen towers' weights,
and ``trainable_dtype`` (default: ``param_dtype``) that of the trainable
subtree, the query tokens, Q-Former and language projection. Every layer
computes in ``dtype`` whatever its weights' dtype: fp32 master weights
inside a bf16 model, as the training recipe keeps them, or fp32 weights
everywhere under a bf16 compute, as the CLIs load a checkpoint
(``models/auto.py:load_model``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs import OPTConfig, VideoBlipConfig
from ..ops.dropout import MaskSource
from .mixed_precision import MixedLinear
from .opt import Cache, OPTForCausalLM
from .qformer import QFormerModel
from .t5 import T5ForConditionalGeneration
from .vision import VideoVisionModel


def scatter_video_features(
    inputs_embeds: torch.Tensor, video_input_mask: torch.Tensor, video_features: torch.Tensor
) -> torch.Tensor:
    """Place video_features (N, D) at the True positions of video_input_mask (B, S)
    over inputs_embeds (B, S, D), row-major: torch's ``embeds[mask] = feats``,
    out of place. N must equal the number of True positions."""
    b, s, d = inputs_embeds.shape
    out = inputs_embeds.reshape(b * s, d).clone()
    out[video_input_mask.reshape(-1).bool()] = video_features.to(out.dtype)
    return out.reshape(b, s, d)


class VideoBlipForConditionalGeneration(nn.Module):
    """The narration entry point. It builds on the card unless the caller
    passes ``device="cpu"``; its submodules keep PyTorch's ``device=None``."""

    def __init__(self, config: VideoBlipConfig, *, device="cuda", dtype=None, param_dtype=None,
                 trainable_dtype=None):
        super().__init__()
        self.config = config
        # a compute dtype of its own only where the weights differ from it;
        # otherwise the towers follow their weights' dtype (so a .double() or
        # .to(dtype) of the model moves the compute with them)
        compute = None if param_dtype in (None, dtype) else (dtype or torch.get_default_dtype())
        param_dtype = param_dtype or dtype
        kw = {"device": device, "dtype": param_dtype}
        train_kw = {"device": device, "dtype": trainable_dtype or param_dtype}
        self.vision_model = VideoVisionModel(config.vision_config, compute_dtype=compute, **kw)
        self.query_tokens = nn.Parameter(
            torch.zeros(config.num_query_tokens, config.qformer_config.hidden_size, **train_kw)
        )
        self.qformer = QFormerModel(config.qformer_config, **train_kw)
        self.language_projection = MixedLinear(
            config.qformer_config.hidden_size, config.text_hidden_size, **train_kw
        )
        lm_cls = OPTForCausalLM if isinstance(config.text_config, OPTConfig) else T5ForConditionalGeneration
        self.language_model = lm_cls(config.text_config, compute_dtype=compute, **kw)

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype every tower computes in."""
        lm = self.language_model
        table = lm.embed_tokens if isinstance(lm, OPTForCausalLM) else lm.shared
        return lm.compute_dtype or table.weight.dtype

    def encode_videos(
        self, pixel_values: torch.Tensor, dropout_rng: Optional[MaskSource] = None
    ) -> torch.Tensor:
        """(num_videos, C, T, H, W) -> (num_videos * num_query_tokens, text_hidden),
        in the compute dtype."""
        frozen = not any(p.requires_grad for p in self.vision_model.parameters())
        with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen):
            image_embeds, _ = self.vision_model(pixel_values)  # (V, T*S, vision_hidden)
        v = image_embeds.shape[0]
        query = self.query_tokens.to(image_embeds.dtype).expand(v, *self.query_tokens.shape)
        features = self.language_projection(self.qformer(query, image_embeds, rng=dropout_rng))
        return features.reshape(v * self.config.num_query_tokens, -1)

    def vision_forward(self, pixel_values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The raw video vision outputs, (last_hidden (V, T*S, D), pooled (V,
        T, D)), as the original's VideoBlipVisionModel.forward gives them; its
        ViT runs K1."""
        return self.vision_model(pixel_values)

    def embed_and_scatter(
        self,
        input_ids: torch.Tensor,
        pixel_values: Optional[torch.Tensor],
        video_input_mask: Optional[torch.Tensor],
        video_features: Optional[torch.Tensor] = None,
        dropout_rng: Optional[MaskSource] = None,
    ) -> torch.Tensor:
        """Token embeddings with video features scattered at the mask positions.

        ``video_features`` (precomputed :meth:`encode_videos` output, (num_videos
        * num_query_tokens, text_hidden), e.g. from ``serving.VideoFeatureCache``)
        takes the place of the vision tower and takes precedence over
        ``pixel_values``."""
        inputs_embeds = self.language_model.embed(input_ids)
        if video_features is None and pixel_values is None:
            return inputs_embeds
        if video_input_mask is None:
            raise ValueError("video features need a video_input_mask")
        if video_features is None:
            video_features = self.encode_videos(pixel_values, dropout_rng)
        return scatter_video_features(inputs_embeds, video_input_mask, video_features)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        pixel_values: Optional[torch.Tensor] = None,
        video_input_mask: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
        dropout_rng: Optional[MaskSource] = None,
        decoder_input_ids: Optional[torch.Tensor] = None,
        decoder_attention_mask: Optional[torch.Tensor] = None,
    ) -> dict[str, torch.Tensor]:
        """The training / scoring forward: ``{"logits"}``, and ``"loss"`` with
        ``labels`` (the mean over labels != -100; HF's shift by one for OPT,
        the decoder's own positions for T5, whose ``decoder_input_ids``
        default to the labels shifted right). In training mode with dropout
        rates above 0 it needs ``dropout_rng``, as the JAX module needs a
        dropout key when ``deterministic=False``."""
        if self.training and dropout_rng is None and self._has_dropout():
            raise ValueError(
                "a training-mode forward draws dropout masks: pass dropout_rng "
                "(ops.dropout.DropoutRng), or call .eval()"
            )
        inputs_embeds = self.embed_and_scatter(
            input_ids, pixel_values, video_input_mask, dropout_rng=dropout_rng
        )
        return self.lm_loss(inputs_embeds, attention_mask, labels, dropout_rng, decoder_input_ids,
                            decoder_attention_mask)

    def lm_loss(
        self,
        inputs_embeds: torch.Tensor,
        attention_mask: Optional[torch.Tensor],
        labels: Optional[torch.Tensor],
        dropout_rng: Optional[MaskSource] = None,
        decoder_input_ids: Optional[torch.Tensor] = None,
        decoder_attention_mask: Optional[torch.Tensor] = None,
    ) -> dict[str, torch.Tensor]:
        """The language model's half of :meth:`forward` over ready embeddings."""
        tcfg = self.config.text_config
        if isinstance(tcfg, OPTConfig):
            logits, _ = self.language_model(inputs_embeds, attention_mask=attention_mask, rng=dropout_rng)
            out = {"logits": logits}
            if labels is not None:
                out["loss"] = masked_cross_entropy(logits[:, :-1], labels[:, 1:])
            return out
        if decoder_input_ids is None and labels is not None:
            decoder_input_ids = shift_tokens_right(labels, tcfg.pad_token_id, tcfg.decoder_start_token_id)
        logits = self.language_model(
            inputs_embeds, attention_mask, decoder_input_ids, decoder_attention_mask, rng=dropout_rng)
        out = {"logits": logits}
        if labels is not None:
            out["loss"] = masked_cross_entropy(logits, labels)
        return out

    def _has_dropout(self) -> bool:
        q, t = self.config.qformer_config, self.config.text_config
        lm_rate = t.dropout if isinstance(t, OPTConfig) else t.dropout_rate
        return bool(q.hidden_dropout_prob or q.attention_probs_dropout_prob or lm_rate)

    def lm_embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.language_model.embed(input_ids)

    def lm_forward(
        self,
        inputs_embeds: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        cache: Optional[Cache] = None,
        cache_append: bool = False,
    ) -> tuple[torch.Tensor, Optional[Cache]]:
        return self.language_model(
            inputs_embeds, attention_mask=attention_mask, cache=cache, cache_append=cache_append
        )

    def lm_forward_hidden(
        self,
        inputs_embeds: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        cache: Optional[Cache] = None,
    ) -> tuple[torch.Tensor, torch.Tensor, Optional[Cache]]:
        """``lm_forward`` that also returns HF's ``hidden_states[-1]``: (logits,
        hidden, cache), the context vectors contrastive search penalises."""
        return self.language_model(
            inputs_embeds, attention_mask=attention_mask, cache=cache, with_hidden=True
        )

    def lm_candidates(self, cand_embeds: torch.Tensor, cache: Cache) -> tuple[torch.Tensor, torch.Tensor]:
        """Contrastive search's candidate expansion: (B, k) one-token
        candidates, all at the same next position, over the shared read-only
        cache (nothing duplicated or written): ``score_with_prefix`` with C =
        k, L = 1. Returns (logits (B, k, V), hidden (B, k, D))."""
        b, k, _ = cand_embeds.shape
        ones = torch.ones(b, k, 1, dtype=torch.int32, device=cand_embeds.device)
        logits, hidden = self.language_model.score_with_prefix(
            cand_embeds[:, :, None, :], ones, cache, return_hidden=True
        )
        return logits[:, :, 0], hidden[:, :, 0]

    def lm_score_with_prefix(
        self, class_embeds: torch.Tensor, class_attention_mask: torch.Tensor, cache: Cache
    ) -> torch.Tensor:
        return self.language_model.score_with_prefix(class_embeds, class_attention_mask, cache)

    def t5_encode(self, inputs_embeds: torch.Tensor, attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        return self.language_model.encode(inputs_embeds, attention_mask)

    def t5_decode_step(self, decoder_input_ids, encoder_hidden, encoder_attention_mask, cache):
        return self.language_model.decode_step(decoder_input_ids, encoder_hidden, encoder_attention_mask, cache)

    def t5_decode_append(self, decoder_input_ids, encoder_attention_mask, cache, active):
        return self.language_model.decode_append(decoder_input_ids, encoder_attention_mask, cache, active)

    def t5_score_classes(self, class_decoder_ids, class_attention_mask, encoder_hidden, encoder_attention_mask):
        return self.language_model.score_classes(
            class_decoder_ids, class_attention_mask, encoder_hidden, encoder_attention_mask)


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over the positions where labels != -100 (HF's
    convention), log_softmax in fp32."""
    valid = labels != -100
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    token_ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    token_loss = -torch.where(valid, token_ll, torch.zeros_like(token_ll))
    return token_loss.sum() / valid.sum().clamp(min=1)


def shift_tokens_right(labels: torch.Tensor, pad_token_id: int, decoder_start_token_id: int) -> torch.Tensor:
    """T5's decoder inputs (HF ``_shift_right``): the start token prepended,
    the last label dropped, -100 replaced by pad."""
    shifted = torch.roll(labels, 1, dims=-1)
    shifted[:, 0] = decoder_start_token_id
    return torch.where(shifted == -100, pad_token_id, shifted)


def embed_and_scatter_chunked(
    model: VideoBlipForConditionalGeneration,
    input_ids: torch.Tensor,
    pixel_values: torch.Tensor,
    video_input_mask: torch.Tensor,
    *,
    vision_chunks: int = 1,
) -> torch.Tensor:
    """``embed_and_scatter`` with the vision tower and Q-Former run over
    ``vision_chunks`` sequential pieces of the videos, so the activation peak
    is that of one piece. Each video's features are independent of its
    batch-mates, so the result is the monolithic one up to the products'
    batch-size-dependent summation order."""
    if vision_chunks <= 1:
        return model.embed_and_scatter(input_ids, pixel_values, video_input_mask)
    v = pixel_values.shape[0]
    if v % vision_chunks != 0:
        raise ValueError(
            f"vision_chunks={vision_chunks} must divide the number of videos "
            f"in the batch ({v}); pick a divisor of the video count"
        )
    feats = torch.cat([model.encode_videos(px) for px in pixel_values.chunk(vision_chunks)])
    return scatter_video_features(model.lm_embed(input_ids), video_input_mask, feats)

