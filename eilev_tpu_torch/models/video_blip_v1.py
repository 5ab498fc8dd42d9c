"""VideoBLIP v1 (counterpart of ``eilev_tpu/models/video_blip_v1.py``): one
video a sample, its features PREPENDED to the text.

The reference's v1 model inherits ``Blip2ForConditionalGeneration``'s
forward and generate of the transformers release it pins: the video's query
tokens go in front of the token embeddings, the attention mask is extended
with ones, and the decoder-only loss is taken over the last
``labels.shape[1]`` logits (a T5 language model takes the v2 module's
seq2seq loss over the same composition). A subclass of the v2 module: the
same towers and weights (a v1 checkpoint loads through
``models/auto.load_model(version="v1")``), only the text/video composition
differs.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs import OPTConfig
from ..ops.dropout import MaskSource
from .video_blip import VideoBlipForConditionalGeneration, masked_cross_entropy


class VideoBlipV1ForConditionalGeneration(VideoBlipForConditionalGeneration):
    def embed_and_scatter(
        self,
        input_ids: torch.Tensor,
        pixel_values: Optional[torch.Tensor],
        video_input_mask: Optional[torch.Tensor] = None,
        video_features: Optional[torch.Tensor] = None,
        dropout_rng: Optional[MaskSource] = None,
    ) -> torch.Tensor:
        """[video features | token embeddings]: (B, Q + S, D). One video a
        sample, ``pixel_values`` (B, C, T, H, W); ``video_features``
        (precomputed :meth:`encode_videos` output, (B * Q, D)) takes the place
        of the vision tower. ``video_input_mask`` is unused (no scatter)."""
        del video_input_mask
        inputs_embeds = self.language_model.embed(input_ids)
        if video_features is None:
            if pixel_values is None:
                return inputs_embeds
            video_features = self.encode_videos(pixel_values, dropout_rng)
        features = video_features.reshape(inputs_embeds.shape[0], self.config.num_query_tokens, -1)
        return torch.cat([features.to(inputs_embeds.dtype), inputs_embeds], dim=1)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        pixel_values: Optional[torch.Tensor] = None,
        video_input_mask: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
        dropout_rng: Optional[MaskSource] = None,
    ) -> dict[str, torch.Tensor]:
        """``{"logits"}`` over [video | text], and ``"loss"`` with ``labels``:
        HF Blip2's, over the last ``labels.shape[1]`` logits, shifted by one
        (for T5 the v2 module's seq2seq loss)."""
        del video_input_mask
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        inputs_embeds = self.embed_and_scatter(input_ids, pixel_values, dropout_rng=dropout_rng)
        if pixel_values is not None:
            prefix = attention_mask.new_ones(input_ids.shape[0], self.config.num_query_tokens)
            attention_mask = torch.cat([prefix, attention_mask], dim=1)
        if not isinstance(self.config.text_config, OPTConfig):
            return self.lm_loss(inputs_embeds, attention_mask, labels, dropout_rng)
        logits, _ = self.language_model(inputs_embeds, attention_mask=attention_mask, rng=dropout_rng)
        out = {"logits": logits}
        if labels is not None:
            window = logits[:, -labels.shape[1]:]
            out["loss"] = masked_cross_entropy(window[:, :-1], labels[:, 1:])
        return out
