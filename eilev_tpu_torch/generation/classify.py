"""Log-likelihood N-way classification with prompt KV-cache reuse (counterpart
of ``eilev_tpu/generation/classify.py``).

The (left-padded) few-shot prompt runs once into a fresh KV cache (the OPT
prefill, kernel K2 on the card; the vision tower, K1, unless precomputed
``video_features`` are given), then every class continuation is scored
against that shared cache through ``OPTForCausalLM.score_with_prefix``: the
cache is never copied per class, and ``class_batch_size`` only bounds the
(B, C, H, L, P) score tile. Returns the per-class mean log-likelihood.

A seq2seq (T5) model encodes the prompt once and scores the classes'
decoder continuations (the class ids shifted right) against the SHARED
encoder states through ``T5ForConditionalGeneration.score_classes``: the
encoder states are never copied per class, and ``class_batch_size`` bounds
the class chunk.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.opt import init_cache
from ..models.video_blip import shift_tokens_right


def _prefill_prompt(
    model, input_ids, attention_mask, pixel_values, video_input_mask, video_features=None
):
    """The prompt into a fresh cache of its own length. Returns the logits of
    its last position and the cache."""
    inputs_embeds = model.embed_and_scatter(
        input_ids, pixel_values, video_input_mask, video_features=video_features
    )
    b, s, _ = inputs_embeds.shape
    cache = init_cache(
        model.config.text_config, b, s, dtype=inputs_embeds.dtype, device=inputs_embeds.device
    )
    logits, cache = model.lm_forward(inputs_embeds, attention_mask=attention_mask, cache=cache)
    return logits[:, -1], cache


def _encode_prompt_seq2seq(model, input_ids, attention_mask, pixel_values, video_input_mask, video_features=None):
    inputs_embeds = model.embed_and_scatter(input_ids, pixel_values, video_input_mask, video_features=video_features)
    return model.t5_encode(inputs_embeds, attention_mask)


def _score_classes_seq2seq(model, class_input_ids, class_attention_mask, encoder_hidden, encoder_mask):
    """Score (C, L) class label sequences against the shared encoder states.
    Returns the (B, C) mean log-likelihood."""
    tcfg = model.config.text_config
    dec_in = shift_tokens_right(class_input_ids, tcfg.pad_token_id, tcfg.decoder_start_token_id)
    logits = model.t5_score_classes(dec_in, class_attention_mask, encoder_hidden, encoder_mask)  # (B, C, L, V)
    return _mean_log_likelihood(logits, class_input_ids, class_attention_mask)


def _mean_log_likelihood(logits, class_input_ids, class_attention_mask):
    """(B, C, L, V) logits of the class tokens -> the (B, C) mean
    log-likelihood over each class's unmasked tokens."""
    b = logits.shape[0]
    c, l = class_input_ids.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    index = class_input_ids[None, :, :, None].expand(b, c, l, 1).long()
    token_ll = torch.gather(logp, -1, index)[..., 0]
    token_ll = token_ll * class_attention_mask[None].float()
    lengths = class_attention_mask.sum(dim=-1)[None].clamp(min=1)
    return token_ll.sum(dim=-1) / lengths  # (B, C)


def _score_classes(model, class_input_ids, class_attention_mask, last_logits, cache):
    """class_input_ids: (C, L). Returns the (B, C) mean log-likelihood."""
    b = last_logits.shape[0]
    c, l = class_input_ids.shape
    class_embeds = model.lm_embed(class_input_ids)  # (C, L, D)
    class_embeds = class_embeds[None].expand(b, c, l, class_embeds.shape[-1])
    cls_mask = class_attention_mask[None].expand(b, c, l)
    logits = model.lm_score_with_prefix(class_embeds, cls_mask, cache)

    # shift: token 0 is predicted by the prompt's last logits, token t by the
    # class logits at t - 1
    shift_logits = torch.cat(
        [last_logits[:, None, None].expand(b, c, 1, logits.shape[-1]), logits[:, :, :-1]], dim=2
    )
    return _mean_log_likelihood(shift_logits, class_input_ids, class_attention_mask)


@torch.inference_mode()
def classify(
    model,
    *,
    prompt_input_ids: torch.Tensor,
    class_input_ids: torch.Tensor,
    prompt_attention_mask: Optional[torch.Tensor] = None,
    pixel_values: Optional[torch.Tensor] = None,
    prompt_video_input_mask: Optional[torch.Tensor] = None,
    class_attention_mask: Optional[torch.Tensor] = None,
    class_batch_size: Optional[int] = None,
    video_features: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean log-likelihood of each class continuation given the prompt.

    Prompts must be LEFT-padded. ``video_features`` (precomputed
    ``encode_videos`` output, (num_videos * num_query_tokens, text_hidden))
    skips the vision tower: the two-stage ICL eval scores the same videos
    twice per datapoint. Returns (batch, num_classes) float32.
    """
    if prompt_attention_mask is None:
        prompt_attention_mask = torch.ones_like(prompt_input_ids)
    if class_attention_mask is None:
        class_attention_mask = torch.ones_like(class_input_ids)
    pixel_values = None if video_features is not None else pixel_values
    num_classes = class_input_ids.shape[0]
    step = class_batch_size if class_batch_size else num_classes

    if not model.config.use_decoder_only_language_model:
        # seq2seq: one encoder pass, the classes attend the shared encoder states
        encoder_hidden = _encode_prompt_seq2seq(
            model, prompt_input_ids, prompt_attention_mask, pixel_values, prompt_video_input_mask, video_features)
        chunks = [
            _score_classes_seq2seq(
                model, class_input_ids[i : i + step], class_attention_mask[i : i + step],
                encoder_hidden, prompt_attention_mask,
            )
            for i in range(0, num_classes, step)
        ]
        return chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=1)

    last_logits, cache = _prefill_prompt(
        model, prompt_input_ids, prompt_attention_mask, pixel_values, prompt_video_input_mask, video_features,
    )
    chunks = [
        _score_classes(
            model,
            class_input_ids[i : i + step],
            class_attention_mask[i : i + step],
            last_logits,
            cache,
        )
        for i in range(0, num_classes, step)
    ]
    return chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=1)
