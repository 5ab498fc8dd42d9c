"""Greedy decoding for decoder-only VideoBLIP (counterpart of
``eilev_tpu/generation/decoding.py``).

The OPT greedy branch of :func:`generate`. Prefill writes the prompt into
the stacked KV cache (kernel K2 runs there for OPT, K5 for a long LLaMA
prompt), then a Python loop decodes one token per step with early exit once
every row has emitted eos; positions after eos hold pad. Precomputed
``video_features`` (``serving.VideoFeatureCache``) and ``vision_chunks > 1``
are taken as in JAX. Every other mode of the JAX ``generate`` raises
``NotImplementedError`` naming the mode.

:func:`_prefill` and :func:`_greedy_sample_decoder_only` work by duck typing
on any model with the VideoBLIP LM surface (``config.text_config``,
``lm_embed``, ``lm_forward``): VideoBLIP, and ``generation/text_lm``'s
text-only module over OPT or LLaMA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..configs import OPTConfig, VideoBlipConfig
from ..models.opt import init_cache
from ..models.video_blip import VideoBlipForConditionalGeneration as VB
from ..models.video_blip import embed_and_scatter_chunked
from .config import GenerationConfig


def _is_eos(tokens: torch.Tensor, cfg: GenerationConfig) -> torch.Tensor:
    hit = torch.zeros_like(tokens, dtype=torch.bool)
    for e in cfg.eos_token_id or ():
        hit |= tokens == e
    return hit


def _resolve_lengths(gen_cfg: GenerationConfig, start_len: int) -> GenerationConfig:
    """Translate HF total-length knobs (``min_length``/``max_length``) into
    new-token counts; ``start_len`` is the inputs_embeds length, as in HF's
    decoder-only inputs_embeds path."""
    changes: dict = {}
    if gen_cfg.max_length is not None:
        if int(gen_cfg.max_length) <= start_len:
            raise ValueError(
                f"max_length ({gen_cfg.max_length}) must exceed the prompt "
                f"length ({start_len}); set max_new_tokens instead to budget "
                "new tokens directly"
            )
        changes["max_new_tokens"] = int(gen_cfg.max_length) - start_len
        changes["max_length"] = None
    if gen_cfg.min_length > 0:
        changes["min_new_tokens"] = max(
            gen_cfg.min_new_tokens, int(gen_cfg.min_length) - start_len
        )
        changes["min_length"] = 0
    return dataclasses.replace(gen_cfg, **changes) if changes else gen_cfg


def _validate_num_return_sequences(gen_cfg: GenerationConfig) -> None:
    """HF contract: greedy returns exactly one sequence; beam search can
    return at most num_beams."""
    nrs = gen_cfg.num_return_sequences
    if nrs < 1:
        raise ValueError(f"num_return_sequences must be >= 1, got {nrs}")
    if nrs == 1:
        return
    if gen_cfg.num_beams > 1:
        if nrs > gen_cfg.num_beams:
            raise ValueError(
                "num_return_sequences has to be smaller or equal to num_beams "
                f"(got num_return_sequences={nrs}, num_beams={gen_cfg.num_beams})"
            )
    elif not gen_cfg.do_sample:
        raise ValueError(
            "num_return_sequences > 1 requires do_sample=True or num_beams > 1 "
            "(greedy search is deterministic and returns one sequence, as in HF)"
        )


def _prefill(model: nn.Module, inputs_embeds, attention_mask, max_new_tokens: int):
    b, s, _ = inputs_embeds.shape
    cache = init_cache(
        model.config.text_config, b, s + max_new_tokens,
        dtype=inputs_embeds.dtype, device=inputs_embeds.device,
    )
    logits, cache = model.lm_forward(inputs_embeds, attention_mask=attention_mask, cache=cache)
    return logits[:, -1], cache


def _greedy_sample_decoder_only(
    model: nn.Module,
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor,
    gen_cfg: GenerationConfig,
) -> torch.Tensor:
    """Prefill, then greedy decode with early exit once every row has emitted
    eos. Returns (B, max_new_tokens) int64 tokens; positions after eos hold pad.

    Same tokens as the JAX while-loop; the loop here also skips the model step
    whose logits would go unused (after the last token, or once all finished).
    """
    b = inputs_embeds.shape[0]
    max_new = gen_cfg.max_new_tokens
    device = inputs_embeds.device
    logits, cache = _prefill(model, inputs_embeds, attention_mask, max_new)
    out = torch.full((b, max_new), gen_cfg.pad_token_id, dtype=torch.int64, device=device)
    finished = torch.zeros(b, dtype=torch.bool, device=device)
    step_mask = torch.ones(b, 1, dtype=torch.int32, device=device)
    for step in range(max_new):
        tok = torch.argmax(logits, dim=-1)
        tok = torch.where(finished, gen_cfg.pad_token_id, tok)
        finished = finished | _is_eos(tok, gen_cfg)
        out[:, step] = tok
        if step == max_new - 1 or bool(finished.all()):
            break
        embeds = model.lm_embed(tok[:, None])
        next_logits, cache = model.lm_forward(embeds, attention_mask=step_mask, cache=cache)
        logits = next_logits[:, -1]
    return out


@torch.inference_mode()
def generate(
    model: VB,
    *,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    pixel_values: Optional[torch.Tensor] = None,
    video_input_mask: Optional[torch.Tensor] = None,
    generation_config: GenerationConfig = GenerationConfig(),
    vision_chunks: int = 1,
    draft_layers: Optional[int] = None,
    draft: Optional[str] = None,
    video_features: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Greedy ``generate`` for OPT-backed VideoBLIP: encode the videos, scatter
    them into the prompt embeddings, decode.

    Returns (B, max_new_tokens) generated token ids (new tokens only; pad after
    eos). ``video_features`` (precomputed ``encode_videos`` output,
    (num_videos * num_query_tokens, text_hidden)) skips the vision tower and
    takes precedence over ``pixel_values``; ``vision_chunks > 1`` runs the
    vision tower over that many sequential pieces of the videos. Sampling,
    beam search, contrastive search, logits processors and speculative
    drafting (``draft``/``draft_layers``) are not ported yet and raise
    ``NotImplementedError``.
    """
    cfg: VideoBlipConfig = model.config
    if not isinstance(cfg.text_config, OPTConfig):
        raise NotImplementedError(
            f"generate() is ported for OPT text configs only, got {type(cfg.text_config).__name__}"
        )
    gen_cfg = generation_config
    if gen_cfg.eos_token_id is None:
        gen_cfg = gen_cfg.with_eos(cfg.text_config.eos_token_id)
    _validate_num_return_sequences(gen_cfg)
    # HF counts min_length/max_length over prompt + generated; the scattered
    # embeddings are as long as input_ids
    gen_cfg = _resolve_lengths(gen_cfg, start_len=input_ids.shape[1])
    unported = {
        "beam search (num_beams > 1)": gen_cfg.num_beams > 1,
        "sampling (do_sample)": gen_cfg.do_sample,
        "contrastive search (penalty_alpha)": bool(gen_cfg.penalty_alpha)
        and gen_cfg.penalty_alpha > 0
        and gen_cfg.top_k > 1,
        "logits processors": gen_cfg.has_logits_processors,
        "speculative decoding (draft)": draft is not None,
        "speculative decoding (draft_layers)": bool(draft_layers),
    }
    for mode, requested in unported.items():
        if requested:
            raise NotImplementedError(f"{mode} is not ported yet; greedy decoding is")
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    if video_features is not None:
        inputs_embeds = model.embed_and_scatter(
            input_ids, None, video_input_mask, video_features=video_features
        )
    elif vision_chunks > 1 and pixel_values is not None:
        inputs_embeds = embed_and_scatter_chunked(
            model, input_ids, pixel_values, video_input_mask, vision_chunks=vision_chunks
        )
    else:
        inputs_embeds = model.embed_and_scatter(input_ids, pixel_values, video_input_mask)
    return _greedy_sample_decoder_only(model, inputs_embeds, attention_mask, gen_cfg)
