"""Generation for VideoBLIP-OPT and VideoBLIP-T5 (counterpart of
``eilev_tpu/generation/decoding.py``).

The OPT branch of :func:`generate`: greedy, sampling (with
``num_return_sequences``), the HF logits processors and warpers
(``generation/logits.py``), the beam engine (beam, beam_sample and group
beam search), contrastive search (``penalty_alpha``), and speculative
decoding (``draft_layers``: the target's first layers draft;
``draft="prompt_lookup"``: model-free drafts, greedy and sampling;
``generation/speculative.py``). Prefill writes the prompt into the stacked
KV cache (kernel K2 runs there for OPT, K5 for a long LLaMA prompt), then a
Python loop decodes one token per step (K3 over a model-dtype cache, K4 over
an int8 one), with early exit once every row (or every beam group) is done.
:func:`generate_stream` yields the greedy or sampled tokens in chunks.
Precomputed ``video_features`` (``serving.VideoFeatureCache``) and
``vision_chunks > 1`` are taken as in JAX.

The T5 branch: the prompt is encoded once (``t5_encode``; its attention
through the dispatcher, so K5 with the relative bias under ``flash``),
``init_decode_cache`` projects every decoder layer's cross K/V once, and the
decoder steps from ``decoder_start_token_id``: greedy and sampling (with
``num_return_sequences``, the cache tiled after one encode) or the beam
engine, whose reorder gathers the cross K/V with the self K/V. Its outputs
start with the start token, as HF's. Contrastive search, speculative
decoding and streaming are decoder-only, as in JAX.

The JAX loops are one compiled ``while_loop`` each; here the host drives
them, with one ``bool(....all())`` read a step for the early exit and no
other device read inside a step. Beam search keeps JAX's host-visible
semantics: the cache is reordered (gathered along the beam axis) before each
model step, and the step is skipped once every group is done.

Contrastive search runs the k candidates as one ``lm_candidates`` pass over
the shared, read-only cache (``score_with_prefix`` with C = k: plain
einsums, as in JAX), then commits the chosen token through the ordinary
one-token step (K3/K4).

Sampling draws Gumbel noise from a ``torch.Generator`` (the public entry
points take ``generator`` where JAX takes ``rng``, and seed one on the
model's device with 0 when none is given, as JAX defaults to
``PRNGKey(0)``): the output law is JAX's, the stream is not.

:func:`_prefill`, :func:`_greedy_sample_decoder_only` and
:func:`_beam_search_decoder_only` work by duck typing on any model with the
VideoBLIP LM surface (``config.text_config``, ``lm_embed``, ``lm_forward``):
VideoBLIP, and ``generation/text_lm``'s text-only module over OPT or LLaMA.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional

import numpy as np
import torch
from torch import nn

from ..configs import LlamaConfig, OPTConfig, T5Config, VideoBlipConfig
from ..models.opt import init_cache
from ..models.video_blip import VideoBlipForConditionalGeneration as VB
from ..models.video_blip import embed_and_scatter_chunked
from .config import GenerationConfig
from .logits import Noise, _process_scores, _select_token, _token_in_set, _top_k, _warp_logits, gumbel_noise


def _is_eos(tokens: torch.Tensor, cfg: GenerationConfig) -> torch.Tensor:
    return _token_in_set(tokens, tuple(cfg.eos_token_id or ()))


#: cache entries laid out (layers, batch, ...): tiled and gathered along
#: dim 1; ``mask`` and ``pos`` are (batch, ...), along dim 0; ``index`` is a
#: Python int
_CACHE_LAYERS_FIRST = ("k", "v", "k_scale", "v_scale", "cross_k", "cross_v")


def _tile_cache(cache: dict, n: int) -> dict:
    """Repeat every cache row ``n`` times along the batch axis (output row
    ``r*n + i`` is copy ``i`` of input row ``r``): a once-prefilled cache
    expanded across beams or ``num_return_sequences`` sampling copies."""
    if n == 1:
        return cache
    return {
        key: val if key == "index" else val.repeat_interleave(n, dim=1 if key in _CACHE_LAYERS_FIRST else 0)
        for key, val in cache.items()
    }


def _reorder_cache(cache: dict, idx: torch.Tensor) -> dict:
    """JAX's beam ``reorder_fn``: row ``i`` of the new cache is row
    ``idx[i]`` of the old, gathered into new buffers (``index_select``), as
    JAX's ``jnp.take`` does."""
    return {
        key: val if key == "index" else val.index_select(1 if key in _CACHE_LAYERS_FIRST else 0, idx)
        for key, val in cache.items()
    }


def _resolve_lengths(gen_cfg: GenerationConfig, start_len: int) -> GenerationConfig:
    """Translate HF total-length knobs (``min_length``/``max_length``) into
    new-token counts; ``start_len`` is what HF subtracts: the inputs_embeds
    length on the decoder-only inputs_embeds path, 1 (the decoder start
    token) for seq2seq."""
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


def _validate_beam_groups(gen_cfg: GenerationConfig) -> None:
    """HF's group-beam contract: groups divide num_beams; diverse beam search
    cannot be sampled; diversity_penalty needs groups."""
    groups = gen_cfg.num_beam_groups
    if groups < 1:
        raise ValueError(f"num_beam_groups must be >= 1, got {groups}")
    if groups == 1:
        if gen_cfg.diversity_penalty != 0.0:
            raise ValueError(
                "diversity_penalty requires num_beam_groups > 1 (HF: the "
                "Hamming diversity processor is only built for group beam search)"
            )
        return
    if gen_cfg.num_beams < groups or gen_cfg.num_beams % groups != 0:
        raise ValueError(
            "`num_beam_groups` has to be an integer smaller or equal than "
            "`num_beams` and `num_beams` has to be divisible by "
            f"`num_beam_groups`, but is {groups} with `num_beams` being {gen_cfg.num_beams}."
        )
    if gen_cfg.do_sample:
        raise ValueError(
            "Diverse beam search cannot be used in sampling mode. Make sure "
            "that `do_sample` is set to `False`."
        )


def _seeded_generator(generator: Optional[torch.Generator], device: torch.device) -> torch.Generator:
    """``generator``, or a generator on ``device`` seeded with 0 (JAX
    defaults to ``PRNGKey(0)``). A generator on another device than
    ``device`` raises ``ValueError``: each step would draw the noise there
    and copy it over."""
    if generator is None:
        return torch.Generator(device=device).manual_seed(0)
    gen_dev, device = generator.device, torch.device(device)
    if gen_dev.type != device.type or (None not in (gen_dev.index, device.index) and gen_dev.index != device.index):
        raise ValueError(
            f"the generator is on {gen_dev} and the model on {device}: "
            "pass a torch.Generator(device=...) on the model's device"
        )
    return generator


def _seeded_noise(generator: Optional[torch.Generator], device: torch.device) -> Noise:
    """Gumbel noise from :func:`_seeded_generator`'s generator."""
    return gumbel_noise(_seeded_generator(generator, device))


def _prefill(model: nn.Module, inputs_embeds, attention_mask, max_new_tokens: int):
    b, s, _ = inputs_embeds.shape
    cache = init_cache(
        model.config.text_config, b, s + max_new_tokens,
        dtype=inputs_embeds.dtype, device=inputs_embeds.device,
    )
    logits, cache = model.lm_forward(inputs_embeds, attention_mask=attention_mask, cache=cache)
    return logits[:, -1], cache


def _sample_loop(logits: torch.Tensor, step_fn: Callable, gen_cfg: GenerationConfig,
                 noise: Optional[Noise], prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The greedy/sampling loop from the first token's ``logits`` (N, V):
    the logits processors, a greedy or sampled token (``noise`` with
    ``do_sample``), pad after eos, early exit once every row has emitted
    eos. ``step_fn(tokens (N,)) -> logits (N, V)`` runs the model step; the
    loop skips the step whose logits would go unused (after the last token,
    or once all finished). The processors see ``prefix`` (N, P), if given
    (seq2seq's start token), then the generated tokens, as HF's input_ids.
    Returns (N, max_new_tokens) int64 tokens."""
    n, max_new = logits.shape[0], gen_cfg.max_new_tokens
    out = torch.full((n, max_new), gen_cfg.pad_token_id, dtype=torch.int64, device=logits.device)
    finished = torch.zeros(n, dtype=torch.bool, device=logits.device)
    n_prefix = 0 if prefix is None else prefix.shape[1]
    for step in range(max_new):
        if gen_cfg.has_logits_processors:
            history = out if prefix is None else torch.cat([prefix, out], dim=1)
            logits = _process_scores(logits, gen_cfg, history, step + n_prefix, step)
        tok = _select_token(logits, gen_cfg, noise)
        tok = torch.where(finished, gen_cfg.pad_token_id, tok)
        finished = finished | _is_eos(tok, gen_cfg)
        out[:, step] = tok
        if step == max_new - 1 or bool(finished.all()):
            break
        logits = step_fn(tok)
    return out


def _greedy_sample_decoder_only(
    model: nn.Module,
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor,
    gen_cfg: GenerationConfig,
    noise: Optional[Noise] = None,
) -> torch.Tensor:
    """Prefill, then :func:`_sample_loop` over one-token steps. Returns (B *
    nrs, max_new_tokens) int64 tokens; positions after eos hold pad.

    The logits processors see the generated tokens (HF's input_ids: the
    inputs_embeds path starts generate with an empty input_ids). With
    ``do_sample`` each step draws ``noise(warped)`` once (``noise`` is
    required then; :func:`_decode` makes it from a generator);
    ``num_return_sequences > 1`` prefills once, tiles the cache and returns
    rows interleaved (``row*nrs + i``), as JAX. Same tokens as the JAX
    while-loop given the same noise.
    """
    logits, cache = _prefill(model, inputs_embeds, attention_mask, gen_cfg.max_new_tokens)
    nrs = gen_cfg.num_return_sequences if gen_cfg.do_sample else 1
    if nrs > 1:
        cache = _tile_cache(cache, nrs)
        logits = logits.repeat_interleave(nrs, dim=0)
    step_mask = torch.ones(logits.shape[0], 1, dtype=torch.int32, device=logits.device)

    def step_fn(tok):
        next_logits, _ = model.lm_forward(model.lm_embed(tok[:, None]), attention_mask=step_mask, cache=cache)
        return next_logits[:, -1]

    return _sample_loop(logits, step_fn, gen_cfg, noise)


def _pow32(x: int, p: float) -> float:
    """``x ** p`` in fp32, as JAX's ``jnp.power`` of an fp32 length."""
    return float(np.power(np.float32(x), np.float32(p)))


def _beam_engine(
    logprobs0: torch.Tensor,
    cache0: dict,
    step_fn: Callable,
    gen_cfg: GenerationConfig,
    b: int,
    noise: Optional[Noise] = None,
    prefix_ids: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The beam loop (HF BeamSearchScorer.process/finalize semantics, in JAX's
    fixed-shape form: per batch row and group a heap of finished hypotheses,
    kept by a top-k over the union of the heap and this step's eos
    candidates).

    ``step_fn(tokens_flat, cache) -> (logprobs (b*nb, V), cache)`` runs one
    model step, after :func:`_reorder_cache` has gathered the cache along the
    beam axis. With ``gen_cfg.do_sample`` (HF ``beam_sample``) the warpers
    (``min_keep`` 2) run on the beam-score-augmented log-probs, and 2*nb
    candidates are drawn without replacement from the flattened (b, nb*V)
    softmax by Gumbel top-k (one ``noise`` draw a step), then sorted by score.
    Group beam search (``num_beam_groups``, ``diversity_penalty``) runs the
    groups in turn within a step; group g's log-probs are penalised by the
    frequency of each token the groups before it chose this step, pads of
    done groups included (an HF quirk). Every top-k is :func:`_top_k`: ties
    go to the lowest index, which puts existing hypotheses before new ones.
    ``prefix_ids`` (b*nb, P), seq2seq's start token, lead the history the
    logits processors see.

    Returns (hyp_scores (b, nb), hyp_tokens (b, nb, max_new)): finished
    hypotheses sorted best-first, pad-filled after each one's end.
    """
    nb = gen_cfg.num_beams
    groups = max(int(gen_cfg.num_beam_groups), 1)
    ng = nb // groups
    div = float(gen_cfg.diversity_penalty)
    max_new = gen_cfg.max_new_tokens
    lp = float(gen_cfg.length_penalty)
    eos = tuple(gen_cfg.eos_token_id or ())
    pad = gen_cfg.pad_token_id
    device = logprobs0.device
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)

    # the first beam of each group starts live (HF: beam_scores[:, ::ng] = 0)
    beam_scores = torch.full((b, nb), -1e9, **f32)
    beam_scores[:, ::ng] = 0.0
    generated = torch.full((b, nb, max_new), pad, **i64)
    hyp_scores = torch.full((b, groups, ng), -torch.inf, **f32)
    hyp_tokens = torch.full((b, groups, ng, max_new), pad, **i64)
    done = torch.zeros(b, groups, dtype=torch.bool, device=device)
    rank_ok = torch.arange(2 * ng, device=device)[None, :] < ng  # eos admitted from the first ng ranks
    logprobs, cache = logprobs0, cache0

    step = 0
    all_done = False
    while step < max_new and not all_done:
        vocab = logprobs.shape[-1]
        len_pen = _pow32(step + 1, lp)
        counts = torch.zeros(b, vocab, **f32)
        nx_scores, nx_tokens, nx_indices = [], [], []
        new_hyp_scores, new_hyp_tokens, new_done = [], [], []
        for g in range(groups):
            gs = g * ng
            lp_g = logprobs.reshape(b, nb, vocab)[:, gs : gs + ng]  # (b, ng, V)
            done_g = done[:, g]
            if groups > 1 and g > 0 and div != 0.0:
                # HammingDiversityLogitsProcessor runs first in HF's chain
                lp_g = lp_g - div * counts[:, None, :]
            if gen_cfg.has_logits_processors:
                # HF applies processors to the log-softmaxed scores, per beam,
                # before adding the cumulative beam scores
                hist = generated[:, gs : gs + ng].reshape(b * ng, max_new)
                n_prefix = 0
                if prefix_ids is not None:
                    n_prefix = prefix_ids.shape[1]
                    pref = prefix_ids.reshape(b, nb, n_prefix)[:, gs : gs + ng].reshape(b * ng, n_prefix)
                    hist = torch.cat([pref, hist], dim=1)
                lp_g = _process_scores(lp_g.reshape(b * ng, vocab), gen_cfg, hist, step + n_prefix, step)
                lp_g = lp_g.reshape(b, ng, vocab)

            if gen_cfg.do_sample:
                # HF beam_sample (one group): warp the augmented scores per
                # row, Gumbel top-k 2*ng from the flattened softmax, then sort
                # the drawn candidates by their warped score
                scored = lp_g.reshape(b * ng, vocab) + beam_scores.reshape(b * nb)[:, None]
                flat = _warp_logits(scored, gen_cfg, min_keep=2).reshape(b, ng * vocab)
                _, top_idx = _top_k(flat + noise(flat), 2 * ng)
                top_scores, order = _top_k(flat.gather(1, top_idx), 2 * ng)
                top_idx = top_idx.gather(1, order)
            else:
                flat = (lp_g + beam_scores[:, gs : gs + ng, None]).reshape(b, ng * vocab)
                top_scores, top_idx = _top_k(flat, 2 * ng)
            top_tokens = top_idx % vocab
            top_beams = top_idx // vocab  # local to the group
            is_eos = _token_in_set(top_tokens, eos)  # (b, 2ng)

            # live beams: the first ng non-eos candidates in rank order; the
            # rest go to a dropped column ng
            valid = ~is_eos
            slot = torch.cumsum(valid.to(torch.int64), dim=1) - 1
            scatter_idx = torch.where(valid & (slot < ng), slot, ng)

            def scat(src):
                return torch.zeros(b, ng + 1, dtype=src.dtype, device=device).scatter_(
                    1, scatter_idx, src)[:, :ng]

            # done groups emit pads with zero scores (HF), and those pads do
            # enter later groups' diversity counts (HF quirk)
            next_scores = scat(top_scores).masked_fill(done_g[:, None], 0.0)
            next_tokens = scat(top_tokens).masked_fill(done_g[:, None], pad)
            next_indices = scat(top_beams).masked_fill(done_g[:, None], 0)
            if groups > 1:
                counts.scatter_add_(1, next_tokens, torch.ones(b, ng, **f32))

            # hypothesis heap: union(existing, this step's eos candidates),
            # each candidate its source beam's tokens + the eos at `step`
            gen_g = generated[:, gs : gs + ng]
            cand_seq = gen_g.gather(1, top_beams[:, :, None].expand(b, 2 * ng, max_new))
            cand_seq[:, :, step] = top_tokens
            cand_ok = is_eos & rank_ok & ~done_g[:, None]
            cand_pen = torch.where(cand_ok, top_scores / len_pen, -torch.inf)
            all_scores = torch.cat([hyp_scores[:, g], cand_pen], dim=1)  # (b, 3ng)
            all_seqs = torch.cat([hyp_tokens[:, g], cand_seq], dim=1)  # (b, 3ng, max_new)
            hyp_scores_g, sel = _top_k(all_scores, ng)  # existing-first tie order
            hyp_tokens_g = all_seqs.gather(1, sel[:, :, None].expand(b, ng, max_new))

            # HF BeamHypotheses.is_done, per group
            full = (hyp_scores_g > -torch.inf).sum(dim=1) == ng
            if gen_cfg.early_stopping:
                ready = full
            else:
                ready = full & (hyp_scores_g[:, ng - 1] >= top_scores[:, 0] / len_pen)

            nx_scores.append(next_scores)
            nx_tokens.append(next_tokens)
            nx_indices.append(next_indices + gs)  # group-local -> beam-global
            new_hyp_scores.append(hyp_scores_g)
            new_hyp_tokens.append(hyp_tokens_g)
            new_done.append(done_g | ready)

        beam_scores = torch.cat(nx_scores, dim=1)  # (b, nb)
        next_tokens = torch.cat(nx_tokens, dim=1)
        next_indices = torch.cat(nx_indices, dim=1)
        hyp_scores = torch.stack(new_hyp_scores, dim=1)  # (b, G, ng)
        hyp_tokens = torch.stack(new_hyp_tokens, dim=1)  # (b, G, ng, max_new)
        done = torch.stack(new_done, dim=1)  # (b, G)

        # advance the live beams
        generated = generated.gather(1, next_indices[:, :, None].expand(b, nb, max_new))
        generated[:, :, step] = next_tokens

        step += 1
        all_done = bool(done.all())  # the one host read a step
        if step < max_new and not all_done:  # else the search just finished: no model step
            flat_idx = (torch.arange(b, device=device)[:, None] * nb + next_indices).reshape(-1)
            cache = _reorder_cache(cache, flat_idx)
            logprobs, cache = step_fn(next_tokens.reshape(-1), cache)

    # finalize (HF BeamSearchScorer.finalize): groups that never finished add
    # their live beams as hypotheses at the exit length; each group keeps its
    # best ng, then the groups' candidates pool per batch row, best first
    live_pen = torch.where(
        done[:, :, None], -torch.inf, beam_scores.reshape(b, groups, ng) / _pow32(max(step, 1), lp)
    )
    all_scores = torch.cat([hyp_scores, live_pen], dim=2)  # (b, G, 2ng)
    all_seqs = torch.cat([hyp_tokens, generated.reshape(b, groups, ng, max_new)], dim=2)
    grp_scores, sel = _top_k(all_scores, ng)
    grp_tokens = all_seqs.gather(2, sel[..., None].expand(b, groups, ng, max_new))
    final_scores, sel = _top_k(grp_scores.reshape(b, nb), nb)
    final_tokens = grp_tokens.reshape(b, nb, max_new).gather(1, sel[:, :, None].expand(b, nb, max_new))
    return final_scores, final_tokens


def _beam_search_decoder_only_device(
    model: nn.Module,
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor,
    gen_cfg: GenerationConfig,
    noise: Optional[Noise] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefill once per batch row, tile the cache across the beams (rows
    ``row*nb + beam``), then the beam engine over fp32 log-softmaxed logits."""
    b = inputs_embeds.shape[0]
    nb = gen_cfg.num_beams
    last_logits, cache = _prefill(model, inputs_embeds, attention_mask, gen_cfg.max_new_tokens)
    cache = _tile_cache(cache, nb)
    logprobs0 = torch.log_softmax(last_logits.repeat_interleave(nb, dim=0).float(), dim=-1)
    step_mask = torch.ones(b * nb, 1, dtype=torch.int32, device=inputs_embeds.device)

    def step_fn(tokens, cache):
        embeds = model.lm_embed(tokens[:, None])
        logits, cache = model.lm_forward(embeds, attention_mask=step_mask, cache=cache)
        return torch.log_softmax(logits[:, -1].float(), dim=-1), cache

    return _beam_engine(logprobs0, cache, step_fn, gen_cfg, b, noise=noise)


def _beam_search_decoder_only(
    model: nn.Module,
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor,
    gen_cfg: GenerationConfig,
    noise: Optional[Noise] = None,
) -> torch.Tensor:
    """Beam search (or beam_sample, with ``noise``, which it then requires):
    the best ``num_return_sequences`` hypotheses of each row, interleaved
    (``row*nrs + rank``) and cut at the longest one's length."""
    _, tokens = _beam_search_decoder_only_device(model, inputs_embeds, attention_mask, gen_cfg, noise)
    nrs = gen_cfg.num_return_sequences
    return _trim_to_longest(tokens[:, :nrs].reshape(-1, tokens.shape[-1]), gen_cfg.pad_token_id)


def _trim_to_longest(best: torch.Tensor, pad: int) -> torch.Tensor:
    """Cut trailing all-pad columns (HF returns sequences at the longest
    hypothesis length)."""
    used = (best != pad).any(dim=0).nonzero()
    if used.numel() == 0:
        return best[:, :1]
    return best[:, : int(used.max()) + 1]


def _t5_cache(model: VB, inputs_embeds, attention_mask, max_new: int) -> dict:
    """Encode the prompt; the decode cache of ``max_new + 1`` slots (the
    start token and every new one), the cross K/V projected once from the
    encoder states. The cached steps read the cross K/V, never the states."""
    encoder_hidden = model.t5_encode(inputs_embeds, attention_mask)
    return model.language_model.init_decode_cache(encoder_hidden, max_new + 1)


def _greedy_sample_seq2seq(
    model: VB,
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor,
    gen_cfg: GenerationConfig,
    noise: Optional[Noise] = None,
) -> torch.Tensor:
    """Encode, run the start token, then :func:`_sample_loop` over the
    decoder steps. Returns (B * nrs, 1 + max_new_tokens) int64 tokens, the
    start token first and pad after eos; the logits processors see ``[start]
    + generated``, as HF's seq2seq input_ids. ``num_return_sequences > 1``
    (sampling) encodes once and tiles the cache, rows interleaved
    (``row*nrs + i``)."""
    cache = _t5_cache(model, inputs_embeds, attention_mask, gen_cfg.max_new_tokens)
    nrs = gen_cfg.num_return_sequences if gen_cfg.do_sample else 1
    if nrs > 1:
        cache = _tile_cache(cache, nrs)
        attention_mask = attention_mask.repeat_interleave(nrs, dim=0)
    start = torch.full((attention_mask.shape[0], 1), model.config.text_config.decoder_start_token_id,
                       dtype=torch.int64, device=inputs_embeds.device)

    def step_fn(tok):
        logits, _ = model.t5_decode_step(tok[:, None], None, attention_mask, cache)
        return logits[:, -1]

    out = _sample_loop(step_fn(start[:, 0]), step_fn, gen_cfg, noise, prefix=start)
    return torch.cat([start, out], dim=1)


def _beam_search_seq2seq_device(
    model: VB,
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor,
    gen_cfg: GenerationConfig,
    noise: Optional[Noise] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode once per batch row and build its decode cache (cross K/V
    included) once, tile both across the beams (rows ``row*nb + beam``), run
    the start token, then the beam engine; its reorder gathers ``k``, ``v``,
    ``cross_k`` and ``cross_v`` along the beam axis."""
    b = inputs_embeds.shape[0]
    nb = gen_cfg.num_beams
    cache = _t5_cache(model, inputs_embeds, attention_mask, gen_cfg.max_new_tokens)
    cache = _tile_cache(cache, nb)
    enc_mask = attention_mask.repeat_interleave(nb, dim=0)

    def step_fn(tokens, cache):
        logits, cache = model.t5_decode_step(tokens[:, None], None, enc_mask, cache)
        return torch.log_softmax(logits[:, -1].float(), dim=-1), cache

    start = torch.full((b * nb,), model.config.text_config.decoder_start_token_id, dtype=torch.int64,
                       device=inputs_embeds.device)
    logprobs0, cache = step_fn(start, cache)
    return _beam_engine(logprobs0, cache, step_fn, gen_cfg, b, noise=noise, prefix_ids=start[:, None])


def _beam_search_seq2seq(
    model: VB,
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor,
    gen_cfg: GenerationConfig,
    noise: Optional[Noise] = None,
) -> torch.Tensor:
    """Seq2seq beam search: the best ``num_return_sequences`` hypotheses of
    each row, interleaved, cut at the longest one's length, then the start
    token prepended (HF's sequences begin with it)."""
    _, tokens = _beam_search_seq2seq_device(model, inputs_embeds, attention_mask, gen_cfg, noise)
    nrs = gen_cfg.num_return_sequences
    best = _trim_to_longest(tokens[:, :nrs].reshape(-1, tokens.shape[-1]), gen_cfg.pad_token_id)
    start = best.new_full((best.shape[0], 1), model.config.text_config.decoder_start_token_id)
    return torch.cat([start, best], dim=1)


def _decode(
    model: nn.Module,
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor,
    gen_cfg: GenerationConfig,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The mode ``gen_cfg`` asks for, decoder-only or seq2seq by the text
    config: beam search when ``num_beams > 1``, else the greedy/sampling
    loop; with ``do_sample`` the noise comes from ``generator``
    (:func:`_seeded_noise`)."""
    noise = _seeded_noise(generator, inputs_embeds.device) if gen_cfg.do_sample else None
    if isinstance(model.config.text_config, T5Config):
        loop = _beam_search_seq2seq if gen_cfg.num_beams > 1 else _greedy_sample_seq2seq
    else:
        loop = _beam_search_decoder_only if gen_cfg.num_beams > 1 else _greedy_sample_decoder_only
    return loop(model, inputs_embeds, attention_mask, gen_cfg, noise)


def _contrastive_decoder_only(
    model: nn.Module,
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor,
    gen_cfg: GenerationConfig,
) -> torch.Tensor:
    """HF contrastive search (``penalty_alpha > 0``, ``top_k > 1``), with no
    cache surgery. HF repeats the KV cache k times, runs the k candidates as
    a B*k batch and reorders the cache to the chosen branch; here, as in JAX,
    the k candidates (all at the same next position over the same prefix)
    are one ``lm_candidates`` pass over the shared read-only cache, and the
    chosen token commits through the ordinary one-token step. The context
    hidden states (HF ``hidden_states[-1]``) fill an fp32 (B, S + max_new,
    D) buffer; the degeneration penalty is the largest cosine (eps 1e-8,
    ``F.cosine_similarity``'s) against its filled prefix, prompt pads
    included, as in HF. Early exit once every row has emitted eos. Returns
    (B, max_new_tokens) int64 tokens, pad after eos."""
    b, s, _ = inputs_embeds.shape
    k = gen_cfg.top_k
    alpha = gen_cfg.penalty_alpha
    max_new = gen_cfg.max_new_tokens
    device = inputs_embeds.device
    cache = init_cache(model.config.text_config, b, s + max_new, dtype=inputs_embeds.dtype, device=device)
    logits, hidden, cache = model.lm_forward_hidden(inputs_embeds, attention_mask=attention_mask, cache=cache)
    hbuf = torch.zeros(b, s + max_new, hidden.shape[-1], dtype=torch.float32, device=device)
    hbuf[:, :s] = hidden.float()
    logits = logits[:, -1]
    out = torch.full((b, max_new), gen_cfg.pad_token_id, dtype=torch.int64, device=device)
    finished = torch.zeros(b, dtype=torch.bool, device=device)
    step_mask = torch.ones(b, 1, dtype=torch.int32, device=device)
    for step in range(max_new):
        x = logits.float()
        if gen_cfg.has_logits_processors:
            x = _process_scores(x, gen_cfg, out, step, step)
        top_p, top_ids = _top_k(torch.softmax(x, dim=-1), k)  # (B, k)
        _, cand_hidden = model.lm_candidates(model.lm_embed(top_ids), cache)  # (B, k, D)
        ch, ctx = cand_hidden.float(), hbuf[:, : s + step]
        dots = torch.einsum("bkd,btd->bkt", ch, ctx)
        norms = ch.norm(dim=-1)[:, :, None] * ctx.norm(dim=-1)[:, None, :]
        penalty = (dots / norms.clamp_min(1e-8)).max(dim=-1).values  # (B, k)
        score = (1.0 - alpha) * top_p - alpha * penalty
        tok = top_ids.gather(1, score.argmax(dim=-1, keepdim=True))[:, 0]
        tok = torch.where(finished, gen_cfg.pad_token_id, tok)
        finished = finished | _is_eos(tok, gen_cfg)
        out[:, step] = tok
        if step == max_new - 1 or bool(finished.all()):
            break
        # commit: the ordinary cached step for the chosen token (the values
        # the expansion computed for it), writing its k/v and hidden state
        next_logits, next_hidden, cache = model.lm_forward_hidden(
            model.lm_embed(tok[:, None]), attention_mask=step_mask, cache=cache)
        hbuf[:, s + step] = next_hidden[:, 0].float()
        logits = next_logits[:, -1]
    return out


def _is_contrastive(gen_cfg: GenerationConfig) -> bool:
    """HF's mode selection: contrastive search iff penalty_alpha > 0,
    top_k > 1, num_beams == 1 and do_sample is off."""
    return (
        bool(gen_cfg.penalty_alpha)
        and gen_cfg.penalty_alpha > 0
        and gen_cfg.top_k > 1
        and gen_cfg.num_beams == 1
        and not gen_cfg.do_sample
    )


def _embed_prompt(model, input_ids, attention_mask, pixel_values, video_input_mask, video_features=None,
                  vision_chunks: int = 1):
    """The prompt's embeddings with the videos scattered in (or prepended, by
    a v1 model, whose mask is then extended with ones on the left), and the
    mask over them."""
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    if video_features is not None:
        inputs_embeds = model.embed_and_scatter(input_ids, None, video_input_mask, video_features=video_features)
    elif vision_chunks > 1 and pixel_values is not None:
        inputs_embeds = embed_and_scatter_chunked(
            model, input_ids, pixel_values, video_input_mask, vision_chunks=vision_chunks
        )
    else:
        inputs_embeds = model.embed_and_scatter(input_ids, pixel_values, video_input_mask)
    extra = inputs_embeds.shape[1] - attention_mask.shape[1]
    if extra:
        attention_mask = torch.cat([attention_mask.new_ones(attention_mask.shape[0], extra), attention_mask], dim=1)
    return inputs_embeds, attention_mask


def _speculative(
    lm: nn.Module,
    input_ids: torch.Tensor,
    video_input_mask: Optional[torch.Tensor],
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor,
    gen_cfg: GenerationConfig,
    generator: Optional[torch.Generator],
    draft: Optional[str],
    draft_layers: Optional[int],
    draft_tokens: int,
    draft_match_len: int,
    lookup_corpus: Optional[torch.Tensor],
) -> Optional[torch.Tensor]:
    """The speculative modes of ``generate`` and ``TextLM.generate`` over the
    bare LM ``lm``, with JAX's guards: ``draft="prompt_lookup"`` (greedy or
    sampling), then ``draft_layers`` with greedy. None when neither applies
    (``draft_layers`` with sampling falls through to the plain loop, as in
    JAX)."""
    from .speculative import (
        build_lookup_corpus,
        make_self_draft,
        prompt_lookup_greedy_decode,
        prompt_lookup_sample_decode,
        speculative_greedy_decode,
    )

    if draft == "prompt_lookup":
        if gen_cfg.has_logits_processors:
            raise NotImplementedError(
                "speculative decoding implements plain greedy/sampling; drop "
                "draft='prompt_lookup' to use repetition_penalty/"
                "no_repeat_ngram_size/min_new_tokens"
            )
        if gen_cfg.num_return_sequences > 1:
            raise NotImplementedError(
                "speculative decoding returns one sequence per input; drop "
                "draft='prompt_lookup' to use num_return_sequences > 1"
            )
        if lookup_corpus is None:
            lookup_corpus = build_lookup_corpus(
                input_ids, attention_mask[:, -input_ids.shape[1]:], video_input_mask)
        if gen_cfg.do_sample:
            return prompt_lookup_sample_decode(
                lm, lookup_corpus, inputs_embeds, attention_mask, gen_cfg,
                _seeded_generator(generator, inputs_embeds.device), gamma=draft_tokens, match_len=draft_match_len,
            )
        return prompt_lookup_greedy_decode(
            lm, lookup_corpus, inputs_embeds, attention_mask, gen_cfg,
            gamma=draft_tokens, match_len=draft_match_len,
        )
    if draft_layers and not gen_cfg.do_sample:
        if gen_cfg.has_logits_processors:
            raise NotImplementedError(
                "speculative decoding implements plain greedy; drop "
                "draft_layers to use repetition_penalty/no_repeat_ngram_size/"
                "min_new_tokens"
            )
        return speculative_greedy_decode(
            lm, make_self_draft(lm, draft_layers), inputs_embeds, attention_mask, gen_cfg, gamma=draft_tokens)
    return None


@torch.inference_mode()
def generate(
    model: VB,
    *,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    pixel_values: Optional[torch.Tensor] = None,
    video_input_mask: Optional[torch.Tensor] = None,
    generation_config: GenerationConfig = GenerationConfig(),
    generator: Optional[torch.Generator] = None,
    vision_chunks: int = 1,
    draft_layers: Optional[int] = None,
    draft_tokens: int = 4,
    draft: Optional[str] = None,
    draft_match_len: int = 3,
    lookup_corpus: Optional[torch.Tensor] = None,
    video_features: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``generate`` for VideoBLIP over OPT or T5: encode the videos, scatter
    them into the prompt embeddings (a v1 model prepends them), decode. A T5
    model runs beam search or the greedy/sampling loop below over its
    encoder states; the contrastive and speculative modes are OPT's.

    ``num_beams > 1`` runs beam search (``do_sample``: beam_sample;
    ``num_beam_groups > 1``: group beam search) and returns the best
    ``num_return_sequences`` hypotheses a row, cut at the longest one's
    length. ``penalty_alpha > 0`` with ``top_k > 1`` (greedy) runs
    contrastive search. ``draft="prompt_lookup"`` runs model-free
    speculative decoding: each verify pass checks the ``draft_tokens``
    tokens that followed the emitted tail n-gram (``draft_match_len`` down
    to 1) in ``lookup_corpus`` (default: ``input_ids`` with padding and video
    positions masked) and the text so far; greedy is token-identical to the
    plain loop, sampling has its output law. ``draft_layers=k`` (greedy)
    runs speculative decoding with the LM's first k layers drafting
    ``draft_tokens`` tokens a pass, token-identical. Otherwise the
    greedy/sampling loop runs, with the logits processors and warpers;
    ``num_return_sequences > 1`` (sampling) returns that many rows an input
    row. Rows come back interleaved (``row*n + i``). ``generator`` (where
    JAX takes ``rng``) feeds the sampling draws and must be on the model's
    device (another raises ``ValueError``); with none, a generator on the
    model's device seeded with 0.

    Returns (B*n, <= max_new_tokens) generated token ids (OPT: new tokens
    only; T5: the decoder start token, then the new tokens, as HF; pad after
    eos). ``video_features`` (precomputed ``encode_videos`` output,
    (num_videos * num_query_tokens, text_hidden)) skips the vision tower and
    takes precedence over ``pixel_values``; ``vision_chunks > 1`` runs the
    vision tower over that many sequential pieces of the videos.
    """
    cfg: VideoBlipConfig = model.config
    if not isinstance(cfg.text_config, (OPTConfig, T5Config)):
        raise NotImplementedError(
            f"generate() supports OPT and T5 text configs, got {type(cfg.text_config).__name__}; "
            "for LLaMA-family LMs use eilev_tpu_torch.generation.text_lm.TextLM"
        )
    seq2seq = isinstance(cfg.text_config, T5Config)
    gen_cfg = generation_config
    if gen_cfg.eos_token_id is None:
        gen_cfg = gen_cfg.with_eos(cfg.text_config.eos_token_id)
    _validate_num_return_sequences(gen_cfg)
    _validate_beam_groups(gen_cfg)
    if seq2seq and _is_contrastive(gen_cfg):
        raise NotImplementedError(
            "contrastive search (penalty_alpha) is implemented for the "
            "decoder-only family; for T5 drop penalty_alpha (or set top_k=1) "
            "to fall back to greedy"
        )
    inputs_embeds, attention_mask = _embed_prompt(
        model, input_ids, attention_mask, pixel_values, video_input_mask, video_features, vision_chunks)
    if draft is not None and draft != "prompt_lookup":
        raise ValueError(f"unknown draft strategy {draft!r}; supported: 'prompt_lookup'")
    # HF counts min_length/max_length over prompt + generated for decoder-only
    # and over the decoder tokens, start token included, for seq2seq
    gen_cfg = _resolve_lengths(gen_cfg, start_len=1 if seq2seq else inputs_embeds.shape[1])
    if seq2seq or gen_cfg.num_beams > 1:
        return _decode(model, inputs_embeds, attention_mask, gen_cfg, generator)
    if _is_contrastive(gen_cfg):
        if draft is not None or draft_layers:
            raise NotImplementedError(
                "contrastive search (penalty_alpha) does not compose with "
                "speculative drafting; drop draft/draft_layers"
            )
        return _contrastive_decoder_only(model, inputs_embeds, attention_mask, gen_cfg)
    tokens = _speculative(
        model.language_model, input_ids, video_input_mask, inputs_embeds, attention_mask, gen_cfg, generator,
        draft, draft_layers, draft_tokens, draft_match_len, lookup_corpus)
    if tokens is not None:
        return tokens
    return _decode(model, inputs_embeds, attention_mask, gen_cfg, generator)


# ---------------------------------------------------------------------------
# streaming generation (decoder-only)
# ---------------------------------------------------------------------------


def _decode_chunk(
    model: nn.Module,
    cache: dict,
    logits: torch.Tensor,
    finished: torch.Tensor,
    gen_cfg: GenerationConfig,
    noise: Optional[Noise],
    chunk: int,
):
    """``chunk`` decode steps: select a token from ``logits``, then the
    one-token model step, as JAX's scan (the cache is updated in place).
    Returns (logits, finished, tokens (B, chunk))."""
    b = logits.shape[0]
    step_mask = torch.ones(b, 1, dtype=torch.int32, device=logits.device)
    toks = []
    for _ in range(chunk):
        tok = _select_token(logits, gen_cfg, noise)
        tok = torch.where(finished, gen_cfg.pad_token_id, tok)
        finished = finished | _is_eos(tok, gen_cfg)
        next_logits, cache = model.lm_forward(model.lm_embed(tok[:, None]), attention_mask=step_mask, cache=cache)
        logits = next_logits[:, -1]
        toks.append(tok)
    return logits, finished, torch.stack(toks, dim=1)


def generate_stream(
    model: VB,
    *,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    pixel_values: Optional[torch.Tensor] = None,
    video_input_mask: Optional[torch.Tensor] = None,
    generation_config: GenerationConfig = GenerationConfig(),
    generator: Optional[torch.Generator] = None,
    chunk_tokens: int = 4,
) -> Iterator[torch.Tensor]:
    """Stream greedy or sampled tokens in chunks of ``chunk_tokens``.

    Yields (B, <= chunk_tokens) int64 CPU tensors of NEW tokens (pad after
    each row's eos) until every row is finished or the budget is spent; one
    device read a chunk. The concatenated stream is ``generate``'s tokens
    (the same step, the same kernels; with ``do_sample`` the same draws from
    the same ``generator``). Decoder-only LMs; beam search, contrastive
    search, ``num_return_sequences > 1``, the history-dependent logits
    processors and a minimum length raise ``NotImplementedError``, as in
    JAX.
    """
    cfg: VideoBlipConfig = model.config
    if not isinstance(cfg.text_config, (OPTConfig, LlamaConfig)):
        raise NotImplementedError(
            f"generate_stream supports decoder-only LMs (OPT, LLaMA), got "
            f"{type(cfg.text_config).__name__}"
        )
    if generation_config.num_beams > 1:
        raise NotImplementedError("beam search cannot stream; use generate()")
    if generation_config.has_logits_processors:
        raise NotImplementedError(
            "history-dependent logits processors (repetition_penalty/"
            "no_repeat_ngram_size/min_new_tokens/bad_words_ids/forced/"
            "suppress tokens) need the full generated history per step; "
            "use generate()"
        )
    if generation_config.num_return_sequences > 1:
        raise NotImplementedError(
            "num_return_sequences > 1 cannot stream (rows would interleave "
            "mid-yield); use generate()"
        )
    if _is_contrastive(generation_config):
        raise NotImplementedError("contrastive search (penalty_alpha) does not stream; use generate()")
    gen_cfg = generation_config
    if gen_cfg.eos_token_id is None:
        gen_cfg = gen_cfg.with_eos(cfg.text_config.eos_token_id)
    with torch.inference_mode():
        inputs_embeds, attention_mask = _embed_prompt(
            model, input_ids, attention_mask, pixel_values, video_input_mask)
        gen_cfg = _resolve_lengths(gen_cfg, start_len=inputs_embeds.shape[1])
        if gen_cfg.min_new_tokens > 0:
            raise NotImplementedError(
                "min_length translates to min_new_tokens, which needs a step "
                "counter in the decode loop; use generate()"
            )
        noise = _seeded_noise(generator, inputs_embeds.device) if gen_cfg.do_sample else None
        logits, cache = _prefill(model, inputs_embeds, attention_mask, gen_cfg.max_new_tokens)
        finished = torch.zeros(inputs_embeds.shape[0], dtype=torch.bool, device=inputs_embeds.device)
    emitted = 0
    while emitted < gen_cfg.max_new_tokens:
        chunk = min(chunk_tokens, gen_cfg.max_new_tokens - emitted)
        with torch.inference_mode():
            logits, finished, toks = _decode_chunk(model, cache, logits, finished, gen_cfg, noise, chunk)
            done = torch.cat([toks.flatten(), finished.all().view(1).to(toks.dtype)]).cpu()
        emitted += chunk
        yield done[:-1].view(toks.shape)
        if bool(done[-1]):
            return
