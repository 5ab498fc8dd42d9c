"""Speculative decoding for decoder-only LMs (counterpart of
``eilev_tpu/generation/speculative.py``).

A draft proposes ``gamma`` tokens, the target checks all of them in one
multi-token forward (``cache_append=True``: the same weight stream as one
decode step), and the longest agreeing prefix plus the target's own next
token are emitted. Greedy output is token-identical to plain greedy by
construction: the verify pass recomputes the target's argmax at every
position.

Drafts: the target's first N layers (:func:`make_self_draft`, which shares
the target's parameters and gets a stacked cache of its own), or model-free
prompt lookup (:func:`lookup_drafts_rows`: the tokens that followed the
first occurrence of the emitted tail n-gram in the prompt and the text so
far). :func:`prompt_lookup_sample_decode` is distribution-preserving
speculative sampling over the lookup drafts.

Batched semantics as in JAX: each iteration advances every row by the
smallest acceptance among unfinished rows (the cache has one fill index);
rows that accepted more re-derive those tokens next iteration. The JAX
``while_loop`` is a host loop here, with one device read a verify pass (the
advance and whether every row is done, read together); the cache rollback
is JAX's ``trim`` applied in place. Caches are ``s + max_new + gamma + 2``
slots, as in JAX.

The loops take the bare LM (``OPTForCausalLM`` or ``LlamaForCausalLM``,
whose forward has ``cache_append``), not the VideoBLIP wrapper.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..models.opt import init_cache
from .config import GenerationConfig
from .logits import _token_in_set, _warp_logits, gumbel_noise


def make_self_draft(lm: nn.Module, num_layers: int) -> nn.Module:
    """The target's first ``num_layers`` decoder layers plus everything around
    the stack (embeddings, final norm, head), as a model of the target's own
    class. It SHARES the target's parameters and submodules (nothing is
    copied); its config differs only in ``num_hidden_layers``, so its cache
    (``models/opt.init_cache``) is stacked over ``num_layers`` layers."""
    draft = type(lm).__new__(type(lm))
    nn.Module.__init__(draft)
    for key, val in vars(lm).items():
        if not key.startswith("_"):  # config, compute_dtype, training
            setattr(draft, key, val)
    draft.config = dataclasses.replace(lm.config, num_hidden_layers=num_layers)
    for name, child in lm.named_children():
        setattr(draft, name, child)
    draft.layers = nn.ModuleList(list(lm.layers)[:num_layers])
    return draft


def _emit(
    drafts: torch.Tensor,
    correction: torch.Tensor,
    amin: torch.Tensor,
    finished: torch.Tensor,
    gen_cfg: GenerationConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The (B, gamma + 1) block a verify pass emits: d_1..d_amin, then the
    row's token at column amin, pad after; pad for finished rows and after
    each row's first eos. Returns (emit, new_finished)."""
    b, gamma = drafts.shape
    pad = gen_cfg.pad_token_id
    col = torch.arange(gamma + 1, device=drafts.device)[None, :]
    emit0 = torch.cat([drafts, drafts.new_full((b, 1), pad)], dim=1)
    emit = torch.where(col < amin, emit0, torch.where(col == amin, correction[:, None], pad))
    emit = torch.where(finished[:, None], pad, emit)
    hits = _token_in_set(emit, tuple(gen_cfg.eos_token_id or ())) & (col <= amin)
    first_eos = torch.where(hits, col, gamma + 1).min(dim=1).values
    emit = torch.where(col > first_eos[:, None], pad, emit)
    return emit, finished | (first_eos <= gamma)


def _trim(cache: dict, new_index: int) -> None:
    """Roll ``cache`` back to its first ``new_index`` slots, in place (JAX's
    ``trim``): later slots leave the mask, ``pos`` steps back by the slots
    dropped. The k/v rows stay behind the mask and are overwritten later."""
    cache["mask"][:, new_index:] = 0
    cache["pos"] -= cache["index"] - new_index
    cache["index"] = new_index


def _accepted(agree: torch.Tensor, finished: torch.Tensor, gamma: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's accepted prefix length and their minimum over unfinished
    rows (gamma when every row is finished), both on the device."""
    a_row = torch.cumprod(agree.to(torch.int64), dim=1).sum(dim=1)
    return a_row, torch.where(finished, gamma, a_row).min()


def _start(lm: nn.Module, inputs_embeds: torch.Tensor, attention_mask: torch.Tensor, cache_len: int):
    """Prefill ``lm`` into a fresh cache of ``cache_len`` slots."""
    b = inputs_embeds.shape[0]
    cache = init_cache(lm.config, b, cache_len, dtype=inputs_embeds.dtype, device=inputs_embeds.device, tp=lm.tp)
    logits, cache = lm(inputs_embeds, attention_mask=attention_mask, cache=cache)
    return logits, cache


def _verify(lm: nn.Module, cache: dict, pending: torch.Tensor, drafts: torch.Tensor) -> torch.Tensor:
    """One target pass over [pending, d_1..d_gamma] appended to the cache:
    (B, gamma + 1, V) logits."""
    block = torch.cat([pending[:, None], drafts], dim=1)
    ones = torch.ones(block.shape, dtype=torch.int32, device=block.device)
    logits, _ = lm(lm.embed(block), attention_mask=ones, cache=cache, cache_append=True)
    return logits


@torch.inference_mode()
def speculative_greedy_decode(
    lm: nn.Module,
    draft_lm: nn.Module,
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor,
    gen_cfg: GenerationConfig,
    gamma: int = 4,
) -> torch.Tensor:
    """Greedy decode with draft-and-verify blocks, token-identical to plain
    greedy. Returns (B, max_new_tokens) int64 tokens, pad after eos (the
    contract of ``decoding._greedy_sample_decoder_only``)."""
    if gen_cfg.do_sample:
        raise AssertionError("speculative path implements greedy only")
    b, s, _ = inputs_embeds.shape
    max_new = gen_cfg.max_new_tokens
    pad = gen_cfg.pad_token_id
    cache_len = s + max_new + gamma + 2
    t_logits, t_cache = _start(lm, inputs_embeds, attention_mask, cache_len)
    _, d_cache = _start(draft_lm, inputs_embeds, attention_mask, cache_len)
    # the target's next token is known from the prefill; it is token 0
    pending = t_logits[:, -1].argmax(dim=-1)
    finished = _token_in_set(pending, tuple(gen_cfg.eos_token_id or ()))
    out = torch.full((b, max_new + gamma + 2), pad, dtype=torch.int64, device=inputs_embeds.device)
    out[:, 0] = pending
    one = torch.ones(b, 1, dtype=torch.int32, device=inputs_embeds.device)

    n_emitted, done = 1, bool(finished.all())
    while n_emitted < max_new and not done:
        # gamma + 1 one-token draft steps: the last only fills the draft cache
        tok, drafts = pending, []
        for _ in range(gamma + 1):
            logits, _ = draft_lm(draft_lm.embed(tok[:, None]), attention_mask=one, cache=d_cache)
            tok = logits[:, -1].argmax(dim=-1)
            drafts.append(tok)
        drafts = torch.stack(drafts[:gamma], dim=1)  # (B, gamma)

        targets = _verify(lm, t_cache, pending, drafts).argmax(dim=-1)  # (B, gamma + 1)
        _, amin = _accepted(drafts == targets[:, :gamma], finished, gamma)
        # rows accepting more than amin have d_{amin+1} == y_{amin+1}
        correction = targets.gather(1, amin.expand(b, 1))[:, 0]
        emit, finished = _emit(drafts, correction, amin, finished, gen_cfg)
        pending = torch.where(finished, pad, correction)
        a, done = (int(v) for v in torch.stack([amin, finished.all().to(amin.dtype)]).tolist())
        out[:, n_emitted : n_emitted + gamma + 1] = emit
        _trim(t_cache, t_cache["index"] - gamma + a)
        _trim(d_cache, d_cache["index"] - gamma + a)
        n_emitted += a + 1
    return out[:, :max_new]


# ---------------------------------------------------------------------------
# prompt-lookup drafting (model-free)
# ---------------------------------------------------------------------------


def lookup_drafts_rows(
    corpus: torch.Tensor,
    end: torch.Tensor,
    gamma: int,
    match_len: int,
    pad: int,
    vocab: Optional[int] = None,
) -> torch.Tensor:
    """(B, gamma) proposed continuations of each row's emitted tail.

    ``corpus``: (B, CL) integer tokens, invalid positions -1
    (:func:`build_lookup_corpus`); ``end``: (B,) each row's first invalid
    position. HF prompt-lookup semantics per row: n-gram sizes from
    ``match_len`` down to 1, the first size with a match wins, and its FIRST
    occurrence (whose window and one continuation token lie before ``end``,
    which excludes the tail's match with itself). Rows with no match, and
    positions that are -1 or (with ``vocab``) out of the vocabulary, propose
    ``pad``: an out-of-vocabulary id must never reach the verify pass's
    embedding. Slices clamp into the corpus as ``jax.lax.dynamic_slice``
    does."""
    b, cl = corpus.shape
    device = corpus.device
    end = end.to(torch.int64)
    found = torch.zeros(b, dtype=torch.bool, device=device)
    start = torch.zeros(b, dtype=torch.int64, device=device)
    for k in range(match_len, 0, -1):
        tail_at = (end - k).clamp(0, cl - k)
        tail = corpus.gather(1, tail_at[:, None] + torch.arange(k, device=device)[None, :])  # (B, k)
        nwin = cl - k
        match = torch.ones(b, nwin, dtype=torch.bool, device=device)
        for j in range(k):
            match &= corpus[:, j : j + nwin] == tail[:, j : j + 1]
        widx = torch.arange(nwin, device=device)[None, :]
        ok = match & (widx + k < end[:, None])
        has_k = ok.any(dim=1)
        best_k = torch.where(ok, widx, cl).min(dim=1).values  # first occurrence
        start = torch.where(has_k & ~found, best_k + k, start)
        found |= has_k
    at = start.clamp(0, cl - gamma)
    drafts = corpus.gather(1, at[:, None] + torch.arange(gamma, device=device)[None, :])
    ok = found[:, None] & (drafts >= 0)
    if vocab is not None:
        ok &= drafts < vocab
    return torch.where(ok, drafts, pad)


def build_lookup_corpus(
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    video_input_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The prompt-side lookup corpus: ``input_ids`` with padding and
    video-feature placeholder positions set to -1 (never a real token, so
    the query-token pad runs of the interleaved prompt never match)."""
    corpus = input_ids.to(torch.int64)
    keep = torch.ones_like(corpus, dtype=torch.bool)
    if attention_mask is not None:
        keep &= attention_mask > 0
    if video_input_mask is not None:
        keep &= video_input_mask == 0
    return torch.where(keep, corpus, -1)


@torch.inference_mode()
def prompt_lookup_greedy_decode(
    lm: nn.Module,
    prompt_corpus: torch.Tensor,
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor,
    gen_cfg: GenerationConfig,
    gamma: int = 8,
    match_len: int = 3,
    return_stats: bool = False,
):
    """Greedy decode with model-free prompt-lookup drafts, token-identical
    to plain greedy whatever the corpus. ``prompt_corpus``: (B, P) from
    :func:`build_lookup_corpus`, or any wider corpus (ids outside the
    vocabulary are never proposed). ``return_stats=True`` also returns
    (tokens emitted, verify passes) as ints: tokens a pass is the realised
    advance (1 = no draft accepted, gamma + 1 = all)."""
    if gen_cfg.do_sample:
        raise AssertionError("prompt-lookup path implements greedy only")
    return _prompt_lookup(lm, prompt_corpus, inputs_embeds, attention_mask, gen_cfg, None, gamma, match_len,
                          return_stats)


@torch.inference_mode()
def prompt_lookup_sample_decode(
    lm: nn.Module,
    prompt_corpus: torch.Tensor,
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor,
    gen_cfg: GenerationConfig,
    generator: torch.Generator,
    gamma: int = 8,
    match_len: int = 3,
    return_stats: bool = False,
):
    """Distribution-preserving sampling over prompt-lookup drafts.

    The rejection rule of speculative sampling for a point-mass draft:
    d_{i+1} is accepted with probability p_i(d_{i+1}) (one uniform against
    the target's warped probability: temperature -> top_k -> top_p -> ...,
    the plain sampling loop's warp), and the first rejected position draws
    from p_i with d_{i+1} removed; after full acceptance the bonus position
    draws from p_gamma. Every emitted token is an exact draw from the
    target's warped distribution; only the speed depends on the drafts. The
    draws come from ``generator`` (uniforms and Gumbel noise, a fixed number
    a pass), so the output law is JAX's and the stream is not; rows that
    accepted past the batch's advance discard their draws. Same contract as
    :func:`prompt_lookup_greedy_decode` otherwise."""
    if not gen_cfg.do_sample:
        raise AssertionError("use prompt_lookup_greedy_decode for greedy")
    return _prompt_lookup(lm, prompt_corpus, inputs_embeds, attention_mask, gen_cfg, generator, gamma,
                          match_len, return_stats)


def _prompt_lookup(lm, prompt_corpus, inputs_embeds, attention_mask, gen_cfg, generator, gamma, match_len,
                   return_stats):
    """The verify loop of both prompt-lookup decoders: greedy acceptance
    when ``generator`` is None, the speculative-sampling rule otherwise."""
    b, s, _ = inputs_embeds.shape
    device = inputs_embeds.device
    max_new = gen_cfg.max_new_tokens
    pad = gen_cfg.pad_token_id
    sample = generator is not None
    noise = gumbel_noise(generator) if sample else None
    vocab = lm.config.vocab_size
    prompt_corpus = prompt_corpus.to(device=device, dtype=torch.int64)
    p_len = prompt_corpus.shape[1]

    def warp(logits):
        # the plain sampling loop's warper chain, in fp32
        return _warp_logits(logits.float(), gen_cfg)

    t_logits, t_cache = _start(lm, inputs_embeds, attention_mask, s + max_new + gamma + 2)
    if sample:
        x0 = warp(t_logits[:, -1])
        pending = (x0 + noise(x0)).argmax(dim=-1)
    else:
        pending = t_logits[:, -1].argmax(dim=-1)
    finished = _token_in_set(pending, tuple(gen_cfg.eos_token_id or ()))
    out = torch.full((b, max_new + gamma + 2), pad, dtype=torch.int64, device=device)
    out[:, 0] = pending

    n_emitted, iters, done = 1, 0, bool(finished.all())
    while n_emitted < max_new and not done:
        corpus = torch.cat([prompt_corpus, out], dim=1)
        end = torch.full((b,), p_len + n_emitted, dtype=torch.int64, device=device)
        drafts = lookup_drafts_rows(corpus, end, gamma, match_len, pad, vocab=vocab)  # (B, gamma)
        v_logits = _verify(lm, t_cache, pending, drafts)
        if sample:
            x = warp(v_logits)  # (B, gamma + 1, V)
            p_draft = torch.softmax(x[:, :gamma], dim=-1).gather(-1, drafts[..., None])[..., 0]
            u = torch.rand(b, gamma, generator=generator, device=device)
            a_row, amin = _accepted(u < p_draft, finished, gamma)
            # at column amin: the accepted draft where the row went further,
            # else a draw from p_amin without the rejected draft (the bonus
            # position, amin == gamma, draws from p_gamma unmasked)
            x_sel = x.gather(1, amin.view(1, 1, 1).expand(b, 1, x.shape[-1]))[:, 0]
            d_sel = drafts.gather(1, amin.clamp(max=gamma - 1).expand(b, 1))[:, 0]
            rejected_here = (a_row == amin) & (amin < gamma)
            vocab_iota = torch.arange(x.shape[-1], device=device)[None, :]
            x_masked = torch.where(rejected_here[:, None] & (vocab_iota == d_sel[:, None]),
                                   torch.finfo(x_sel.dtype).min, x_sel)
            resampled = (x_masked + noise(x_masked)).argmax(dim=-1)
            correction = torch.where(a_row > amin, d_sel, resampled)
        else:
            targets = v_logits.argmax(dim=-1)
            _, amin = _accepted(drafts == targets[:, :gamma], finished, gamma)
            correction = targets.gather(1, amin.expand(b, 1))[:, 0]
        emit, finished = _emit(drafts, correction, amin, finished, gen_cfg)
        pending = torch.where(finished, pad, correction)
        a, done = (int(v) for v in torch.stack([amin, finished.all().to(amin.dtype)]).tolist())
        out[:, n_emitted : n_emitted + gamma + 1] = emit
        _trim(t_cache, t_cache["index"] - gamma + a)
        n_emitted += a + 1
        iters += 1
    if return_stats:
        return out[:, :max_new], (min(n_emitted, max_new), iters)
    return out[:, :max_new]
