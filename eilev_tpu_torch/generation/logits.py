"""Sampling warpers, logits processors and token selection (counterpart of
``eilev_tpu/generation/decoding.py:39-330``).

Each function keeps its JAX name and HF's semantics: the warper chain in
HF's ``_get_logits_processor`` order with ``min_keep`` (2 under beam
sampling), and the fixed-shape processors over a pad-filled history of
which the first ``n_valid`` positions are real. The decoding loops here are
driven from the host, so ``n_valid`` and ``n_generated`` are Python ints:
no processor reads a device value back.

Sampling is Gumbel-max: ``argmax(warped + g)`` with ``g`` standard Gumbel
noise of the logits' shape, which is the law of ``jax.random.categorical``
(and of a multinomial draw). The noise comes from a callable the loops
receive (:func:`gumbel_noise` over a ``torch.Generator``), so a test can
replay JAX's own draws; the port's stream differs from JAX's ``PRNGKey``
stream, the output law is the same.

Every place JAX calls ``jax.lax.top_k`` the port calls :func:`_top_k`, a
stable descending sort, so ties go to the lowest index as they do in
``lax.top_k`` (``torch.topk`` promises no tie order).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .config import GenerationConfig

#: ``noise(like) -> Tensor``: standard Gumbel noise of ``like``'s shape,
#: dtype and device
Noise = Callable[[torch.Tensor], torch.Tensor]


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values, best
    first, ties broken lowest index first."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def gumbel_noise(generator: torch.Generator) -> Noise:
    """A noise callable drawing from ``generator``: ``-log(-log(u))`` with u
    uniform in [tiny, 1), drawn in fp32 on the generator's device, so no draw
    is infinite."""

    def noise(like: torch.Tensor) -> torch.Tensor:
        u = torch.rand(like.shape, generator=generator, device=generator.device, dtype=torch.float32)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return (-torch.log(-torch.log(u))).to(device=like.device, dtype=like.dtype)

    return noise


def _filter_top_k(logits: torch.Tensor, k: int, min_keep: int = 1) -> torch.Tensor:
    k = max(k, min_keep) if k > 0 else k  # HF TopKLogitsWarper: max(top_k, min_tokens_to_keep)
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = _top_k(logits, k)[0][..., -1:]
    return torch.where(logits < kth, torch.finfo(logits.dtype).min, logits)


def _filter_top_p(logits: torch.Tensor, p: float, min_keep: int = 1) -> torch.Tensor:
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens until the cumulative prob exceeds p; always the top min_keep
    keep_sorted = (cum - probs) < p
    if min_keep > 1:
        keep_sorted[..., :min_keep] = True
    kth = torch.where(keep_sorted, sorted_logits, torch.finfo(logits.dtype).max)
    threshold = kth.min(dim=-1, keepdim=True).values
    return torch.where(logits < threshold, torch.finfo(logits.dtype).min, logits)


def _keep_top(logits: torch.Tensor, remove: torch.Tensor, min_keep: int) -> torch.Tensor:
    """Un-remove the ``min_keep`` highest-scoring tokens (HF's
    ``min_tokens_to_keep`` guard in the Epsilon/Eta/MinP warpers)."""
    kth = _top_k(logits, min(min_keep, logits.shape[-1]))[0][..., -1:]
    return remove & (logits < kth)


def _filter_min_p(logits: torch.Tensor, min_p: float, min_keep: int = 1) -> torch.Tensor:
    """HF MinPLogitsWarper: drop tokens whose prob < min_p * max_prob."""
    if min_p <= 0.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    top = probs.max(dim=-1, keepdim=True).values
    remove = _keep_top(logits, probs < min_p * top, min_keep)
    return logits.masked_fill(remove, -torch.inf)


def _entropy(normalized: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    return -torch.where(probs > 0, normalized * probs, 0.0).sum(dim=-1, keepdim=True)


def _filter_typical(logits: torch.Tensor, mass: float, min_keep: int = 1) -> torch.Tensor:
    """HF TypicalLogitsWarper: keep the smallest set of tokens closest (in
    |surprisal - entropy|) whose cumulative prob reaches ``mass``."""
    if mass >= 1.0:
        return logits
    normalized = torch.log_softmax(logits, dim=-1)
    shifted = (-normalized - _entropy(normalized, normalized.exp())).abs()
    order = torch.argsort(shifted, dim=-1, stable=True)  # ascending, like jnp.argsort
    sorted_shifted = shifted.gather(-1, order)
    sorted_logits = logits.gather(-1, order)
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    last_ind = (cum < mass).sum(dim=-1, keepdim=True).clamp(0, logits.shape[-1] - 1)
    cutoff = sorted_shifted.gather(-1, last_ind)
    sorted_remove = sorted_shifted > cutoff
    if min_keep >= 1:
        sorted_remove[..., :min_keep] = False
    # back through the inverse permutation
    remove = sorted_remove.gather(-1, torch.argsort(order, dim=-1))
    return logits.masked_fill(remove, -torch.inf)


def _filter_epsilon(logits: torch.Tensor, epsilon: float, min_keep: int = 1) -> torch.Tensor:
    """HF EpsilonLogitsWarper: drop tokens with prob < epsilon."""
    if epsilon <= 0.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    remove = _keep_top(logits, probs < epsilon, min_keep)
    return logits.masked_fill(remove, -torch.inf)


def _filter_eta(logits: torch.Tensor, epsilon: float, min_keep: int = 1) -> torch.Tensor:
    """HF EtaLogitsWarper: adaptive cutoff min(eps, sqrt(eps)*exp(-entropy))."""
    if epsilon <= 0.0:
        return logits
    normalized = torch.log_softmax(logits, dim=-1)
    probs = normalized.exp()
    root = torch.sqrt(torch.tensor(epsilon, dtype=torch.float32, device=logits.device))  # fp32, as JAX
    eta = torch.clamp(root * torch.exp(-_entropy(normalized, probs)), max=epsilon)
    remove = _keep_top(logits, probs < eta, min_keep)
    return logits.masked_fill(remove, -torch.inf)


def _warp_logits(x: torch.Tensor, cfg: GenerationConfig, min_keep: int = 1) -> torch.Tensor:
    """The HF sampling-warper chain in ``_get_logits_processor`` order:
    temperature -> top_k -> top_p -> min_p -> typical_p -> epsilon -> eta."""
    x = x / max(cfg.temperature, 1e-6)
    x = _filter_top_k(x, cfg.top_k, min_keep)
    x = _filter_top_p(x, cfg.top_p, min_keep)
    x = _filter_min_p(x, cfg.min_p, min_keep)
    x = _filter_typical(x, cfg.typical_p, min_keep)
    x = _filter_epsilon(x, cfg.epsilon_cutoff, min_keep)
    x = _filter_eta(x, cfg.eta_cutoff, min_keep)
    return x


def _select_token(logits: torch.Tensor, cfg: GenerationConfig, noise: Optional[Noise]) -> torch.Tensor:
    """Greedy argmax, or with ``cfg.do_sample`` the Gumbel-max draw
    ``argmax(warped + noise(warped))``: the law of ``jax.random.categorical``."""
    if not cfg.do_sample:
        return torch.argmax(logits, dim=-1)
    warped = _warp_logits(logits, cfg)
    return torch.argmax(noise(warped) + warped, dim=-1)


def _tail_matches(history: torch.Tensor, n_valid: int, prefix: tuple) -> Optional[torch.Tensor]:
    """(N,) whether the last ``len(prefix)`` of the first ``n_valid`` history
    tokens equal ``prefix`` (None when fewer than ``len(prefix) + 1`` are
    real: HF skips a sequence longer than its visible input_ids)."""
    m = len(prefix) + 1
    if n_valid < m:
        return None
    tail = history[:, n_valid - len(prefix) : n_valid]
    return (tail == torch.as_tensor(prefix, device=history.device)).all(dim=1)


def _process_scores(
    scores: torch.Tensor,
    cfg: GenerationConfig,
    history: torch.Tensor,
    n_valid: int,
    n_generated: int,
) -> torch.Tensor:
    """Fixed-shape HF logits processors, in HF's application order:
    SequenceBias -> RepetitionPenalty -> NoRepeatNGram -> NoBadWords ->
    MinNewTokensLength -> ForcedBOS -> ForcedEOS -> InfNanRemove ->
    ExponentialDecayLengthPenalty -> SuppressTokens -> SuppressTokensAtBegin
    -> LogitNormalization (last).

    ``scores``: (N, V) raw logits (greedy/sampling) or log-probs (beam).
    ``history``: (N, L) the ids HF would see as ``input_ids`` (the generated
    tokens: the decoder-only path starts from inputs_embeds), left-aligned
    with the first ``n_valid`` positions real. ``n_generated`` counts truly
    generated tokens. Returns a new tensor; ``scores`` is not written.
    """
    n, v = scores.shape
    length = history.shape[1]
    scores = scores.clone()

    if cfg.sequence_bias:
        # HF SequenceBiasLogitsProcessor: add bias to seq[-1] when the
        # generated tail equals seq[:-1]; length-1 sequences biased always
        for seq, bias in cfg.sequence_bias:
            m = len(seq)
            if m == 0:
                continue
            if m == 1:
                scores[:, seq[0]] += bias
                continue
            if m - 1 > length:
                continue
            hit = _tail_matches(history, n_valid, tuple(seq[:-1]))
            if hit is not None:
                scores[:, seq[-1]] += torch.where(hit, bias, 0.0).to(scores.dtype)

    if cfg.repetition_penalty != 1.0:
        # HF RepetitionPenaltyLogitsProcessor over the tokens seen so far
        pen_mask = torch.zeros(n, v, dtype=torch.bool, device=scores.device)
        pen_mask.scatter_(1, history[:, :n_valid], True)
        penalized = torch.where(
            scores < 0, scores * cfg.repetition_penalty, scores / cfg.repetition_penalty
        )
        scores = torch.where(pen_mask, penalized, scores)

    ngram = cfg.no_repeat_ngram_size
    if ngram > 0 and length >= ngram and n_valid + 1 >= ngram:
        # HF NoRepeatNGramLogitsProcessor: ban the completion of any history
        # n-gram whose first n-1 tokens equal the last n-1 emitted
        nwin = n_valid - ngram + 1  # full n-grams inside the valid history
        if nwin > 0:
            last = history[:, n_valid - (ngram - 1) : n_valid]
            match = torch.ones(n, nwin, dtype=torch.bool, device=scores.device)
            for k in range(ngram - 1):
                match &= history[:, k : k + nwin] == last[:, k : k + 1]
            banned_ids = history[:, ngram - 1 : ngram - 1 + nwin]
            hits = torch.zeros(n, v, dtype=torch.int32, device=scores.device)
            hits.scatter_add_(1, banned_ids, match.to(torch.int32))
            scores = scores.masked_fill(hits > 0, -torch.inf)

    if cfg.bad_words_ids:
        # HF NoBadWordsLogitsProcessor: ban the last token of each bad word
        # when the generated tail matches its prefix; single-token words
        # always. HF drops words equal to a lone eos token.
        for word in cfg.bad_words_ids:
            m = len(word)
            if m == 0 or (m == 1 and cfg.eos_token_id and word[0] in cfg.eos_token_id):
                continue
            if m == 1:
                scores[:, word[0]] = -torch.inf
                continue
            if m - 1 > length:
                continue
            hit = _tail_matches(history, n_valid, tuple(word[:-1]))
            if hit is not None:
                scores[:, word[-1]] = scores[:, word[-1]].masked_fill(hit, -torch.inf)

    if cfg.min_new_tokens > 0 and cfg.eos_token_id and n_generated < cfg.min_new_tokens:
        for e in cfg.eos_token_id:
            scores[:, e] = -torch.inf

    if cfg.forced_bos_token_id is not None and n_valid == 1:
        # HF ForcedBOSTokenLogitsProcessor fires when cur_len == 1
        scores = torch.full_like(scores, -torch.inf)
        scores[:, cfg.forced_bos_token_id] = 0.0

    if cfg.forced_eos_token_id is not None and n_generated == cfg.max_new_tokens - 1:
        # HF ForcedEOSTokenLogitsProcessor: the final token of the budget
        scores = torch.full_like(scores, -torch.inf)
        for e in cfg.forced_eos_token_id:
            scores[:, e] = 0.0

    if cfg.remove_invalid_values:
        # HF InfNanRemoveLogitsProcessor: nan -> 0, +/-inf -> finfo max/min
        finfo = torch.finfo(scores.dtype)
        scores = torch.nan_to_num(scores, nan=0.0, posinf=finfo.max, neginf=finfo.min)

    if cfg.exponential_decay_length_penalty is not None and cfg.eos_token_id:
        # HF ExponentialDecayLengthPenalty: boost eos by |score| * (factor^i - 1)
        # once i = n_generated - start_index > 0, in fp32 as JAX computes it
        start_idx, factor = cfg.exponential_decay_length_penalty
        pidx = n_generated - start_idx
        if pidx > 0:
            f32 = dict(dtype=torch.float32, device=scores.device)
            mult = torch.pow(torch.tensor(factor, **f32), torch.tensor(float(pidx), **f32)) - 1.0
            for e in cfg.eos_token_id:
                col = scores[:, e].float()
                scores[:, e] = (col + col.abs() * mult).to(scores.dtype)

    if cfg.suppress_tokens:
        for t in cfg.suppress_tokens:
            scores[:, t] = -torch.inf

    if cfg.begin_suppress_tokens and n_generated == 0:
        # HF SuppressTokensAtBeginLogitsProcessor: the first generated position
        for t in cfg.begin_suppress_tokens:
            scores[:, t] = -torch.inf

    if cfg.renormalize_logits:
        # HF LogitNormalization, always last
        scores = torch.log_softmax(scores, dim=-1)
    return scores


def _token_in_set(tokens: torch.Tensor, ids: tuple) -> torch.Tensor:
    hit = torch.zeros(tokens.shape, dtype=torch.bool, device=tokens.device)
    for e in ids:
        hit |= tokens == e
    return hit
