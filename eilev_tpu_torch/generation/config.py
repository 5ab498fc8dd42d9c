"""Generation configuration (a copy of ``eilev_tpu/generation/config.py``; frozen
and hashable, so one config drives both packages)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class GenerationConfig:
    """Decoding knobs, mirroring the subset of HF ``GenerationConfig`` the
    reference exercises (greedy, sampling with temperature/top-k/top-p, beam
    search with length_penalty - see reference
    ``samples/eilev_generate_action_narration.py:60-75`` and
    ``tests/model/test_model_v2.py:189-295``). ``do_sample`` with
    ``num_beams > 1`` runs HF ``beam_sample`` semantics (warped multinomial
    candidate draw, expressed as Gumbel top-k in decoding._beam_engine)."""

    max_new_tokens: int = 32
    num_beams: int = 1
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 50
    top_p: float = 1.0
    length_penalty: float = 1.0
    early_stopping: bool = False
    # eos may be a tuple (HF allows a list; the EILeV demo uses OPT newline 50118
    # as eos - reference demo/eilev_demo.py:61-65)
    eos_token_id: Optional[tuple[int, ...]] = None
    pad_token_id: int = 1
    # HF logits-processor knobs (the reference CLI forwards arbitrary
    # GenerationConfig JSON to HF generate - reference
    # scripts/general/generate_narration_texts.py:203):
    # RepetitionPenaltyLogitsProcessor / NoRepeatNGramLogitsProcessor /
    # MinNewTokensLengthLogitsProcessor semantics, implemented fixed-shape in
    # generation/decoding.py:_process_scores.
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
    min_new_tokens: int = 0
    # HF ``num_return_sequences``: >1 returns that many sequences per input row
    # (interleaved, like HF). Sampling tiles the KV cache after ONE prefill
    # (cheaper than HF's repeat_interleave-then-prefill); beam search returns
    # the top-n finished hypotheses (requires num_return_sequences <= num_beams,
    # the HF contract). Greedy requires 1, as in HF.
    num_return_sequences: int = 1
    # Remaining HF sampling warpers (applied after temperature/top_k/top_p in
    # HF's _get_logits_processor order: min_p -> typical_p -> epsilon ->
    # eta), implemented fixed-shape in decoding._warp_logits and verified
    # logits-identical vs the HF warper classes
    # (tests/generation/test_logits_processors.py).
    min_p: float = 0.0
    typical_p: float = 1.0
    epsilon_cutoff: float = 0.0
    eta_cutoff: float = 0.0
    # HF token-constraint processors (decoding._process_scores, HF order):
    # NoBadWords (ban word[-1] when the generated tail matches word[:-1];
    # single-token words banned everywhere), Forced BOS/EOS, Suppress /
    # SuppressAtBegin. ``min_length``/``max_length`` are accepted as JSON and
    # translated to min_new/max_new at the generate() boundary (the engines
    # see generated-token counts, matching HF's inputs_embeds-driven path the
    # reference uses - v2.py:254-324).
    bad_words_ids: Optional[tuple[tuple[int, ...], ...]] = None
    forced_bos_token_id: Optional[int] = None
    forced_eos_token_id: Optional[tuple[int, ...]] = None
    suppress_tokens: Optional[tuple[int, ...]] = None
    begin_suppress_tokens: Optional[tuple[int, ...]] = None
    min_length: int = 0
    max_length: Optional[int] = None
    # HF SequenceBiasLogitsProcessor: ((token_ids, bias), ...) — the bias is
    # added to the last token of each sequence when the generated tail matches
    # its prefix (single-token sequences biased unconditionally). Applied
    # FIRST, like HF's _get_logits_processor order.
    sequence_bias: Optional[tuple[tuple[tuple[int, ...], float], ...]] = None
    # HF ExponentialDecayLengthPenalty: (start_index, decay_factor) — boosts
    # every eos score by |score| * (factor^(n_generated - start) - 1) once
    # n_generated exceeds start (start counts generated tokens, matching HF's
    # regulation_start = start + input_ids_seq_length on the inputs_embeds
    # path the reference drives, where input_ids_seq_length is the HF-visible
    # start length already excluded from n_generated).
    exponential_decay_length_penalty: Optional[tuple[int, float]] = None
    # HF InfNanRemoveLogitsProcessor: nan -> 0, +/-inf -> finfo max/min.
    remove_invalid_values: bool = False
    # HF LogitNormalization: log-softmax as the LAST processor. Only
    # observable in beam search (the scores feed cumulative hypothesis
    # comparison there); for greedy/sampling both argmax and categorical are
    # shift-invariant, exactly as in HF.
    renormalize_logits: bool = False
    # HF contrastive search (penalty_alpha > 0 and top_k > 1 with
    # num_beams == 1 and do_sample=False, exactly HF's mode selection):
    # score = (1 - alpha) * p(candidate) - alpha * max cossim(candidate
    # hidden, context hiddens). Fixed-shape implementation in
    # decoding._contrastive_decoder_only; any other mode ignores it, as HF
    # does.
    penalty_alpha: float = 0.0
    # HF group (diverse) beam search: num_beams splits into num_beam_groups
    # groups of num_beams/num_beam_groups processed sequentially per step;
    # group g's log-probs are penalized diversity_penalty * (frequency of
    # each token among groups 0..g-1's selections this step). Removed from
    # transformers 4.57's GenerationMixin; semantics reconstructed from the
    # still-in-tree BeamSearchScorer + HammingDiversityLogitsProcessor and
    # verified against a torch oracle on the reference forward
    # (decoding._beam_engine handles G groups natively; do_sample is
    # rejected, as HF does for diverse beam search).
    num_beam_groups: int = 1
    diversity_penalty: float = 0.0

    @property
    def has_logits_processors(self) -> bool:
        """Knobs needing the full generated history (or a step counter) per
        step — the decode loops route through _process_scores when set."""
        return (
            self.repetition_penalty != 1.0
            or self.no_repeat_ngram_size > 0
            or self.min_new_tokens > 0
            or bool(self.bad_words_ids)
            or self.forced_bos_token_id is not None
            or self.forced_eos_token_id is not None
            or bool(self.suppress_tokens)
            or bool(self.begin_suppress_tokens)
            or bool(self.sequence_bias)
            or self.exponential_decay_length_penalty is not None
            or self.remove_invalid_values
            or self.renormalize_logits
        )

    def with_eos(self, eos) -> "GenerationConfig":
        import dataclasses

        if eos is None:
            return self
        if isinstance(eos, int):
            eos = (eos,)
        return dataclasses.replace(self, eos_token_id=tuple(eos))


#: JSON keys accepted by :func:`generation_config_from_json`, mapped to
#: GenerationConfig fields (None = handled specially).
_SUPPORTED_JSON_KEYS = {
    "max_new_tokens": "max_new_tokens",
    "num_beams": "num_beams",
    "do_sample": "do_sample",
    "temperature": "temperature",
    "top_k": "top_k",
    "top_p": "top_p",
    "length_penalty": "length_penalty",
    "early_stopping": "early_stopping",
    "eos_token_id": None,
    "pad_token_id": "pad_token_id",
    "repetition_penalty": "repetition_penalty",
    "no_repeat_ngram_size": "no_repeat_ngram_size",
    "min_new_tokens": "min_new_tokens",
    "num_return_sequences": "num_return_sequences",
    "min_p": "min_p",
    "typical_p": "typical_p",
    "epsilon_cutoff": "epsilon_cutoff",
    "eta_cutoff": "eta_cutoff",
    "bad_words_ids": "bad_words_ids",
    "forced_bos_token_id": "forced_bos_token_id",
    "forced_eos_token_id": "forced_eos_token_id",
    "suppress_tokens": "suppress_tokens",
    "begin_suppress_tokens": "begin_suppress_tokens",
    "min_length": "min_length",
    "max_length": "max_length",
    "sequence_bias": "sequence_bias",
    "exponential_decay_length_penalty": "exponential_decay_length_penalty",
    "remove_invalid_values": "remove_invalid_values",
    "renormalize_logits": "renormalize_logits",
    "penalty_alpha": "penalty_alpha",
    "num_beam_groups": "num_beam_groups",
    "diversity_penalty": "diversity_penalty",
    # Accepted for parity with HF's behavior on the inputs_embeds path the
    # reference drives (v2.py:318-322 passes no input_ids to LM generate):
    # HF builds EncoderRepetitionPenalty/EncoderNoRepeatNGram from the
    # HF-visible input_ids, which are EMPTY for decoder-only models there
    # (functional no-op) and warned-and-ignored for seq2seq (3-D
    # inputs_tensor) — transformers/generation/utils.py:1124-1161. We mirror
    # that: warn and drop.
    "encoder_repetition_penalty": None,
    "encoder_no_repeat_ngram_size": None,
}

#: JSON keys whose list values must become (hashable) tuples so the frozen
#: config can be a jit static argument.
_TUPLE_KEYS = {"suppress_tokens", "begin_suppress_tokens", "forced_eos_token_id"}

#: Keys silently accepted because our engines already implement their HF
#: default behavior unconditionally (passing the default is a no-op in HF too).
_IGNORED_JSON_KEYS = {"use_cache", "bos_token_id", "_from_model_config", "transformers_version"}


def generation_config_from_json(
    gen_json: dict,
    *,
    pad_token_id: int,
    default_max_new_tokens: int = 512,
) -> GenerationConfig:
    """Build a :class:`GenerationConfig` from an HF ``GenerationConfig``-style
    JSON dict (the reference CLI contract - its ``--generation_config`` flag is
    forwarded verbatim to HF ``generate``, reference
    ``scripts/general/generate_narration_texts.py:203``).

    Unknown or unsupported keys raise ``ValueError`` listing the supported set
    instead of dying as a bare ``TypeError`` downstream.
    """
    known_unsupported = {
        "force_words_ids",
        "guidance_scale",
        "low_memory",
        "constraints",
        "max_time",
        "stop_strings",
    }
    kwargs: dict = {"pad_token_id": pad_token_id}
    eos = None
    for key, value in gen_json.items():
        if key in _IGNORED_JSON_KEYS:
            continue
        if key not in _SUPPORTED_JSON_KEYS:
            supported = ", ".join(sorted(_SUPPORTED_JSON_KEYS))
            hint = (
                "not implemented by the decode engines"
                if key in known_unsupported
                else "not a recognized HF GenerationConfig key"
            )
            raise ValueError(
                f"generation_config key {key!r} is {hint}; supported keys: "
                f"{supported}"
            )
        if key == "eos_token_id":
            eos = value
            continue
        if key in ("encoder_repetition_penalty", "encoder_no_repeat_ngram_size"):
            # HF itself cannot apply these on the reference's inputs_embeds
            # path: decoder-only models there expose EMPTY input_ids (the
            # processor gathers/scatters nothing) and seq2seq models a 3-D
            # inputs_tensor (HF warns and drops the processor) — see
            # _SUPPORTED_JSON_KEYS. Mirror the warn-and-ignore.
            if value is not None and value != (1.0 if key == "encoder_repetition_penalty" else 0):
                import warnings

                warnings.warn(
                    f"Passing `{key}` requires some form of `input_ids` to be "
                    "passed to `generate`; the reference drives generation via "
                    "inputs_embeds, where HF ignores it too — ignoring.",
                    UserWarning,
                    stacklevel=2,
                )
            continue
        if key in _TUPLE_KEYS and value is not None:
            value = (value,) if isinstance(value, int) else tuple(value)
        elif key == "bad_words_ids" and value is not None:
            value = tuple(tuple(word) for word in value)
        elif key == "sequence_bias" and value is not None:
            # HF JSON list format: [[[token_ids...], bias], ...]
            value = tuple((tuple(seq), float(bias)) for seq, bias in value)
        elif key == "exponential_decay_length_penalty" and value is not None:
            value = (int(value[0]), float(value[1]))
        elif key == "penalty_alpha":
            # HF default is null (off); our dataclass encodes off as 0.0
            value = 0.0 if value is None else float(value)
        kwargs[_SUPPORTED_JSON_KEYS[key]] = value
    if kwargs.get("max_length") is not None:
        if "max_new_tokens" in kwargs:
            # HF: max_new_tokens takes precedence when both are given
            kwargs["max_length"] = None
        else:
            # placeholder budget; generate() retranslates via _resolve_lengths
            # with the model family's HF-visible start length
            kwargs.setdefault("max_new_tokens", kwargs["max_length"])
    kwargs.setdefault("max_new_tokens", default_max_new_tokens)
    return GenerationConfig(**kwargs).with_eos(eos)
