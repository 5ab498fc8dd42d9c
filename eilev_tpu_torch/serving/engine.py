"""Continuous-batching serving engine (counterpart of ``eilev_tpu/serving/engine.py``).

Requests arrive at any time, join a running batch at chunk boundaries and
leave on their own. The engine owns one preallocated KV cache of
``max_slots`` rows and schedules as the JAX engine does:

  - **Chunked decode.** Every active slot advances ``chunk_tokens`` tokens a
    step through ``generation/decoding._decode_chunk`` (one-token forwards
    over the stacked cache: kernel K3, or K4 for an int8 cache); the host
    reads the (slots, chunk) tokens and the finished flags back in ONE copy
    a chunk. Admission happens between chunks.
  - **Left-padded admission.** A request prefills alone at width ``W =
    bucket(max(cache index, prompt length))``, left-padded so that its last
    token sits at the shared index, straight into its slot's rows of the
    shared cache (the forward writes a (layers, 1, max_len, ...) view of the
    slot: kernel K2 over one left-padded row; no row cache is allocated);
    the slot's slots past W are zeroed, as JAX's fresh row cache has them.
  - **Slot reuse and rolling compaction.** A finished slot is overwritten by
    the next admission. When the shared index cannot fit another request,
    the cache is shifted left in place by the dead prefix ahead of every
    live row (the min live start), one layer at a time (``torch.roll`` of a
    layer), the mask zeroed past the new index, ``pos`` left alone; an
    empty engine whose queue is blocked resets instead.
  - **Speculative serving** (``speculative="prompt_lookup"``): each slot
    drafts from its own prompt + emitted corpus, one verify pass
    (``cache_append``, plain attention under a (slots, 1, S, L) bias, as
    JAX's XLA path) checks every row's drafts, and each row advances by its
    OWN acceptance; rejected drafts become mask holes in the row's window
    and ``pos`` rolls back per row. Greedy is token-identical to isolated
    greedy ``generate``; sampling (Leviathan/Chen for the point-mass lookup
    draft) keeps the output law. Cache pressure: compact, then plain
    chunked decode, then evict the row pinning the compaction and recompute
    it from [prompt + emitted] (OPT), or rebuild it in place by replaying
    its decoder tokens (T5), or one full defrag (T5).
  - **T5.** Prompts live in per-slot cross K/V buffers (``max_prompt_len``
    wide, right-padded): admission is one encoder pass and a row splice; the
    shared self cache holds decoder tokens only, with a per-row attendable
    mask (``models/t5.py``), so K5's bias form runs the decoder's self and
    cross steps under ``flash``.

Sampling draws from one ``torch.Generator`` on the model's device (the JAX
engine's ``rng``): the output law is JAX's, the stream is not. The host
reads the mask where JAX does (compaction and eviction), the tokens once a
chunk, and, in speculative mode, the emitted counts with them.

**Tensor parallelism.** On a model built with ``tp`` (``parallel/tensor.py``)
every rank of the model group runs its own engine on the same requests,
submitted in the same order; the caches hold the rank's heads (the OPT and
LLaMA shared cache, T5's self cache and per-slot cross K/V). There is no
GSPMD to keep the ranks together, so every host decision (admission and slot
choice, compaction, eviction and defrag, the harvest, the speculative
acceptance counts) must come out the same on every rank, or the ranks'
collectives part and the group hangs. They do, because they read only the
logits, which ``gather_vocab`` gives every rank byte for byte, the mask, and
draws from the generator, which must be seeded alike on every rank (the
default, seed 0, is; the engine checks it with one all_reduce at
construction). A ``VideoFeatureCache`` beside it encodes the same misses in
the same LRU order on every rank.

Every LM serving mode of the port runs here: bf16, fp32, ``int8_lm``,
``int8_kv`` (the cache carries ``k_scale``/``v_scale``, which admission,
compaction and the zeroing treat as k and v), ``int8_vision`` and
``w8a8_prefill``. A bf16 OPT request whose admission is left-padded comes out
all token 0: the reference's mask value is -inf in bf16, so its fully masked
padded query rows are NaN and poison the row (ROADMAP Queue 3); this port
keeps that behaviour, as the JAX engine has it. Likewise a bf16 T5 request
admitted into a slot that decoded while empty (its all-zero encoder mask
fully masks the cross attention) can decode from NaN on the plain attention
path, as in JAX; K5 under ``flash`` gives such a row 0 instead.
"""

from __future__ import annotations

import dataclasses
import zlib
from collections import deque
from typing import TYPE_CHECKING, Callable, Hashable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..configs import OPTConfig, T5Config
from ..generation.config import GenerationConfig
from ..generation.decoding import _decode_chunk, _is_eos, _seeded_generator
from ..generation.logits import _select_token, _warp_logits, gumbel_noise
from ..generation.speculative import lookup_drafts_rows
from ..models.opt import init_cache
from ..models.video_blip import embed_and_scatter_chunked

if TYPE_CHECKING:
    from .feature_cache import VideoFeatureCache

#: cache entries laid out (layers, slots, max_len, ...): admission writes
#: them, compaction rolls them along their slot axis
_SLOT_BUFFERS = ("k", "v", "k_scale", "v_scale")


@dataclasses.dataclass
class Request:
    """One narration request: the interleaved prompt arrays of ``generate``."""

    input_ids: np.ndarray  # (P,) int
    pixel_values: Optional[np.ndarray]  # (V, C, T, H, W) or None (text-only)
    video_input_mask: Optional[np.ndarray]  # (P,) 0/1
    rid: int = -1
    # per-video identities (len V, e.g. frame_paths) for the engine's optional
    # VideoFeatureCache; ignored when the engine has no cache
    feature_keys: Optional[Sequence[Hashable]] = None
    # extra reference tokens for the speculative lookup corpus (e.g. the
    # in-context example narrations): only the matcher sees them. Truncated
    # to the engine's ``spec_extra_corpus`` budget; ignored without
    # speculation
    extra_corpus: Optional[np.ndarray] = None


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray  # (max_new_tokens,) int32; positions after eos hold pad
    admitted_at_chunk: int
    finished_at_chunk: int


def _write_rows(buf: torch.Tensor, tile: torch.Tensor, start: torch.Tensor) -> None:
    """``buf[r, start[r] : start[r] + w] = tile[r]`` for every row, in place;
    each start clamped so the tile fits (``jax.lax.dynamic_update_slice``)."""
    w = tile.shape[1]
    at = start.to(torch.int64).clamp(0, buf.shape[1] - w)
    buf.scatter_(1, at[:, None] + torch.arange(w, device=buf.device)[None, :], tile.to(buf.dtype))


def _accept_count(agree: torch.Tensor) -> torch.Tensor:
    """Each row's accepted prefix length: the leading run of ``agree``."""
    return torch.cumprod(agree.to(torch.int64), dim=1).sum(dim=1)


def _emissions(block, a_row, active, gen_cfg: GenerationConfig):
    """The tokens a pass emits: ``block[:, :a+1]`` per active row, capped at
    its first eos, pad after. Returns (emit, n_emit, eos_in_window)."""
    pad = gen_cfg.pad_token_id
    gp1 = block.shape[1]
    col = torch.arange(gp1, device=block.device)[None, :]
    valid = (col <= a_row[:, None]) & active[:, None]
    hits = _is_eos(block, gen_cfg) & valid
    first_eos = torch.where(hits, col, gp1).min(dim=1).values
    n_emit = torch.where(active, torch.minimum(a_row, first_eos) + 1, 0)
    emit = torch.where(col < n_emit[:, None], block, pad)
    return emit, n_emit, first_eos <= a_row


def _punch_holes(cache: dict, gamma: int, a_row: torch.Tensor, active: torch.Tensor) -> None:
    """Zero each active row's rejected suffix of the pass just appended: the
    slots [index0 + a + 1, index0 + gamma + 1) of the gamma + 1 written, in
    place. Rows that appended with mask 0 wrote zeros there already."""
    index0 = cache["index"] - (gamma + 1)
    mask = cache["mask"]
    slot = torch.arange(index0, index0 + gamma + 1, device=mask.device)[None, :]
    reject = (slot >= index0 + a_row[:, None] + 1) & active[:, None]
    window = mask[:, index0 : index0 + gamma + 1]
    window.masked_fill_(reject, 0)


def _residual_draw(x, a_row, drafts, gamma: int, noise):
    """The correction token of speculative sampling: a draw from the warped
    ``x`` (slots, gamma + 1, V) at each row's first rejected position with
    the rejected draft removed, or from the bonus position unmasked after
    full acceptance."""
    slots, _, vocab = x.shape
    x_sel = x.gather(1, a_row.view(slots, 1, 1).expand(slots, 1, vocab))[:, 0]
    if gamma > 0:
        d_sel = drafts.gather(1, a_row.clamp(max=gamma - 1)[:, None])[:, 0]
        vocab_iota = torch.arange(vocab, device=x.device)[None, :]
        x_sel = torch.where((a_row < gamma)[:, None] & (vocab_iota == d_sel[:, None]),
                            torch.finfo(x_sel.dtype).min, x_sel)
    return (x_sel + noise(x_sel)).argmax(dim=-1)


def _check_shared_generator(generator: torch.Generator, tp) -> None:
    """Raise ``ValueError`` unless every rank of the model group holds a
    generator in the same state (one all_reduce MAX of a hash of it and of
    its negation): the ranks draw the sampling noise and the speculative
    acceptance from it, and must draw alike."""
    h = zlib.crc32(generator.get_state().numpy().tobytes())
    both = torch.tensor([h, -h], dtype=torch.int64, device=generator.device)
    tp.all_reduce(both, dist.ReduceOp.MAX)
    if int(both[0]) != -int(both[1]):
        raise ValueError("the ranks of the model group hold generators in different states: seed one alike on "
                         "every rank (torch.Generator(device=...).manual_seed(seed), the seed shared)")


def _compact_cache(cache: dict, delta: int) -> None:
    """Shift the shared cache left by ``delta`` slots, in place: every live
    window ends at ``cache['index']``, so the shift is uniform. Buffers roll
    one layer at a time (``torch.roll`` of a (slots, max_len, ...) layer,
    never the whole cache); slots at and past the new index keep the
    rolled-in values, which the zeroed mask gates out and later writes
    overwrite. ``pos`` counts attended tokens, not slots: unchanged."""
    new_index = cache["index"] - delta
    for key in _SLOT_BUFFERS:
        if key in cache:
            buf = cache[key]
            for layer in range(buf.shape[0]):
                buf[layer] = torch.roll(buf[layer], -delta, dims=1)
    mask = cache["mask"]
    mask.copy_(torch.roll(mask, -delta, dims=1))
    mask[:, new_index:] = 0
    cache["index"] = new_index


class ContinuousBatchingEngine:
    """Iteration-level scheduler over ``max_slots`` concurrent narrations.

    Usage::

        eng = ContinuousBatchingEngine(model, gen_cfg, max_slots=4)
        rid = eng.submit(Request(input_ids, pixel_values, video_input_mask))
        while not eng.idle:
            for done in eng.step():       # admit + one decode chunk
                use(done.rid, done.tokens)

    Greedy (and sampled) decoding only: beam search decodes in lockstep and
    belongs to static batching. Output rows are token-identical to isolated
    ``generate`` calls for the same request (fp32; bf16 as the model's
    kernels give it). The engine runs on the model's device; ``generator``
    (default: one seeded with 0 on that device) feeds sampling. On a
    tensor-parallel model every rank of the model group builds its engine
    with a generator in the same state and submits the same requests in the
    same order (``ValueError`` at construction for generators that differ).
    """

    def __init__(
        self,
        model: nn.Module,
        generation_config: GenerationConfig,
        *,
        max_slots: int = 4,
        max_len: int = 2048,
        chunk_tokens: int = 8,
        prefill_bucket: int = 64,
        max_prompt_len: int = 2048,
        generator: Optional[torch.Generator] = None,
        vision_chunks: int = 1,
        feature_cache: Optional["VideoFeatureCache"] = None,
        feature_loader: Optional[Callable[[Hashable], np.ndarray]] = None,
        speculative: Optional[str] = None,
        spec_gamma: int = 8,
        spec_match_len: int = 3,
        spec_extra_corpus: int = 0,
        video_bucket: int = 0,
    ):
        if feature_loader is not None and feature_cache is None:
            raise ValueError("feature_loader requires feature_cache")
        tcfg = model.config.text_config
        self._is_t5 = isinstance(tcfg, T5Config)
        if not self._is_t5 and not isinstance(tcfg, OPTConfig) and not hasattr(tcfg, "num_key_value_heads"):
            raise ValueError("continuous batching supports decoder-only LMs and T5")
        if generation_config.has_logits_processors:
            raise NotImplementedError(
                "the serving engine's chunked decode does not implement "
                "repetition_penalty/no_repeat_ngram_size/min_new_tokens; "
                "use generate() for those knobs"
            )
        if (
            generation_config.penalty_alpha
            and generation_config.penalty_alpha > 0
            and generation_config.top_k > 1
            and not generation_config.do_sample
        ):
            raise NotImplementedError(
                "contrastive search (penalty_alpha) runs per-call in "
                "generate(); the engine's chunked decode is greedy/sampling"
            )
        if generation_config.max_length is not None or generation_config.min_length > 0:
            # generate() retranslates the HF total-length knobs per call; the
            # engine budgets one shared max_new_tokens across requests with
            # differing prompt lengths
            raise NotImplementedError(
                "the serving engine budgets new tokens per request; translate "
                "max_length/min_length to max_new_tokens/min_new_tokens "
                "yourself (HF semantics: subtract the prompt length) or use "
                "generate()"
            )
        if generation_config.num_return_sequences > 1:
            raise NotImplementedError(
                "the serving engine emits one sequence per request; submit the "
                "request num_return_sequences times (distinct generators) or use "
                "generate()"
            )
        if self._is_t5:
            # T5 prompts live in the per-slot cross buffers (max_prompt_len
            # wide); the shared self cache holds decoder tokens only
            if generation_config.max_new_tokens > max_len:
                raise ValueError(
                    f"max_len={max_len} cannot hold max_new_tokens={generation_config.max_new_tokens}"
                )
        elif generation_config.max_new_tokens + prefill_bucket > max_len:
            raise ValueError(
                f"max_len={max_len} cannot hold one prompt bucket "
                f"({prefill_bucket}) plus max_new_tokens "
                f"({generation_config.max_new_tokens})"
            )
        if speculative is not None and speculative != "prompt_lookup":
            raise ValueError(f"unknown speculative mode {speculative!r}; supported: 'prompt_lookup'")
        self.model = model
        if generation_config.eos_token_id is None:
            # mirror generate(): the model's eos terminates rows
            generation_config = generation_config.with_eos(tcfg.eos_token_id)
        self.gen_cfg = generation_config
        self._spec = speculative
        self.spec_gamma = spec_gamma
        self.spec_match_len = spec_match_len
        self.spec_extra_corpus = spec_extra_corpus
        self.max_prompt_len = max_prompt_len
        self.max_slots = max_slots
        self.max_len = max_len
        self.chunk_tokens = chunk_tokens
        self.prefill_bucket = prefill_bucket
        self.vision_chunks = vision_chunks
        #: > 0: encode each request's videos in fixed buckets of this many
        #: videos (the tail zero-padded), then scatter the features: the
        #: chat workload's variable video counts share one encode shape
        self.video_bucket = video_bucket
        self.feature_cache = feature_cache
        # lazy pixel supply: requests may omit pixel_values and the cache
        # fetches frames for its misses via feature_loader(key)
        self.feature_loader = feature_loader
        self._device = next(model.parameters()).device
        self._dtype = model.compute_dtype
        self._generator = _seeded_generator(generator, self._device)
        if getattr(model, "tp", None) is not None:
            _check_shared_generator(self._generator, model.tp)
        self._noise = gumbel_noise(self._generator)
        self._queue: deque[Request] = deque()
        self._next_rid = 0
        self._chunk_count = 0
        #: cache-pressure and speculation counters (the serve CLI reports
        #: them; spec_tokens / spec_rows = realised tokens a pass)
        self.stats = {
            "compactions": 0,
            "resets": 0,
            "spec_passes": 0,
            "spec_tokens": 0,
            "spec_rows": 0,
            "spec_fallback_chunks": 0,
            "evictions": 0,
            "defrags": 0,
        }
        # emissions carried across an eviction (rid -> tokens already
        # emitted), restored when the continuation request re-admits
        self._carry_emitted: dict[int, list[int]] = {}
        self._reset_state()

    # ------------------------------------------------------------------
    # public surface
    # ------------------------------------------------------------------

    def submit(self, request: Request) -> int:
        """Queue a request; returns its rid. Admission happens inside step()."""
        request = dataclasses.replace(request, rid=self._next_rid)
        self._next_rid += 1
        self._queue.append(request)
        return request.rid

    @property
    def idle(self) -> bool:
        return not self._queue and not any(self._active)

    def started(self) -> list[int]:
        """The rids of the active requests that have emitted a token (the
        serve CLI's time to first chunk)."""
        return [req.rid for req, got in zip(self._active, self._emitted) if req is not None and got]

    @torch.inference_mode()
    def step(self) -> list[Completion]:
        """Admit what fits, decode one chunk, harvest finished requests."""
        self._admit_pending()
        if not any(self._active):
            # nothing decoding: if admission was blocked by cache exhaustion,
            # flush the (empty) session and retry once: free, since nothing
            # live stalls
            if self._queue:
                self._reset_state()
                self.stats["resets"] += 1
                self._admit_pending()
            if not any(self._active):
                return []
        if self._spec is not None:
            return self._spec_step()
        if self._is_t5:
            self._finished, toks = self._decode_chunk_t5(self.chunk_tokens)
        else:
            self._logits, self._finished, toks = _decode_chunk(
                self.model, self._cache, self._logits, self._finished, self.gen_cfg, self._noise,
                self.chunk_tokens)
        self._chunk_count += 1
        return self._harvest(*self._readback(toks))

    def run(self, requests: list[Request]) -> dict[int, Completion]:
        """Submit every request and step until the engine drains."""
        rids = [self.submit(r) for r in requests]
        done: dict[int, Completion] = {}
        while not self.idle:
            for c in self.step():
                done[c.rid] = c
        return {rid: done[rid] for rid in rids}

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _readback(self, toks: torch.Tensor, n_emit: Optional[torch.Tensor] = None):
        """One host copy of the chunk's tokens, the finished flags and (in
        speculative mode) the emitted counts."""
        parts = [toks.flatten().to(torch.int64), self._finished.to(torch.int64)]
        if n_emit is not None:
            parts.append(n_emit.to(torch.int64))
        host = torch.cat(parts).cpu().numpy()
        n = toks.numel()
        toks_np = host[:n].reshape(toks.shape)
        finished = host[n : n + self.max_slots].astype(bool)
        n_valid = None if n_emit is None else host[n + self.max_slots :]
        return toks_np, finished, n_valid

    def _reset_state(self) -> None:
        tcfg = self.model.config.text_config
        dev = self._device
        if self._is_t5:
            lm_tp = self.model.language_model.tp  # the rank's heads under tensor parallelism
            heads = tcfg.num_heads // (lm_tp.size if lm_tp else 1)
            shape = (tcfg.num_decoder_layers, self.max_slots, self.max_len, heads, tcfg.d_kv)
            cross = (tcfg.num_decoder_layers, self.max_slots, self.max_prompt_len, heads, tcfg.d_kv)
            kw = dict(dtype=self._dtype, device=dev)
            self._cache = {
                "index": 0,
                "k": torch.zeros(shape, **kw),
                "v": torch.zeros(shape, **kw),
                "mask": torch.zeros(self.max_slots, self.max_len, dtype=torch.int32, device=dev),
                "cross_k": torch.zeros(cross, **kw),
                "cross_v": torch.zeros(cross, **kw),
            }
            self._enc_mask = torch.zeros(self.max_slots, self.max_prompt_len, dtype=torch.int32, device=dev)
            self._next_tok = torch.full((self.max_slots,), self.gen_cfg.pad_token_id, dtype=torch.int64,
                                        device=dev)
        else:
            self._cache = init_cache(tcfg, self.max_slots, self.max_len, dtype=self._dtype, device=dev,
                                     tp=getattr(self.model, "tp", None))
            self._logits = torch.zeros(self.max_slots, tcfg.vocab_size, dtype=self._dtype, device=dev)
        if self._spec is not None:
            if self._is_t5:
                # the prompt corpus lives beside (not inside) the decode window
                cl = self.max_prompt_len + self.max_len + self.spec_extra_corpus + self.spec_gamma + 2
            else:
                cl = self.max_len + self.spec_extra_corpus + self.spec_gamma + 2
            self._corpus = torch.full((self.max_slots, cl), -1, dtype=torch.int64, device=dev)
            self._corpus_end = torch.zeros(self.max_slots, dtype=torch.int64, device=dev)
            if self.gen_cfg.do_sample:
                self._pending = torch.full((self.max_slots,), self.gen_cfg.pad_token_id, dtype=torch.int64,
                                           device=dev)
        self._finished = torch.ones(self.max_slots, dtype=torch.bool, device=dev)  # inactive == finished
        self._active: list[Optional[Request]] = [None] * self.max_slots
        self._emitted: list[list[int]] = [[] for _ in range(self.max_slots)]
        self._admitted_chunk = [0] * self.max_slots

    # -- OPT admission --------------------------------------------------

    def _admit(self, embeds: torch.Tensor, mask: torch.Tensor, slot: int) -> None:
        """Prefill one left-padded request straight into slot ``slot``: the
        forward writes a one-row view of the shared cache (kernel K2 over the
        row), the slot's slots past W are zeroed, and the shared index
        advances to W; every other row's filled prefix is untouched (their
        mask is 0 over [old index, W))."""
        w = embeds.shape[1]
        cache = self._cache
        row = {key: val[:, slot : slot + 1] for key, val in cache.items() if key in _SLOT_BUFFERS}
        cache["mask"][slot] = 0
        cache["pos"][slot] = 0
        row.update(index=0, mask=cache["mask"][slot : slot + 1], pos=cache["pos"][slot : slot + 1])
        logits, _ = self.model.lm_forward(embeds, attention_mask=mask, cache=row)
        for key in _SLOT_BUFFERS:
            if key in cache:
                cache[key][:, slot, w:] = 0
        cache["index"] = max(cache["index"], w)
        self._logits[slot] = logits[0, -1].to(self._logits.dtype)
        self._finished[slot] = False

    def _admit_pending(self) -> None:
        if self._is_t5:
            self._admit_pending_t5()
            return
        tried_compact = False
        while self._queue:
            slot = next((i for i, r in enumerate(self._active) if r is None), None)
            if slot is None:
                return
            req = self._queue[0]
            p = len(req.input_ids)
            w = self._bucket(p)
            # evicted continuations already emitted part of their budget;
            # reserve only what the request can still produce
            need = self.gen_cfg.max_new_tokens - len(self._carry_emitted.get(req.rid, ()))
            if w + need > self.max_len:
                b = self.prefill_bucket
                if -(-p // b) * b + need > self.max_len:
                    self._queue.popleft()
                    raise ValueError(
                        f"request rid={req.rid} prompt ({p} tokens) cannot fit "
                        f"max_len={self.max_len} with max_new_tokens="
                        f"{self.gen_cfg.max_new_tokens} even in a fresh session"
                    )
                # cache pressure: reclaim the dead prefix (rolling compaction)
                # instead of draining, then retry this request once
                if not tried_compact:
                    tried_compact = True
                    if self._compact():
                        continue
                return  # blocked on the oldest live row; retry next chunk
            self._queue.popleft()
            pad = w - p
            ids = np.concatenate([np.zeros(pad, np.int64), np.asarray(req.input_ids, np.int64)])
            mask = np.concatenate([np.zeros(pad, np.int64), np.ones(p, np.int64)])
            vim = (
                np.concatenate([np.zeros(pad, np.int64), np.asarray(req.video_input_mask, np.int64)])
                if req.video_input_mask is not None
                else None
            )
            embeds = self._embed(ids, req.pixel_values, vim, req.feature_keys)
            self._admit(embeds, self._tensor(mask[None]).to(torch.int32), slot)
            if self._spec is not None:
                self._write_spec_corpus(slot, ids, mask, vim, req.extra_corpus)
                if self.gen_cfg.do_sample:
                    self._pending[slot] = _select_token(self._logits[slot : slot + 1].float(), self.gen_cfg,
                                                        self._noise)[0]
            self._active[slot] = req
            self._emitted[slot] = self._carry_emitted.pop(req.rid, [])
            self._admitted_chunk[slot] = self._chunk_count

    # -- T5 admission and decode ---------------------------------------

    def _admit_pending_t5(self) -> None:
        tried_compact = False
        tcfg = self.model.config.text_config
        while self._queue:
            slot = next((i for i, r in enumerate(self._active) if r is None), None)
            if slot is None:
                return
            req = self._queue[0]
            p = len(req.input_ids)
            if p > self.max_prompt_len:
                self._queue.popleft()
                raise ValueError(
                    f"request rid={req.rid} prompt ({p} tokens) exceeds max_prompt_len={self.max_prompt_len}"
                )
            # the self cache holds decoder tokens only; pressure is purely
            # decode headroom from the current shared index
            if self._cache["index"] + self.gen_cfg.max_new_tokens > self.max_len:
                if not tried_compact:
                    tried_compact = True
                    if self._compact():
                        continue
                return  # blocked on the oldest live row; retry next chunk
            self._queue.popleft()
            # right-padded to a bucket width (the encoder's shapes bounded by
            # max_prompt_len / prefill_bucket)
            b = self.prefill_bucket
            w = min(-(-p // b) * b, self.max_prompt_len)
            pad = w - p
            ids = np.concatenate([np.asarray(req.input_ids, np.int64), np.zeros(pad, np.int64)])
            mask = np.concatenate([np.ones(p, np.int64), np.zeros(pad, np.int64)])
            vim = (
                np.concatenate([np.asarray(req.video_input_mask, np.int64), np.zeros(pad, np.int64)])
                if req.video_input_mask is not None
                else None
            )
            embeds = self._embed(ids, req.pixel_values, vim, req.feature_keys)
            prompt_mask = self._tensor(mask[None]).to(torch.int32)
            # one encoder pass, the slot's cross K/V and encoder mask spliced
            # in (zeros past W), its self-cache mask blanked (the dead prefix
            # stays unattended), the decoder seeded with the start token
            encoder_hidden = self.model.t5_encode(embeds, prompt_mask)
            ck, cv = self.model.language_model.decoder.make_cross_kv(encoder_hidden)  # (L, 1, W, H, hd)
            cache = self._cache
            for key, val in (("cross_k", ck), ("cross_v", cv)):
                cache[key][:, slot, :w] = val[:, 0].to(cache[key].dtype)
                cache[key][:, slot, w:] = 0
            cache["mask"][slot] = 0
            self._enc_mask[slot] = 0
            self._enc_mask[slot, :w] = prompt_mask[0]
            self._next_tok[slot] = tcfg.decoder_start_token_id
            self._finished[slot] = False
            if self._spec is not None:
                # the T5 lookup corpus: the ENCODER source tokens
                self._write_spec_corpus(slot, ids, mask, vim, req.extra_corpus)
            self._active[slot] = req
            self._emitted[slot] = []
            self._admitted_chunk[slot] = self._chunk_count

    def _decode_chunk_t5(self, chunk: int):
        """``chunk`` token-in / logits-out decoder steps over every slot (the
        OPT chunk is logits-in: its first token comes from the prefill; a T5
        slot's from feeding the start token). Returns (finished, tokens)."""
        finished, toks = self._finished, []
        for _ in range(chunk):
            logits, _ = self.model.t5_decode_step(self._next_tok[:, None], None, self._enc_mask, self._cache)
            nxt = _select_token(logits[:, -1], self.gen_cfg, self._noise)
            nxt = torch.where(finished, self.gen_cfg.pad_token_id, nxt)
            finished = finished | _is_eos(nxt, self.gen_cfg)
            self._next_tok = nxt
            toks.append(nxt)
        return finished, torch.stack(toks, dim=1)

    # -- speculative passes --------------------------------------------

    def _spec_chunk(self, gamma: int, match_len: int):
        """One per-slot prompt-lookup pass over the shared cache (OPT, greedy
        or sampling). The verify block [pending, d_1..d_gamma] is appended at
        the shared index for every row (finished rows with mask 0: nothing
        attendable written); each row keeps its own accepted prefix, the
        rejected suffix becomes a mask hole and ``pos`` rolls back by it.
        Greedy re-derives ``pending`` from the carried logits by argmax;
        sampling carries it (the residual draw must exclude the rejected
        draft). Emits [pending, d_1..d_a] per row. Returns (emit, n_emit)."""
        cfg = self.gen_cfg
        pad = cfg.pad_token_id
        finished = self._finished
        active = ~finished
        if cfg.do_sample:
            pending = torch.where(finished, pad, self._pending)
        else:
            pending = torch.where(finished, pad, self._logits.argmax(dim=-1))
        _write_rows(self._corpus, pending[:, None], self._corpus_end)
        end2 = self._corpus_end + active.to(torch.int64)
        drafts = lookup_drafts_rows(self._corpus, end2, gamma, match_len, pad,
                                    vocab=self.model.config.text_config.vocab_size)
        block = torch.cat([pending[:, None], drafts], dim=1)  # (slots, gamma + 1)

        attn_mask = active[:, None].expand(self.max_slots, gamma + 1).to(torch.int32)
        v_logits, _ = self.model.lm_forward(self.model.lm_embed(block), attention_mask=attn_mask,
                                            cache=self._cache, cache_append=True)
        if cfg.do_sample:
            x = _warp_logits(v_logits.float(), cfg)
            p_draft = torch.softmax(x[:, :gamma], dim=-1).gather(-1, drafts[..., None])[..., 0]
            u = torch.rand(self.max_slots, gamma, generator=self._generator, device=self._device)
            a_row = _accept_count(u < p_draft)
            correction = _residual_draw(x, a_row, drafts, gamma, self._noise)
        else:
            a_row = _accept_count(drafts == v_logits.argmax(dim=-1)[:, :gamma])
        emit, n_emit, eos_hit = _emissions(block, a_row, active, cfg)
        self._finished = finished | eos_hit

        _punch_holes(self._cache, gamma, a_row, active)
        self._cache["pos"] -= torch.where(active, gamma - a_row, 0).to(torch.int32)
        # logits-out: the prediction after each row's accepted prefix (greedy:
        # its argmax is the next pass's pending)
        vocab = v_logits.shape[-1]
        self._logits = v_logits.gather(1, a_row.view(-1, 1, 1).expand(-1, 1, vocab))[:, 0].to(self._logits.dtype)
        # the drafts tile joins the corpus; only the accepted prefix counts
        _write_rows(self._corpus, drafts, end2)
        self._corpus_end = end2 + torch.where(active, n_emit - 1, 0)
        if cfg.do_sample:
            self._pending = torch.where(self._finished, pad, correction)
        return emit, n_emit

    def _spec_chunk_t5(self, gamma: int, match_len: int):
        """One per-slot prompt-lookup pass for T5 slots (greedy or sampling).
        T5 is token-in: ``next_tok`` was emitted already (or is the start
        token), so a pass emits [d_1..d_a, correction], the correction at
        once; the verify block is one ``decode_append`` (intra-block causal,
        hole-aware relative bias). ``gamma == 0`` is an exact hole-aware
        one-token step (the pressure fallback). Returns (emit, n_emit)."""
        cfg = self.gen_cfg
        pad = cfg.pad_token_id
        finished = self._finished
        active = ~finished
        if gamma > 0:
            drafts = lookup_drafts_rows(self._corpus, self._corpus_end, gamma, match_len, pad,
                                        vocab=self.model.config.text_config.vocab_size)
        else:
            drafts = torch.zeros(self.max_slots, 0, dtype=torch.int64, device=self._device)
        block = torch.cat([self._next_tok[:, None], drafts], dim=1)
        v_logits, _ = self.model.t5_decode_append(block, self._enc_mask, self._cache, active)
        if cfg.do_sample:
            x = _warp_logits(v_logits.float(), cfg)
            if gamma > 0:
                p_draft = torch.softmax(x[:, :gamma], dim=-1).gather(-1, drafts[..., None])[..., 0]
                u = torch.rand(self.max_slots, gamma, generator=self._generator, device=self._device)
                a_row = _accept_count(u < p_draft)
            else:
                a_row = torch.zeros(self.max_slots, dtype=torch.int64, device=self._device)
            correction = _residual_draw(x, a_row, drafts, gamma, self._noise)
        else:
            targets = v_logits.argmax(dim=-1)
            if gamma > 0:
                a_row = _accept_count(drafts == targets[:, :gamma])
            else:
                a_row = torch.zeros(self.max_slots, dtype=torch.int64, device=self._device)
            correction = targets.gather(1, a_row[:, None])[:, 0]

        # [d_1..d_a, correction], capped at the first eos
        col = torch.arange(gamma + 1, device=self._device)[None, :]
        emit0 = torch.cat([drafts, drafts.new_full((self.max_slots, 1), pad)], dim=1)
        emit0 = torch.where(col < a_row[:, None], emit0, torch.where(col == a_row[:, None], correction[:, None], pad))
        emit0 = torch.where(active[:, None], emit0, pad)
        emit, n_emit, eos_hit = _emissions(emit0, a_row, active, cfg)
        self._finished = finished | eos_hit
        # the kept prefix is [next_tok, d_1..d_a] (the correction is fed next
        # pass); no pos to roll back: the bias recomputes distances from the mask
        _punch_holes(self._cache, gamma, a_row, active)
        _write_rows(self._corpus, emit, self._corpus_end)
        self._corpus_end = self._corpus_end + n_emit
        self._next_tok = torch.where(self._finished, pad, correction)
        return emit, n_emit

    def _spec_step(self) -> list[Completion]:
        """One per-slot speculative pass, under the pressure ladder.

        Admission reserves ``max_new_tokens`` of cache per request as plain
        decode does, but rejection holes make a speculative row's span
        exceed its token count. So: compact the dead prefix; if a gamma + 1
        window still does not fit, plain chunked decode (no new holes); if
        even one token cannot fit, evict and recompute (see _pressure_step).
        """
        g = self.spec_gamma
        if self._cache["index"] + g + 1 > self.max_len:
            self._compact()
        if self._cache["index"] + g + 1 > self.max_len:
            return self._pressure_step()
        if self._is_t5:
            emit, n_emit = self._spec_chunk_t5(g, self.spec_match_len)
        else:
            emit, n_emit = self._spec_chunk(g, self.spec_match_len)
        self._chunk_count += 1
        toks, finished, n_valid = self._readback(emit, n_emit)
        self.stats["spec_passes"] += 1
        self.stats["spec_tokens"] += int(n_valid.sum())
        self.stats["spec_rows"] += int((n_valid > 0).sum())
        return self._harvest(toks, finished, n_valid=n_valid)

    def _pressure_step(self) -> list[Completion]:
        """Speculative cache-pressure fallback: plain decode, then eviction."""
        idx = self._cache["index"]
        if self._is_t5:
            if idx + 1 <= self.max_len:
                # the hole-aware one-token step (gamma 0): the plain T5 step's
                # bias is only right over contiguous windows
                emit, n_emit = self._spec_chunk_t5(0, self.spec_match_len)
                self._chunk_count += 1
                self.stats["spec_fallback_chunks"] += 1
                toks, finished, n_valid = self._readback(emit, n_emit)
                return self._harvest(toks, finished, n_valid=n_valid)
            if self._evict_one_t5():
                return self.step()
            if self._defrag_t5():
                return self.step()
            raise RuntimeError(
                f"speculative serving deadlock: cache index {idx} cannot fit one "
                f"more token in max_len={self.max_len} and no active row's replay "
                f"would fit even after a full defrag; raise max_len or lower spec_gamma"
            )
        for chunk in (self.chunk_tokens, 1):
            if idx + chunk <= self.max_len:
                active_before = ~self._finished
                self._logits, self._finished, toks = _decode_chunk(
                    self.model, self._cache, self._logits, self._finished, self.gen_cfg, self._noise, chunk)
                self._chunk_count += 1
                self.stats["spec_fallback_chunks"] += 1
                # the chunk's tokens join each active row's corpus (post-eos
                # pads of rows finishing mid-chunk are harmless: finished rows
                # never draft again and their row resets at the next admission)
                _write_rows(self._corpus, toks, self._corpus_end)
                self._corpus_end = self._corpus_end + torch.where(active_before, chunk, 0)
                if self.gen_cfg.do_sample:
                    # the pre-pressure pendings were never emitted or fed:
                    # redraw them from the chunk's last logits (exact law)
                    tok = _select_token(self._logits.float(), self.gen_cfg, self._noise)
                    self._pending = torch.where(self._finished, self.gen_cfg.pad_token_id, tok)
                return self._harvest(*self._readback(toks))
        if self._evict_one():
            self._compact()
            return self.step()
        # _spec_step runs only with active rows, so every active row's
        # continuation could never re-admit: a sizing error
        raise RuntimeError(
            f"speculative serving deadlock: cache index {self._cache['index']} cannot "
            f"fit one more token in max_len={self.max_len} and no active request's "
            f"continuation would fit a fresh session; raise max_len or lower spec_gamma"
        )

    # -- cache pressure -------------------------------------------------

    def _live_starts(self) -> dict[int, int]:
        """Each active slot's first attended slot (the index when its window
        is empty), read from the mask on the host."""
        index = self._cache["index"]
        mask_np = self._cache["mask"][:, :index].cpu().numpy()
        return {
            slot: int(np.argmax(mask_np[slot])) if mask_np[slot].any() else index
            for slot, req in enumerate(self._active)
            if req is not None
        }

    def _compact(self) -> bool:
        """Left-shift the cache by the dead prefix ahead of every active row
        (min live start; each row's live window is [first mask 1, index)).
        Returns True when any space was reclaimed."""
        index = self._cache["index"]
        if index == 0:
            return False
        starts = self._live_starts()
        delta = min(starts.values()) if starts else index
        if delta <= 0:
            return False
        _compact_cache(self._cache, delta)
        self.stats["compactions"] += 1
        return True

    def _evict_one(self) -> bool:
        """Evict the active row pinning compaction (min live start) and
        requeue it as a continuation request carrying its emissions
        (recompute-style preemption); rows whose continuation could never
        re-admit are skipped."""
        victims = sorted((start, slot) for slot, start in self._live_starts().items())
        b = self.prefill_bucket
        for _, slot in victims:
            req = self._active[slot]
            emitted = self._emitted[slot]
            p_cont = len(req.input_ids) + len(emitted)
            remaining = self.gen_cfg.max_new_tokens - len(emitted)
            if -(-p_cont // b) * b + remaining > self.max_len:
                continue  # the continuation could never fit a fresh session
            ids = np.asarray(req.input_ids)
            ids = np.concatenate([ids, np.asarray(emitted, dtype=ids.dtype)])
            vim = None
            if req.video_input_mask is not None:
                vim0 = np.asarray(req.video_input_mask)
                vim = np.concatenate([vim0, np.zeros(len(emitted), vim0.dtype)])
            cont = dataclasses.replace(req, input_ids=ids, video_input_mask=vim)
            self._carry_emitted[cont.rid] = list(emitted)
            self._queue.appendleft(cont)
            self._active[slot] = None
            self._emitted[slot] = []
            self._finished[slot] = True
            self.stats["evictions"] += 1
            return True
        return False

    def _t5_replay(self, block: np.ndarray, pos_mask: np.ndarray) -> None:
        """Rebuild evicted T5 rows' decoder cache by replaying their token
        blocks [start, e_1..e_{n-1}] (right-padded to a bucket; ``pos_mask``
        marks the real positions) through one write-masked append; the
        logits are discarded. Other rows' windows stay untouched (their
        writes are masked), the shared index advances by the block width."""
        self.model.t5_decode_append(self._tensor(block), self._enc_mask, self._cache,
                                    self._tensor(pos_mask).bool())

    def _evict_one_t5(self) -> bool:
        """T5 evict-and-replay: blank the compaction-pinning row's mask,
        compact, then rebuild the row in place by replaying its decoder
        tokens. The request never re-queues: its cross K/V stay valid, and
        it resumes with ``next_tok`` its last emission."""
        index = self._cache["index"]
        starts = self._live_starts()
        b = self.prefill_bucket
        tcfg = self.model.config.text_config
        for slot, _ in sorted(starts.items(), key=lambda kv: kv[1]):
            emitted = self._emitted[slot]
            if not emitted:
                continue  # an empty live window never pins compaction
            n = len(emitted)  # block = [start] + emitted[:-1]
            w = -(-n // b) * b
            delta = min((st for s, st in starts.items() if s != slot), default=index)
            if (index - delta) + w + 1 > self.max_len:
                continue  # the replay would not fit even after compaction
            self._cache["mask"][slot] = 0
            self._compact()
            block = np.full((self.max_slots, w), self.gen_cfg.pad_token_id, np.int64)
            block[slot, :n] = [tcfg.decoder_start_token_id] + [int(t) for t in emitted[:-1]]
            pos_mask = np.zeros((self.max_slots, w), np.int64)
            pos_mask[slot, :n] = 1
            self._t5_replay(block, pos_mask)
            self._next_tok[slot] = int(emitted[-1])
            self.stats["evictions"] += 1
            return True
        return False

    def _defrag_t5(self) -> bool:
        """Full T5 defrag, when every live window starts near 0 (single-row
        replay is pinned by the others' prefixes): blank every row's mask,
        compact the now dead prefix to 0, and rebuild every row's committed
        tokens in one write-masked replay (shorter rows keep masked holes,
        which the hole-aware bias handles)."""
        actives = [(slot, self._emitted[slot]) for slot, req in enumerate(self._active) if req is not None]
        if not actives:
            return False
        n_max = max(len(e) for _, e in actives)
        if n_max == 0:
            return False  # nothing replayable: the windows are empty already
        b = self.prefill_bucket
        w = -(-n_max // b) * b
        if w + 1 > self.max_len:
            return False  # a sizing error; the caller raises
        for slot, _ in actives:
            self._cache["mask"][slot] = 0
        self._compact()  # every mask is blank: the index drops to 0
        tcfg = self.model.config.text_config
        block = np.full((self.max_slots, w), self.gen_cfg.pad_token_id, np.int64)
        pos_mask = np.zeros((self.max_slots, w), np.int64)
        for slot, emitted in actives:
            n = len(emitted)
            if n == 0:
                continue
            block[slot, :n] = [tcfg.decoder_start_token_id] + [int(t) for t in emitted[:-1]]
            pos_mask[slot, :n] = 1
            self._next_tok[slot] = int(emitted[-1])
        self._t5_replay(block, pos_mask)
        self.stats["defrags"] += 1
        return True

    # -- helpers ----------------------------------------------------------

    def _tensor(self, array) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array), device=self._device)

    def _write_spec_corpus(self, slot, ids, mask, vim, extra=None) -> None:
        """Reset the slot's lookup-corpus row at admission: the padded prompt
        with pad and video-placeholder positions -1 (the contract of
        ``generation.speculative.build_lookup_corpus``), then the request's
        extra reference tokens (up to ``spec_extra_corpus``)."""
        cl = self._corpus.shape[1]
        keep = mask.astype(bool)
        if vim is not None:
            keep = keep & (vim == 0)
        row = np.where(keep, ids, -1).astype(np.int64)
        if extra is not None and self.spec_extra_corpus > 0:
            row = np.concatenate([row, np.asarray(extra, np.int64)[: self.spec_extra_corpus]])
        end = len(row)
        row = np.concatenate([row, np.full(cl - len(row), -1, np.int64)])
        self._corpus[slot] = self._tensor(row)
        self._corpus_end[slot] = end

    def _bucket(self, prompt_len: int) -> int:
        w = max(self._cache["index"], prompt_len)
        b = self.prefill_bucket
        return -(-w // b) * b

    def _embed(self, ids, pixel_values, vim, feature_keys=None) -> torch.Tensor:
        input_ids = self._tensor(ids[None])
        pixel = None if pixel_values is None else torch.as_tensor(pixel_values).to(self._device, self._dtype)
        video_mask = None if vim is None else self._tensor(vim[None])
        if self.feature_cache is not None and feature_keys is not None:
            feats = self.feature_cache.features(feature_keys, pixel, loader=self.feature_loader)
            return self.model.embed_and_scatter(input_ids, None, video_mask, video_features=feats)
        if self.video_bucket > 0 and pixel is not None:
            feats = self._encode_bucketed(pixel)
            return self.model.embed_and_scatter(input_ids, None, video_mask, video_features=feats)
        if self.vision_chunks > 1 and pixel is not None:
            return embed_and_scatter_chunked(self.model, input_ids, pixel, video_mask,
                                             vision_chunks=self.vision_chunks)
        return self.model.embed_and_scatter(input_ids, pixel, video_mask)

    def _encode_bucketed(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """The vision encode in fixed buckets of ``video_bucket`` videos, the
        tail zero-padded (the feature cache's miss scheme; each video's
        features are independent of its batch-mates)."""
        v, b = pixel_values.shape[0], self.video_bucket
        out = []
        for start in range(0, v, b):
            chunk = pixel_values[start : start + b]
            pad = b - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, chunk.new_zeros(pad, *chunk.shape[1:])])
            feats = self.model.encode_videos(chunk).reshape(b, self.model.config.num_query_tokens, -1)
            out.append(feats[: b - pad])
        return torch.cat(out).reshape(-1, out[0].shape[-1])

    def _harvest(self, toks: np.ndarray, finished: np.ndarray,
                 n_valid: Optional[np.ndarray] = None) -> list[Completion]:
        out: list[Completion] = []
        max_new = self.gen_cfg.max_new_tokens
        budget_hit = False
        for slot, req in enumerate(self._active):
            if req is None:
                continue
            room = max_new - len(self._emitted[slot])
            # plain chunks emit the full row width; speculative passes a
            # per-row count (acceptance varies by slot)
            take = room if n_valid is None else min(room, int(n_valid[slot]))
            self._emitted[slot].extend(int(t) for t in toks[slot, :take])
            if bool(finished[slot]) or len(self._emitted[slot]) >= max_new:
                row = np.full((max_new,), self.gen_cfg.pad_token_id, np.int32)
                got = np.asarray(self._emitted[slot], np.int32)
                row[: len(got)] = got
                out.append(Completion(rid=req.rid, tokens=row, admitted_at_chunk=self._admitted_chunk[slot],
                                      finished_at_chunk=self._chunk_count))
                self._active[slot] = None
                self._emitted[slot] = []
                if not finished[slot]:
                    budget_hit = True
        if budget_hit:
            # slots that hit max_new without eos must stop decoding
            idle = [slot for slot, req in enumerate(self._active) if req is None]
            self._finished[idle] = True
        return out
