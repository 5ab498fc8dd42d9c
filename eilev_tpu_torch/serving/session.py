"""Multi-turn chat sessions with incremental prefill (counterpart of
``eilev_tpu/serving/session.py``).

The session keeps its KV cache alive between turns and prefills only what
changed:

  - The caller passes the full prompt arrays each turn (what the prompt
    builder produces). The session takes the longest common prefix with the
    token stream resident in the cache, ROLLS BACK the diverged tail (a mask
    edit: the stale slots' mask bits zeroed, ``pos`` rewound; the slots are
    abandoned, the index only grows) and appends the suffix through the
    multi-token ``cache_append`` forward (``models/opt.py``: plain attention
    under a (1, 1, S, L) bias, as JAX's XLA path), encoding only the
    suffix's videos. Suffixes are right-padded to ``bucket`` widths.
  - The greedy decode appends every emitted token, eos included, and stops
    after the step that emitted eos, so nothing past it lands in the cache:
    the next turn extends the stream. ``turn_stream`` decodes in chunks and
    masks the pad steps past the eos back out.
  - Whatever the diff, the reply is token-identical to a from-scratch
    ``generate`` on the full prompt.

Decoder-only (OPT-family) LMs, greedy decoding. The session runs on its
model's device; the host reads one flag a decode step (the eos exit), a
chunk's tokens once a chunk in ``turn_stream``. On a tensor-parallel model
(``tp``) every rank of the model group runs its own session on the same
turns: the cache holds the rank's heads, and the host's reads come from the
gathered logits, the same bytes on every rank, so the ranks append, decode
and stop alike.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..configs import OPTConfig
from ..generation.config import GenerationConfig
from ..generation.decoding import _decode_chunk, _is_eos
from ..models.opt import init_cache


class ChatSession:
    """Incremental multi-turn generation over one persistent KV cache."""

    def __init__(
        self,
        model: nn.Module,
        generation_config: GenerationConfig,
        *,
        max_len: int = 2048,
        bucket: int = 64,
    ):
        if not isinstance(model.config.text_config, OPTConfig):
            raise ValueError("ChatSession supports decoder-only (OPT-family) LMs")
        if generation_config.num_beams > 1 or generation_config.do_sample:
            raise ValueError("ChatSession is greedy-only (beam/sampling re-prefill)")
        if generation_config.has_logits_processors:
            raise NotImplementedError(
                "ChatSession's incremental decode does not implement "
                "repetition_penalty/no_repeat_ngram_size/min_new_tokens"
            )
        gen_cfg = generation_config
        if gen_cfg.eos_token_id is None:
            gen_cfg = gen_cfg.with_eos(model.config.text_config.eos_token_id)
        self.model = model
        self.gen_cfg = gen_cfg
        self.max_len = max_len
        self.bucket = bucket
        self._device = next(model.parameters()).device
        self.reused_last_turn = False
        self.last_turn_appended = 0
        self.last_turn_rolled_back = 0
        self.reset()

    def reset(self) -> None:
        self._cache = None
        # the token stream resident in the cache, its video mask, and the
        # cache slot each token occupies (right-padding and abandoned
        # rollback slots make slot != position)
        self._ids: np.ndarray = np.zeros((0,), np.int64)
        self._vim: np.ndarray = np.zeros((0,), np.int64)
        self._slots: np.ndarray = np.zeros((0,), np.int64)
        self._index = 0  # slots consumed (the cache's index)

    # -- internals ----------------------------------------------------------

    def _fresh_cache(self):
        return init_cache(self.model.config.text_config, 1, self.max_len, dtype=self.model.compute_dtype,
                          device=self._device, tp=self.model.tp)

    def _lcp(self, full_ids: np.ndarray) -> int:
        n = min(len(self._ids), len(full_ids))
        if n == 0:
            return 0
        neq = self._ids[:n] != full_ids[:n]
        return int(np.argmax(neq)) if neq.any() else n

    def _mask_rollback(self, stale: np.ndarray, new_pos: int) -> None:
        """Zero the mask bits of the abandoned ``stale`` slots and rewind ``pos``."""
        if len(stale):
            self._cache["mask"][0, torch.as_tensor(stale, device=self._device)] = 0
        self._cache["pos"].fill_(new_pos)

    def _rollback(self, n_keep: int) -> None:
        self._mask_rollback(self._slots[n_keep:], n_keep)
        self._ids = self._ids[:n_keep]
        self._vim = self._vim[:n_keep]
        self._slots = self._slots[:n_keep]

    def _append(self, ids: np.ndarray, pixel_values, vim: np.ndarray) -> torch.Tensor:
        """Right-pad the delta to a bucket width and append it to the cache;
        returns the (1, vocab) fp32 logits of its last real token."""
        n = len(ids)
        pad = -n % self.bucket
        w = n + pad
        tcfg = self.model.config.text_config
        ids_p = np.concatenate([ids, np.full((pad,), tcfg.pad_token_id, ids.dtype)])
        vim_p = np.concatenate([vim, np.zeros((pad,), vim.dtype)])
        mask = np.concatenate([np.ones((n,), np.int32), np.zeros((pad,), np.int32)])

        def tensor(a):
            return torch.as_tensor(np.asarray(a), device=self._device)

        pixel = None if pixel_values is None else torch.as_tensor(pixel_values).to(self._device,
                                                                                   self.model.compute_dtype)
        embeds = self.model.embed_and_scatter(tensor(ids_p)[None], pixel, tensor(vim_p)[None])
        logits, _ = self.model.lm_forward(embeds, attention_mask=tensor(mask)[None], cache=self._cache,
                                          cache_append=True)
        self._slots = np.concatenate([self._slots, self._index + np.arange(n, dtype=np.int64)])
        self._index += w
        return logits[:, n - 1].float()

    def _decode_until_eos(self, last_logits: torch.Tensor):
        """Greedy decode over the session cache with the eos exit: every
        emitted token is appended (eos included), and the loop stops after
        the step that emitted eos or the budget. Returns the (m,) reply."""
        gen_cfg = self.gen_cfg
        one = torch.ones(1, 1, dtype=torch.int32, device=self._device)
        logits, out = last_logits, []
        for _ in range(gen_cfg.max_new_tokens):
            tok = logits.argmax(dim=-1)
            out.append(tok)
            next_logits, _ = self.model.lm_forward(self.model.lm_embed(tok[:, None]), attention_mask=one,
                                                   cache=self._cache)
            logits = next_logits[:, -1].float()
            if bool(_is_eos(tok, gen_cfg).any()):  # the one host read a step
                break
        return torch.cat(out).cpu().numpy()

    def _begin_turn(self, input_ids, pixel_values, video_input_mask):
        """The shared turn prologue: the LCP diff, rollback or reset, the
        budget check and the delta append. Returns (last_logits, full_ids,
        vim)."""
        full_ids = np.asarray(input_ids).reshape(-1)
        q = self.model.config.num_query_tokens
        vim = (
            np.asarray(video_input_mask).reshape(-1)
            if video_input_mask is not None
            else np.zeros_like(full_ids)
        )

        n_lcp = self._lcp(full_ids) if self._cache is not None else 0
        if n_lcp == 0 or len(full_ids) == n_lcp:
            # nothing reusable, or no new tokens at all: a fresh prefill (the
            # latter would otherwise append an empty delta)
            self.reset()
            self._cache = self._fresh_cache()
            self.reused_last_turn = False
            self.last_turn_rolled_back = 0
            n_lcp = 0
        else:
            self.last_turn_rolled_back = len(self._ids) - n_lcp
            if n_lcp < len(self._ids):
                self._rollback(n_lcp)
            self.reused_last_turn = True

        delta_ids = full_ids[n_lcp:]
        delta_vim = vim[n_lcp:]
        new_videos = None
        if pixel_values is not None and int(delta_vim.sum()) > 0:
            n_resident = int(self._vim.sum()) // q
            n_new = int(delta_vim.sum()) // q
            new_videos = pixel_values[n_resident:][:n_new]

        if len(delta_ids) == 0:
            raise ValueError("turn() called with no new tokens")
        pad = -len(delta_ids) % self.bucket
        budget = self._index + len(delta_ids) + pad + self.gen_cfg.max_new_tokens
        if budget > self.max_len:
            raise ValueError(f"conversation needs {budget} cache slots, max_len={self.max_len}")

        last_logits = self._append(delta_ids, new_videos, delta_vim)
        self.last_turn_appended = len(delta_ids)
        return last_logits, full_ids, vim

    def _finish_turn(self, full_ids, vim, reply: np.ndarray) -> None:
        """Record the reply tokens (already resident in the cache) in the
        session's token stream."""
        m = len(reply)
        self._ids = np.concatenate([full_ids, reply.astype(full_ids.dtype)])
        self._vim = np.concatenate([vim, np.zeros((m,), vim.dtype)])
        self._slots = np.concatenate([self._slots, self._index + np.arange(m, dtype=np.int64)])
        self._index += m

    # -- public -------------------------------------------------------------

    @torch.inference_mode()
    def turn(
        self,
        input_ids: np.ndarray,
        pixel_values=None,
        video_input_mask: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Generate a reply to the FULL prompt so far, reusing the cached prefix.

        :param input_ids: (P,) the whole conversation's token ids (the prompt
            builder's output), everything from previous turns included.
        :param pixel_values: (V, C, T, H, W) ALL videos referenced so far
            (numpy or a tensor).
        :param video_input_mask: (P,) aligned with input_ids.
        :returns: (m,) generated token ids (eos included, no padding).
        """
        last_logits, full_ids, vim = self._begin_turn(input_ids, pixel_values, video_input_mask)
        reply = self._decode_until_eos(last_logits)
        self._finish_turn(full_ids, vim, reply)
        return reply

    def turn_stream(
        self,
        input_ids: np.ndarray,
        pixel_values=None,
        video_input_mask: Optional[np.ndarray] = None,
        chunk: int = 8,
    ):
        """Streaming :meth:`turn`: yields (k,) token chunks as they decode.

        Tokens decode ``chunk`` steps at a time through the chunked decode
        of the static streaming path (``_decode_chunk``), one host read a
        chunk. The chunk appends every step's token, pad steps after the eos
        included, so on completion the pads' slots are masked back out (as
        an LCP rollback), restoring the resident-stream invariant.
        """
        with torch.inference_mode():
            last_logits, full_ids, vim = self._begin_turn(input_ids, pixel_values, video_input_mask)
        gen_cfg = self.gen_cfg
        max_new = gen_cfg.max_new_tokens
        eos_ids = set(gen_cfg.eos_token_id or ())
        finished = torch.zeros(1, dtype=torch.bool, device=self._device)
        # the chunked decode carries model-dtype logits (the fp32 cast of the
        # append is lossless over bf16 values, so argmax agrees)
        logits = last_logits.to(self.model.compute_dtype)
        emitted: list[int] = []
        appended = 0
        done = False
        while appended < max_new and not done:
            steps = min(chunk, max_new - appended)
            with torch.inference_mode():
                logits, finished, toks = _decode_chunk(self.model, self._cache, logits, finished, gen_cfg, None,
                                                       steps)
                host = torch.cat([toks[0], finished.to(toks.dtype)]).cpu().numpy()
            appended += steps
            row, done = host[:-1], bool(host[-1])
            fresh = []
            for t in row:
                if len(emitted) + len(fresh) >= max_new:
                    break
                fresh.append(int(t))
                if int(t) in eos_ids:
                    done = True
                    break
            emitted.extend(fresh)
            if fresh:
                yield np.asarray(fresh, np.int32)
        m = len(emitted)
        # mask out the pad steps the last chunk appended past the eos
        stale = appended - m
        if stale > 0:
            with torch.inference_mode():
                self._mask_rollback(np.arange(self._index + m, self._index + appended), len(full_ids) + m)
        self._finish_turn(full_ids, vim, np.asarray(emitted, np.int64))
        self._index += stale  # the stale slots are consumed, just masked
