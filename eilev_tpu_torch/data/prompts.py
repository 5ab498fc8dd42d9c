"""Prompt/label/video-input-mask builders - the data contract at the heart of EILeV
(a copy of ``eilev_tpu/data/prompts.py``, kept here because the port imports
nothing of ``eilev_tpu``).

Parity target: the original EILeV's eilev/data/utils.py:95-223. The reference's golden
token-id tests (tests/data/test_utils.py:113-846) define this contract; our tests
replicate them with a deterministic mock tokenizer plus the same layout rules:

decoder-only interleaved layout per prompt (text, num_videos):
  [bos]? ([pad]*num_query_tokens [newline])*num_videos  prompt_tokens ["\n" if not last]
with video_input_mask 1 exactly over the pad blocks, labels -100 everywhere except
the target text (" " + text + "\n" + eos).

Outputs are numpy int arrays (host-side stage; device code consumes them as-is).
"""

from __future__ import annotations

from typing import Any, Optional, Protocol

import numpy as np

IGNORE_INDEX = -100


class TokenizerLike(Protocol):
    """Duck type covering HF tokenizers and test mocks."""

    pad_token_id: int
    bos_token_id: int
    eos_token_id: int

    def __call__(self, text: str, **kwargs: Any) -> Any: ...


def _tokenize(tokenizer: TokenizerLike, text: str, add_special_tokens: bool = True) -> list[int]:
    out = tokenizer(text, add_special_tokens=add_special_tokens, return_attention_mask=False)
    ids = out["input_ids"] if isinstance(out, dict) else out.input_ids
    return list(ids)


def generate_input_ids_and_labels(
    tokenizer: TokenizerLike, prompt: str, text: str, decoder_only_lm: bool
) -> dict[str, np.ndarray]:
    """v1 (single-video) prompt builder - reference data/utils.py:95-140.

    Decoder-only: ids = prompt_tokens + tokenize(" "+text) + [eos]; labels are the
    same with the prompt masked to -100. Seq2seq: ids = prompt tokens (eos appended
    by the tokenizer); labels = tokenize(text).
    """
    if decoder_only_lm:
        prompt_tokens = _tokenize(tokenizer, prompt)
        text_tokens = _tokenize(tokenizer, " " + text, add_special_tokens=False)
        text_tokens.append(tokenizer.eos_token_id)
        input_ids = prompt_tokens + text_tokens
        labels = [IGNORE_INDEX] * len(prompt_tokens) + text_tokens
    else:
        input_ids = _tokenize(tokenizer, prompt)
        labels = _tokenize(tokenizer, text)
    return {
        "input_ids": np.asarray(input_ids, np.int64),
        "labels": np.asarray(labels, np.int64),
    }


def generate_input_ids_and_labels_from_interleaved(
    tokenizer: TokenizerLike,
    prompts: list[tuple[str, int]],
    text: Optional[str],
    num_query_tokens: int,
    decoder_only_lm: bool,
) -> dict[str, np.ndarray]:
    """v2 interleaved prompt builder - reference data/utils.py:143-223.

    :param prompts: list of (prompt text, num preceding videos)
    :param text: optional target text for the LM to complete
    :returns: dict with 1-D ``input_ids``, ``labels``, ``video_input_mask``.
    """
    input_ids: list[int] = []
    labels: list[int] = []
    video_input_mask: list[int] = []
    # NOTE (from reference): the FLAN tokenizer treats all whitespace the same
    newline_token_id = _tokenize(tokenizer, "\n", add_special_tokens=False)[0]

    if decoder_only_lm:
        for i, (prompt, num_videos) in enumerate(prompts):
            for _ in range(num_videos):
                input_ids.extend([tokenizer.pad_token_id] * num_query_tokens + [newline_token_id])
                labels.extend([IGNORE_INDEX] * (num_query_tokens + 1))
                video_input_mask.extend([1] * num_query_tokens + [0])
            if i == 0:
                input_ids = [tokenizer.bos_token_id] + input_ids
                labels = [IGNORE_INDEX] + labels
                video_input_mask = [0] + video_input_mask
            if i != len(prompts) - 1:
                prompt += "\n"
            prompt_tokens = _tokenize(tokenizer, prompt, add_special_tokens=False)
            input_ids.extend(prompt_tokens)
            video_input_mask.extend([0] * len(prompt_tokens))
            labels.extend([IGNORE_INDEX] * len(prompt_tokens))
        if text is not None:
            text_tokens = _tokenize(tokenizer, " " + text + "\n", add_special_tokens=False) + [
                tokenizer.eos_token_id
            ]
            input_ids.extend(text_tokens)
            video_input_mask.extend([0] * len(text_tokens))
            labels.extend(text_tokens)
    else:
        for i, (prompt, num_videos) in enumerate(prompts):
            for _ in range(num_videos):
                input_ids.extend([tokenizer.pad_token_id] * num_query_tokens + [newline_token_id])
                video_input_mask.extend([1] * num_query_tokens + [0])
            if i != len(prompts) - 1:
                prompt += "\n"
            prompt_tokens = _tokenize(tokenizer, prompt, add_special_tokens=False)
            if i == len(prompts) - 1:
                prompt_tokens.append(tokenizer.eos_token_id)
            input_ids.extend(prompt_tokens)
            video_input_mask.extend([0] * len(prompt_tokens))
        if text is not None:
            labels.extend(_tokenize(tokenizer, text))

    return {
        "input_ids": np.asarray(input_ids, np.int64),
        "labels": np.asarray(labels, np.int64),
        "video_input_mask": np.asarray(video_input_mask, np.int64),
    }
