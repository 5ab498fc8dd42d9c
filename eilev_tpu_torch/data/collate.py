"""Batch collators (host-side, numpy; a copy of ``eilev_tpu/data/collate.py``,
kept here because the port imports nothing of ``eilev_tpu``).

Parity targets: ``DataCollatorForVideoSeq2Seq`` and
``DataCollatorForInterleavedVideoSeq2Seq`` (the original EILeV's eilev/data/utils.py:19-66),
which wrap HF ``DataCollatorForSeq2Seq``. Re-implemented framework-free:

  - input_ids padded with the tokenizer pad id, attention_mask with 0, labels with
    -100, honoring ``padding_side`` and ``pad_to_multiple_of`` (the training recipe
    uses pad_to_multiple_of=8 - reference scripts/general/train_v2.py:207-216;
    multiples of 8 keep the set of batch shapes small);
  - v1 collator stacks per-sample pixel_values (B, C, T, H, W);
  - interleaved collator concatenates pixel_values along the video axis
    (sum_videos, C, T, H, W) and pads video_input_mask on the tokenizer's padding
    side (reference data/utils.py:35-66).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from .prompts import IGNORE_INDEX


def _pad_1d(arr: np.ndarray, target: int, value: int, side: str) -> np.ndarray:
    pad = target - len(arr)
    if pad <= 0:
        return np.asarray(arr)
    filler = np.full(pad, value, dtype=np.asarray(arr).dtype)
    if side == "right":
        return np.concatenate([arr, filler])
    return np.concatenate([filler, arr])


def _round_up(n: int, multiple: Optional[int]) -> int:
    if not multiple:
        return n
    return ((n + multiple - 1) // multiple) * multiple


@dataclass
class DataCollatorForVideoSeq2Seq:
    """v1: stack pixel_values, pad ids/labels/mask."""

    pad_token_id: int
    padding_side: str = "right"
    pad_to_multiple_of: Optional[int] = None
    label_pad_token_id: int = IGNORE_INDEX

    def __call__(self, features: list[dict[str, Any]]) -> dict[str, np.ndarray]:
        has_pixels = all("pixel_values" in f for f in features)
        pixel_values = (
            np.stack([np.asarray(f["pixel_values"]) for f in features]) if has_pixels else None
        )
        batch = self._pad_text_features(features)
        if pixel_values is not None:
            batch["pixel_values"] = pixel_values
        return batch

    def _pad_text_features(self, features: list[dict[str, Any]]) -> dict[str, np.ndarray]:
        ids = [np.asarray(f["input_ids"]) for f in features]
        target = _round_up(max(len(x) for x in ids), self.pad_to_multiple_of)
        batch: dict[str, np.ndarray] = {
            "input_ids": np.stack(
                [_pad_1d(x, target, self.pad_token_id, self.padding_side) for x in ids]
            ),
            "attention_mask": np.stack(
                [
                    _pad_1d(np.ones(len(x), np.int64), target, 0, self.padding_side)
                    for x in ids
                ]
            ),
        }
        if "labels" in features[0]:
            labels = [np.asarray(f["labels"]) for f in features]
            # HF DataCollatorForSeq2Seq pads labels to their own max (optionally
            # rounded); for decoder-only inputs labels match input length anyway.
            ltarget = _round_up(max(len(x) for x in labels), self.pad_to_multiple_of)
            batch["labels"] = np.stack(
                [_pad_1d(x, ltarget, self.label_pad_token_id, self.padding_side) for x in labels]
            )
        return batch


@dataclass
class DataCollatorForInterleavedVideoSeq2Seq(DataCollatorForVideoSeq2Seq):
    """v2: concatenate pixel_values over the video axis; pad video_input_mask to
    the padded input length on the tokenizer's padding side."""

    def __call__(self, features: list[dict[str, Any]]) -> dict[str, np.ndarray]:
        has_pixels = "pixel_values" in features[0]
        pixel_values = (
            np.concatenate([np.asarray(f["pixel_values"]) for f in features]) if has_pixels else None
        )
        vims = (
            [np.asarray(f["video_input_mask"]) for f in features]
            if "video_input_mask" in features[0]
            else None
        )
        batch = self._pad_text_features(features)
        if vims is not None:
            target = batch["input_ids"].shape[1]
            batch["video_input_mask"] = np.stack(
                [_pad_1d(v, target, 0, self.padding_side) for v in vims]
            )
        if pixel_values is not None:
            batch["pixel_values"] = pixel_values
        return batch
