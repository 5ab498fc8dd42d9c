"""Training data pipelines: dataset -> tokenized, padded batches on the card
(counterpart of ``eilev_tpu/training/data_module.py``).

The train_v2 preprocessing recipe (reference train_v2.py:30-75): per example
an instruction prompt drawn from the InstructBLIP-style pool, cleaned
narration text, the interleaved prompt builder and the augmentation stack,
collated to static shapes (fixed videos per sample, tokens padded to a fixed
bucket) and stacked into ``gradient_accumulation`` micro-batches.

The prompts come from the same ``random.Random(seed)`` stream as in JAX, so
the token ids, labels and masks are the JAX iterator's. The augmentation
(``ops/preprocess.train_transform``) runs on ``device`` (the card unless the
caller asks for the CPU), its draws from a CPU ``torch.Generator`` seeded
with ``seed``, and the batches stay there. It is the JAX stack's, not its
random stream: JAX draws from ``jax.random`` keys.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass
from typing import Any, Iterator, Optional

import numpy as np
import torch

from ..data.collate import DataCollatorForInterleavedVideoSeq2Seq, DataCollatorForVideoSeq2Seq
from ..data.prompts import generate_input_ids_and_labels, generate_input_ids_and_labels_from_interleaved
from ..data.text import clean_narration_text
from ..ops.preprocess import apply_train_transform, draw_train_transform, process_videos

# Based on prompts from InstructBLIP (reference train_v2.py:30-42)
PROMPTS = [
    "What is the camera wearer doing?",
    "Question: What is the camera wearer doing?",
    "What is the camera wearer doing? An answer to the question is",
    "Q: What is the camera wearer doing? A:",
    "Given the video, answer the following question. What is the camera wearer doing?",
    "Based on the video, respond to this question: What is the camera wearer doing? "
    "Answer:",
    "Use the provided video to answer the question: What is the camera wearer doing?",
    'What is the answer to the following question? "What is the camera wearer doing?"',
    'The question "What is the camera wearer doing?" can be answered using the video. '
    "The answer is",
]

# v1's fixed prompt (reference train_v1.py:20)
V1_PROMPT = "Question: What is the camera wearer doing? Answer:"


@dataclass
class InterleavedPreprocessor:
    """datapoint {'items': [...examples, query]} -> tokenized features + raw
    uint8 clip stack (augmentation happens later, on the device)."""

    tokenizer: Any
    num_query_tokens: int
    decoder_only_lm: bool
    rng: _random.Random

    def draw_prompts(self, n_items: int) -> list[str]:
        """The rng-consuming half: one instruction prompt per item, drawn in
        stream order on the coordinating thread (same sequence as serial)."""
        return [self.rng.choice(PROMPTS) for _ in range(n_items)]

    def apply(self, datapoint: dict[str, Any], prompts: list[str]) -> dict[str, Any]:
        """The rng-free half: tokenize + assemble. Worker-thread safe."""
        items = datapoint["items"]
        features = generate_input_ids_and_labels_from_interleaved(
            self.tokenizer,
            [
                (prompt + " " + clean_narration_text(item["narration_text"]), 1)
                for prompt, item in zip(prompts[:-1], items[:-1])
            ]
            + [(prompts[-1], 1)],
            clean_narration_text(items[-1]["narration_text"]),
            self.num_query_tokens,
            self.decoder_only_lm,
        )
        features["pixel_values"] = np.stack([item["video"] for item in items])
        return features

    def __call__(self, datapoint: dict[str, Any]) -> dict[str, Any]:
        return self.apply(datapoint, self.draw_prompts(len(datapoint["items"])))


@dataclass
class V1Preprocessor:
    """Single-video (v1) preprocessing (reference train_v1.py:20-46)."""

    tokenizer: Any
    decoder_only_lm: bool
    prompt: str = V1_PROMPT

    def __call__(self, item: dict[str, Any]) -> dict[str, Any]:
        features = generate_input_ids_and_labels(
            self.tokenizer,
            self.prompt,
            clean_narration_text(item["narration_text"]),
            self.decoder_only_lm,
        )
        features["pixel_values"] = item["video"]
        return features


def _ordered_parallel(fn, tasks, num_workers: int, depth: Optional[int] = None):
    """Map ``fn`` over ``tasks`` on a thread pool, yielding IN ORDER with at
    most ``depth`` items in flight (frame decode and tokenization release the
    GIL in their C cores, so threads scale)."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    depth = depth or num_workers * 2
    with ThreadPoolExecutor(num_workers) as ex:
        pending: deque = deque()
        for t in tasks:
            pending.append(ex.submit(fn, t))
            if len(pending) >= depth:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def train_batch_iterator(
    dataset,
    tokenizer,
    *,
    num_query_tokens: int,
    decoder_only_lm: bool,
    accum_steps: int,
    micro_batch_size: int,
    max_length: int,
    num_frames: int,
    image_size: int = 224,
    augment: bool = True,
    augment_magnitude: float = 5.0,
    seed: int = 0,
    epochs: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    interleaved: bool = True,
    process_index: int = 0,
    process_count: int = 1,
    num_workers: int = 0,
    device="cuda",
) -> Iterator[dict[str, torch.Tensor]]:
    """Yields static-shape batches on ``device``: every tensor (accum, micro,
    ...); token axes padded to ``max_length``; pixel_values (accum,
    micro*videos, C, T, H, W) in ``dtype``.

    Over-long samples are truncated to max_length from the RIGHT for
    labels/ids (keeps the video tokens, which sit at the front); one that
    would lose a video slot raises ``ValueError``.

    Multi-process: pass ``process_index``/``process_count`` and a per-process
    ``micro_batch_size``; each process loads a disjoint strided shard of the
    same seeded shuffle.

    ``num_workers > 0`` overlaps the per-sample frame IO + tokenization on a
    thread pool. The rng-consuming halves (in-context example choice, prompt
    choice) run on the coordinating thread in stream order, so the batches
    are bit-identical to serial iteration for the same seed. Requires a
    dataset exposing ``plan``/``load_plan`` (FrameInterleavedDataset) in
    interleaved mode.
    """
    rng = _random.Random(seed)
    aug_generator = torch.Generator().manual_seed(seed)
    if interleaved:
        pre: Any = InterleavedPreprocessor(tokenizer, num_query_tokens, decoder_only_lm, rng)
        collator: Any = DataCollatorForInterleavedVideoSeq2Seq(
            pad_token_id=tokenizer.pad_token_id, padding_side="right", pad_to_multiple_of=None
        )
    else:
        pre = V1Preprocessor(tokenizer, decoder_only_lm)
        collator = DataCollatorForVideoSeq2Seq(
            pad_token_id=tokenizer.pad_token_id, padding_side="right", pad_to_multiple_of=None
        )

    if num_workers > 0 and not (
        interleaved and hasattr(dataset, "plan") and hasattr(dataset, "load_plan")
    ):
        raise ValueError(
            "num_workers > 0 needs an interleaved dataset with plan/load_plan "
            "(FrameInterleavedDataset); other datasets iterate serially"
        )

    def sample_stream():
        epoch = 0
        while epochs is None or epoch < epochs:
            order = list(range(len(dataset)))
            rng.shuffle(order)
            # every process shuffles identically (same seed), then takes its
            # stride: disjoint shards, no coordination (DistributedSampler)
            shard = order[process_index::process_count]
            if num_workers > 0:
                # all rng draws happen HERE, in stream order; workers only do
                # frame IO + tokenization (load_plan/apply are rng-free)
                def tasks():
                    for i in shard:
                        plan = dataset.plan(i)
                        yield plan, pre.draw_prompts(len(plan[0]) + 1)

                yield from _ordered_parallel(
                    lambda t: pre.apply(dataset.load_plan(t[0]), t[1]), tasks(), num_workers
                )
            else:
                for i in shard:
                    yield pre(dataset[i])
            epoch += 1

    def fix_length(arr: np.ndarray, pad_value: int) -> np.ndarray:
        if arr.shape[1] >= max_length:
            return arr[:, :max_length]
        out = np.full((arr.shape[0], max_length), pad_value, arr.dtype)
        out[:, : arr.shape[1]] = arr
        return out

    def on_device(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(device).reshape(accum_steps, micro_batch_size, max_length)

    stream = sample_stream()
    micro_total = accum_steps * micro_batch_size
    while True:
        feats = []
        try:
            for _ in range(micro_total):
                feats.append(next(stream))
        except StopIteration:
            return
        batch = collator(feats)
        pixels = torch.from_numpy(batch["pixel_values"]).to(device)  # (videos, C, T0, H0, W0) uint8
        if augment:
            proc = torch.stack([
                apply_train_transform(clip, draw_train_transform(aug_generator), num_frames=num_frames,
                                      height=image_size, width=image_size, magnitude=augment_magnitude,
                                      dtype=dtype)
                for clip in pixels
            ])
        else:
            proc = process_videos(pixels, num_frames=num_frames, height=image_size, width=image_size,
                                  dtype=dtype)
        out = {
            "input_ids": on_device(fix_length(batch["input_ids"], tokenizer.pad_token_id)),
            "attention_mask": on_device(fix_length(batch["attention_mask"], 0)),
            "labels": on_device(fix_length(batch["labels"], -100)),
            "pixel_values": proc.reshape(accum_steps, -1, *proc.shape[1:]),
        }
        if "video_input_mask" in batch:
            vim = fix_length(batch["video_input_mask"], 0)
            # the scatter places exactly (num_videos * num_query_tokens)
            # features at the mask positions; a truncated video slot would
            # corrupt training, so fail loudly here instead
            expected = pixels.shape[0] * num_query_tokens
            if int(vim.sum()) != expected:
                raise ValueError(
                    f"max_length={max_length} truncates video token positions "
                    f"({int(vim.sum())} mask slots for {expected} video features); "
                    "raise --max_length"
                )
            out["video_input_mask"] = on_device(vim)
        yield out
