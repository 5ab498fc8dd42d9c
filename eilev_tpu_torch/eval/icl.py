"""In-context-learning verb/noun classification eval (counterpart of
``eilev_tpu/eval/icl.py``).

The EMNLP paper's headline classification protocol (the original EILeV's
scripts/general/icl_eval.py):

  1. per datapoint, draw ``num_shot`` few-shot examples from the train split
     (random sampling with replacement, icl_eval.py:206-224);
  2. classify the VERB by scoring the verb prompts as continuations of
     "...Answer: The camera wearer" with :func:`eilev_tpu_torch.generation.classify`;
  3. classify the NOUN by scoring the noun prompts as continuations of
     "...The camera wearer {predicted verb}" (two-stage, icl_eval.py:239-313);
  4. macro F1 over the Ego4D fho-lta taxonomy for both.

A batch of datapoints is classified in one ``classify`` call, its prompts
left-padded to a shared 64-multiple bucket. The evaluator runs on the card
unless the caller passes ``device="cpu"``; the model must be on that device.
Class-prompt CSVs (``prompt,structured_verb`` / ``prompt,structured_noun``,
vendored under ``scripts/ego4d/eval-data``) and the fho_main JSON are data
the user supplies.
"""

from __future__ import annotations

import csv
import json
import random as _random
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..data.collate import _pad_1d
from ..data.prompts import generate_input_ids_and_labels_from_interleaved
from ..data.text import clean_narration_text
from ..generation.classify import classify
from ..ops.preprocess import process_videos
from ..serving.feature_cache import VideoFeatureCache
from .metrics import MulticlassF1

FEW_SHOT_PROMPT = "Question: What is the camera wearer doing? Answer:"


def load_narrated_action_verb_noun(fho_main_path: str) -> dict[str, dict[str, str]]:
    """frame_path -> {structured_verb, structured_noun} from Ego4D fho_main.json,
    keeping only actions with a usable verb and a pnr-frame object_of_change noun
    (reference icl_eval.py:25-53)."""
    with open(fho_main_path) as f:
        fho_main = json.load(f)
    out: dict[str, dict[str, str]] = defaultdict(dict)
    for video in fho_main["videos"]:
        for interval in video["annotated_intervals"]:
            for i, action in enumerate(interval["narrated_actions"]):
                if action["structured_verb"] in {"None", "[other]", "cross"}:
                    continue
                if action["frames"] is None:
                    continue
                for frame in action["frames"]:
                    if frame["frame_type"] != "pnr_frame":
                        continue
                    for box in frame["boxes"]:
                        if (
                            box["object_type"] == "object_of_change"
                            and box["structured_noun"] is not None
                        ):
                            out[f"{video['video_uid']}|{i}"] = {
                                "structured_verb": action["structured_verb"],
                                "structured_noun": box["structured_noun"],
                            }
                            break
    return out


def add_and_filter_verb_noun(verb_noun_map, dataset, num_eval_datapoints: int = 0):
    """Keep only datapoints with taxonomy labels; stamp the labels on (reference
    icl_eval.py:56-78)."""
    filtered = [d for d in dataset.data if d["frame_path"] in verb_noun_map]
    if num_eval_datapoints > 0:
        filtered = filtered[:num_eval_datapoints]
    for d in filtered:
        d.update(verb_noun_map[d["frame_path"]])
    dataset.data = filtered
    dataset.dict_data = {d["frame_path"]: d for d in filtered}
    return dataset


def load_prompt_map(path: str, value_column: str) -> dict[str, str]:
    """CSV 'prompt,<value_column>' -> {prompt: class}."""
    with open(path, newline="") as f:
        return {row["prompt"]: row[value_column] for row in csv.DictReader(f)}


@dataclass
class IclEvalResult:
    verb_f1: float
    noun_f1: float
    verb_predictions: list[dict] = field(default_factory=list)
    noun_predictions: list[dict] = field(default_factory=list)


class IclEvaluator:
    """Two-stage verb->noun ICL classification over a FrameDataset."""

    def __init__(
        self,
        model,
        tokenizer,
        *,
        verb_prompts: dict[str, str],
        noun_prompts: dict[str, str],
        verbs: Sequence[str],
        nouns: Sequence[str],
        num_shot: int,
        class_batch_size: Optional[int] = None,
        few_shot_prompt: str = FEW_SHOT_PROMPT,
        rng: Optional[_random.Random] = None,
        dtype: torch.dtype = torch.float32,
        vision_cache: Optional[int] = None,
        frame_loader: Optional[Callable[[str], np.ndarray]] = None,
        device="cuda",
    ):
        self.model = model
        self.tokenizer = tokenizer
        self.verb_prompts = verb_prompts
        self.noun_prompts = noun_prompts
        self.verbs = list(verbs)
        self.nouns = list(nouns)
        self.num_shot = num_shot
        self.class_batch_size = class_batch_size
        self.few_shot_prompt = few_shot_prompt
        self.rng = rng if rng is not None else _random.Random(42)
        self.dtype = dtype
        self.device = torch.device(device)
        cfg = model.config
        self.num_query_tokens = cfg.num_query_tokens
        self.image_size = cfg.vision_config.image_size
        self._class_cache: dict[tuple, tuple] = {}
        # vision_cache: LRU capacity in videos of a VideoFeatureCache, so the
        # noun stage reuses the verb stage's features and recurring few-shot
        # videos are encoded once (None: every classify call encodes its
        # videos). frame_loader (with vision_cache) makes the pixel supply
        # lazy: datasets return metadata only, and the cache loads its misses
        self._feature_cache = None
        self._frame_loader = frame_loader
        if vision_cache:
            self._feature_cache = VideoFeatureCache(
                model, capacity=vision_cache, preprocess=self._process
            )
        elif frame_loader is not None:
            raise ValueError("frame_loader requires vision_cache")

    def _process(self, videos: torch.Tensor) -> torch.Tensor:
        img = self.image_size
        return process_videos(videos, height=img, width=img, dtype=self.dtype)

    # -- preprocessing -------------------------------------------------

    def _tokenize_classes(self, classes: list[str]) -> tuple[np.ndarray, np.ndarray]:
        key = tuple(classes)
        if key not in self._class_cache:
            # leading space: the tokenizer treats space-prefixed words as
            # separate tokens (reference icl_eval.py:123-131)
            enc = [
                self.tokenizer(" " + c, add_special_tokens=False)["input_ids"]
                for c in classes
            ]
            longest = max(len(e) for e in enc)
            ids = np.stack(
                [_pad_1d(np.asarray(e), longest, self.tokenizer.pad_token_id, "right") for e in enc]
            )
            mask = np.stack(
                [_pad_1d(np.ones(len(e), np.int64), longest, 0, "right") for e in enc]
            )
            self._class_cache[key] = (ids, mask)
        return self._class_cache[key]

    def _build_prompt(self, prompt: str, datapoint: dict, few_shot: list[dict]):
        few_shot_prompts = [
            (
                " ".join([self.few_shot_prompt, clean_narration_text(ex["narration_text"])]),
                1,
            )
            for ex in few_shot
        ]
        built = generate_input_ids_and_labels_from_interleaved(
            self.tokenizer,
            few_shot_prompts + [(prompt, 1)],
            None,
            self.num_query_tokens,
            True,
        )
        if self._frame_loader is not None:
            return built, None  # lazy: the feature cache loads its misses
        videos = np.stack([ex["video"] for ex in few_shot] + [datapoint["video"]])
        return built, self._process(torch.from_numpy(videos).to(self.device))

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(array, np.int64)).to(self.device)

    def _classify_batch(
        self,
        prompts: list[str],
        datapoints: list[dict],
        few_shots: list[list[dict]],
        classes: list[str],
        video_keys: Optional[list] = None,
    ) -> list[int]:
        """Classify a batch of datapoints in one ``classify`` call, the prompts
        left-padded to a shared bucket (classify requires left padding)."""
        builts, pixels = [], []
        for prompt, dp, fs in zip(prompts, datapoints, few_shots):
            built, pixel = self._build_prompt(prompt, dp, fs)
            builts.append(built)
            pixels.append(pixel)
        # the prompt length rounded up to a multiple of 64, as in JAX (where
        # it bounds recompiles)
        longest = max(len(b["input_ids"]) for b in builts)
        bucket = ((longest + 63) // 64) * 64
        ids = np.stack(
            [_pad_1d(b["input_ids"], bucket, self.tokenizer.pad_token_id, "left") for b in builts]
        )
        mask = np.stack(
            [_pad_1d(np.ones(len(b["input_ids"]), np.int64), bucket, 0, "left") for b in builts]
        )
        vim = np.stack([_pad_1d(b["video_input_mask"], bucket, 0, "left") for b in builts])
        pixel = None if pixels[0] is None else torch.cat(pixels, dim=0)
        video_features = None
        if self._feature_cache is not None and video_keys is not None:
            video_features = self._feature_cache.features(
                video_keys, pixel, loader=self._frame_loader
            )
            pixel = None
        class_ids, class_mask = self._tokenize_classes(classes)
        ll = classify(
            self.model,
            prompt_input_ids=self._tensor(ids),
            class_input_ids=self._tensor(class_ids),
            prompt_attention_mask=self._tensor(mask),
            pixel_values=pixel,
            prompt_video_input_mask=self._tensor(vim),
            class_attention_mask=self._tensor(class_mask),
            class_batch_size=self.class_batch_size,
            video_features=video_features,
        )
        # numpy's argmax (the first maximum; the first NaN of a NaN row), as in JAX
        return [int(i) for i in ll.float().cpu().numpy().argmax(axis=-1)]

    # -- evaluation loop ------------------------------------------------

    def evaluate(
        self,
        eval_dataset,
        train_dataset,
        *,
        progress: bool = False,
        batch_size: int = 1,
    ) -> IclEvalResult:
        verb_list = list(self.verb_prompts.keys())
        noun_list = list(self.noun_prompts.keys())
        verb_id = {v: i for i, v in enumerate(self.verbs)}
        noun_id = {n: i for i, n in enumerate(self.nouns)}
        verb_f1 = MulticlassF1(len(self.verbs))
        noun_f1 = MulticlassF1(len(self.nouns))
        result = IclEvalResult(0.0, 0.0)

        starts = range(0, len(eval_dataset), batch_size)
        if progress:
            try:
                from tqdm import tqdm

                starts = tqdm(starts, desc="Evaluating")
            except ImportError:
                pass

        for s in starts:
            idx = list(range(s, min(s + batch_size, len(eval_dataset))))
            datapoints = [eval_dataset[i] for i in idx]
            # random sampling with replacement (icl_eval.py:206-224)
            few_shots = [
                [train_dataset[self.rng.randrange(len(train_dataset))] for _ in range(self.num_shot)]
                for _ in idx
            ]
            # video order matches _build_prompt's pixel stacking: per row,
            # the few-shot examples then the query
            video_keys = None
            if self._feature_cache is not None:
                video_keys = [
                    ex["frame_path"]
                    for fs, dp in zip(few_shots, datapoints)
                    for ex in [*fs, dp]
                ]
            # stage 1: verb
            pv_idx = self._classify_batch(
                [self.few_shot_prompt + " The camera wearer"] * len(idx),
                datapoints,
                few_shots,
                verb_list,
                video_keys=video_keys,
            )
            pred_verb_prompts = [verb_list[i] for i in pv_idx]
            for dp, pvp in zip(datapoints, pred_verb_prompts):
                pred_verb = self.verb_prompts[pvp]
                verb_f1([verb_id[pred_verb]], [verb_id[dp["structured_verb"]]])
                result.verb_predictions.append(
                    {
                        "frame_path": dp["frame_path"],
                        "structured_verb": dp["structured_verb"],
                        "predicted_verb_prompt": pvp,
                        "prediction": pred_verb,
                    }
                )
            # stage 2: noun, conditioned on each datapoint's predicted verb prompt
            pn_idx = self._classify_batch(
                [
                    self.few_shot_prompt + f" The camera wearer {pvp}"
                    for pvp in pred_verb_prompts
                ],
                datapoints,
                few_shots,
                noun_list,
                video_keys=video_keys,
            )
            for dp, ni in zip(datapoints, pn_idx):
                pred_noun_prompt = noun_list[ni]
                pred_noun = self.noun_prompts[pred_noun_prompt]
                noun_f1([noun_id[pred_noun]], [noun_id[dp["structured_noun"]]])
                result.noun_predictions.append(
                    {
                        "frame_path": dp["frame_path"],
                        "structured_noun": dp["structured_noun"],
                        "predicted_noun_prompt": pred_noun_prompt,
                        "prediction": pred_noun,
                    }
                )

        result.verb_f1 = verb_f1.compute()
        result.noun_f1 = noun_f1.compute()
        return result
