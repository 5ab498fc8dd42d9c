"""Frame datasets: pre-extracted clip frames + ICL example sampling (a copy of
``eilev_tpu/data/frame.py``, kept here because the port imports nothing of
``eilev_tpu``).

Parity targets (the original EILeV's eilev/data/frame.py):
  - FrameDataset (:14-75): reads ``narrated_actions.csv`` (schema written by the
    frame-extraction tool: frame_path, video_uid, clip_index,
    narration_timestamp_sec, narration_text, structured_verb, structured_noun)
    and loads each clip's frame directory (``{video_uid}|{clip_index}/...png``)
    as a (C, T, H, W) uint8 array; int or frame_path-string indexing; optional
    data_filter / transform / return_frames.
  - FrameInterleavedDataset (:78-305): per query, samples k in-context examples
    by verb/noun buckets - verb bucket = same structured_verb but different noun,
    noun bucket = same noun but different verb, drawn at ``verb_noun_ratio``,
    falling back to the rest of the dataset; optional pure-random sampling;
    optional upsampling to ``target_dataset_len`` by (verb, noun) action bucket;
    returns {"items": [shuffled examples..., query]}.
  - FrameInterleavedPresampledDataset (:308-398): JSONL in-context->query map
    ({"context": [frame_paths], "query": frame_path}); optional derangement
    shuffle of example frames for ablations.

Design deltas from the reference (intentional):
  - torch-free: frames load via imageio into numpy uint8;
  - explicit ``rng: random.Random`` injection instead of the global ``random``
    module, so sampling is reproducible per worker/epoch without monkeypatching
    (the reference's tests patch ``random.sample`` to get determinism).
"""

from __future__ import annotations

import json
import random as _random
from collections import defaultdict
from collections.abc import Callable
from csv import DictReader
from pathlib import Path
from typing import Any, Optional, Union

import numpy as np


def load_frame_video(frames_dir: Path) -> np.ndarray:
    """Load a clip's frame directory into (C, T, H, W) uint8.

    Two on-disk formats (same directory/CSV contract either way):
      - raw: one ``{frame_path}.npy`` holding the whole clip as (C, T, H, W)
        uint8, written by ``extract_frames.py --format raw``. Preferred when
        present: loading is a straight read with ZERO decode work — PNG
        decode is the measured host input bottleneck (~0.25-0.8 datapoints/s
        per core serial), and the raw cache removes it rather
        than hiding it behind worker threads.
      - png: per-frame ``{frame_path}|{i}.png`` files (the reference's format,
        ``scripts/ego4d/extract_frames.py:33-46``), sorted by trailing index.
    """
    raw = frames_dir / f"{frames_dir.name}.npy"
    if raw.exists():
        video = np.load(raw)
        if video.dtype != np.uint8 or video.ndim != 4:
            raise ValueError(f"{raw}: expected 4D uint8 (C, T, H, W), got "
                             f"{video.dtype} {video.shape}")
        return video

    import imageio.v3 as iio

    files = sorted(
        frames_dir.glob("*.png"),
        key=lambda p: int(p.stem.rsplit("|", 1)[-1]),
    )
    if not files:
        raise FileNotFoundError(f"no frames under {frames_dir}")
    frames = np.stack([iio.imread(f) for f in files])  # (T, H, W, C)
    return np.ascontiguousarray(frames.transpose(3, 0, 1, 2))


def save_frame_video(
    frames_dir: Path,
    frame_path: str,
    video_u8: np.ndarray,
    fmt: str = "png",
    pool=None,
) -> None:
    """Write one clip's (C, T, H, W) uint8 frames under
    ``{frames_dir}/{frame_path}`` in either on-disk format (see
    :func:`load_frame_video`). ``pool``: optional executor for parallel
    per-frame PNG encodes (raw format is a single write; PNG encode is the
    expensive path). Round-trips bit-identically in both formats
    (tests/data/test_raw_frame_cache.py)."""
    clip_dir = Path(frames_dir) / frame_path
    clip_dir.mkdir(parents=True, exist_ok=True)
    if fmt == "raw":
        np.save(clip_dir / f"{frame_path}.npy", np.ascontiguousarray(video_u8))
        return
    if fmt != "png":
        raise ValueError(f"unknown frame format {fmt!r}; supported: png, raw")
    import imageio.v3 as iio

    thwc = video_u8.transpose(1, 2, 3, 0)
    jobs = [
        (clip_dir / f"{frame_path}|{i}.png", frame) for i, frame in enumerate(thwc)
    ]
    if pool is None:
        for path, frame in jobs:
            iio.imwrite(path, frame, extension=".png")
    else:
        futures = [
            pool.submit(iio.imwrite, path, frame, extension=".png")
            for path, frame in jobs
        ]
        for f in futures:
            f.result()


class FrameDataset:
    def __init__(
        self,
        frames_dir: str,
        annotation_file: Optional[str] = None,
        transform: Optional[Callable[[dict[str, Any]], Any]] = None,
        data_filter: Optional[Callable[[dict[str, Any]], bool]] = None,
        return_frames: bool = True,
    ) -> None:
        self.frames_dir = Path(frames_dir)
        self.return_frames = return_frames
        self.data: list[dict] = []
        self.dict_data: dict[str, dict] = {}
        annotation_path = (
            self.frames_dir / "narrated_actions.csv"
            if annotation_file is None
            else Path(annotation_file)
        )
        assert annotation_path.exists(), annotation_path
        with open(annotation_path, newline="") as csvfile:
            for row in DictReader(csvfile):
                if data_filter is not None and not data_filter(row):
                    continue
                self.data.append(row)
                self.dict_data[row["frame_path"]] = row
        self._transform = transform

    def __getitem__(self, index: Union[int, str]) -> dict[str, Any]:
        datapoint = self.data[index] if isinstance(index, int) else self.dict_data[index]
        item = {**datapoint}
        if self.return_frames:
            item["video"] = load_frame_video(self.frames_dir / datapoint["frame_path"])
        if self._transform is not None:
            item = self._transform(item)
        return item

    def __len__(self) -> int:
        return len(self.data)


class FrameInterleavedDataset:
    def __init__(
        self,
        frames_dir: str,
        annotation_file: Optional[str] = None,
        in_context_example_frames_dir: Optional[str] = None,
        in_context_example_annotation_file: Optional[str] = None,
        num_in_context_examples_per_sample: int = 4,
        verb_noun_ratio: float = 0.5,
        transform: Optional[Callable[[dict], Any]] = None,
        return_frames: bool = True,
        random_in_context_examples: bool = False,
        target_dataset_len: Optional[int] = None,
        rng: Optional[_random.Random] = None,
    ) -> None:
        self.num_in_context_examples_per_sample = num_in_context_examples_per_sample
        self.verb_noun_ratio = verb_noun_ratio
        self.return_frames = return_frames
        self.random_in_context_examples = random_in_context_examples
        self.rng = rng if rng is not None else _random.Random()
        self._transform = transform

        self._dataset = FrameDataset(
            frames_dir, annotation_file=annotation_file, return_frames=return_frames
        )
        if target_dataset_len is not None and target_dataset_len > len(self._dataset):
            self._upsample_to(target_dataset_len)

        if in_context_example_frames_dir is None:
            self.in_context_examples_from_main_dataset = True
            self._in_context_dataset = self._dataset
        else:
            self.in_context_examples_from_main_dataset = False
            self._in_context_dataset = FrameDataset(
                in_context_example_frames_dir,
                annotation_file=in_context_example_annotation_file,
                return_frames=return_frames,
            )

        # bucket in-context candidates by structured verb/noun. '[other]' is
        # Ego4D's catch-all verb and '' means unknown: both excluded.
        self.structured_verb_buckets: dict[str, set[int]] = defaultdict(set)
        self.structured_noun_buckets: dict[str, set[int]] = defaultdict(set)
        if not random_in_context_examples:
            for i, dp in enumerate(self._in_context_dataset.data):
                if dp["structured_verb"] not in {"", "[other]"}:
                    self.structured_verb_buckets[dp["structured_verb"]].add(i)
                if dp["structured_noun"] != "":
                    self.structured_noun_buckets[dp["structured_noun"]].add(i)

    def _upsample_to(self, target_len: int) -> None:
        """Upsample by (verb, noun) action bucket until the dataset reaches
        target_len (reference frame.py:125-153).

        Kept as ``eilev_tpu/data/frame.py:201-213`` has it, which departs from
        the original EILeV: there ``num_to_sample = max(per_action,
        len(dataset) - target_len)``, here ``min(max(per_action, 1),
        target_len - len(dataset))``. The port follows its reference package."""
        action_buckets: dict[tuple[str, str], list[int]] = defaultdict(list)
        for i, dp in enumerate(self._dataset.data):
            action_buckets[(dp["structured_verb"], dp["structured_noun"])].append(i)
        per_action = (target_len - len(self._dataset)) // len(action_buckets)
        for idx in action_buckets.values():
            if len(self._dataset) >= target_len:
                break
            num_to_sample = min(
                max(per_action, 1), target_len - len(self._dataset)
            )
            sampled: list[int] = []
            while len(sampled) < num_to_sample:
                want = num_to_sample - len(sampled)
                if len(idx) >= want:
                    sampled.extend(self.rng.sample(idx, want))
                else:
                    sampled.extend(idx)
            for i in sampled:
                dp = self._dataset.data[i]
                self._dataset.data.append(dp)
                self._dataset.dict_data[dp["frame_path"]] = dp

    def _sample_bucketed(self, datapoint: dict[str, Any], index: int) -> set[int]:
        """Verb/noun-bucket strategy (reference frame.py:179-266)."""
        ic = self._in_context_dataset

        def eligible(i: int, other_field: str, other_value: str) -> bool:
            if self.in_context_examples_from_main_dataset and i == index:
                return False
            # same verb AND same noun as the query is excluded from both buckets
            return ic.data[i][other_field] != other_value

        verb_bucket = {
            i
            for i in self.structured_verb_buckets.get(datapoint["structured_verb"], set())
            if eligible(i, "structured_noun", datapoint["structured_noun"])
        }
        noun_bucket = {
            i
            for i in self.structured_noun_buckets.get(datapoint["structured_noun"], set())
            if eligible(i, "structured_verb", datapoint["structured_verb"])
        }

        def draw(bucket: set[int], k: int) -> set[int]:
            if len(bucket) >= k:
                samples = set(self.rng.sample(sorted(bucket), k))
            else:
                samples = set(bucket)
            bucket -= samples
            return samples

        examples: set[int] = set()
        remaining = self.num_in_context_examples_per_sample
        while remaining > 0 and (verb_bucket or noun_bucket):
            if verb_bucket and noun_bucket:
                num_verb = int(remaining * self.verb_noun_ratio)
                num_noun = remaining - num_verb
            elif not verb_bucket:
                num_verb, num_noun = 0, remaining
            else:
                num_verb, num_noun = remaining, 0
            examples |= draw(verb_bucket, num_verb)
            examples |= draw(noun_bucket, num_noun)
            remaining = self.num_in_context_examples_per_sample - len(examples)

        if remaining > 0:
            # not enough in the buckets: sample from the rest of the dataset,
            # still excluding the query itself and exact (verb, noun) matches
            rest = {
                i
                for i in range(len(ic))
                if not (
                    (self.in_context_examples_from_main_dataset and i == index)
                    or i in examples
                    or (
                        ic.data[i]["structured_verb"] == datapoint["structured_verb"]
                        and ic.data[i]["structured_noun"] == datapoint["structured_noun"]
                    )
                )
            }
            examples |= draw(rest, remaining)
        return examples

    def plan(self, index: int) -> tuple[list[int], int]:
        """The rng-consuming half of ``__getitem__``: choose and order the
        in-context examples from metadata alone (no frame IO). Exists so a
        parallel loader can draw ALL randomness on the coordinating thread in
        stream order — keeping the seeded rng sequence identical to serial
        iteration — and ship only :meth:`load_plan` (pure IO) to workers
        (training/data_module.py ``num_workers``)."""
        row = self._dataset.data[index]
        if self.random_in_context_examples:
            pool = [
                i
                for i in range(len(self._in_context_dataset))
                if not self.in_context_examples_from_main_dataset or i != index
            ]
            examples = set(
                self.rng.sample(pool, self.num_in_context_examples_per_sample)
            )
            ordered = list(examples)
        else:
            examples = self._sample_bucketed(row, index)
            # shuffle the in-context examples; the query always goes last
            ordered = self.rng.sample(sorted(examples), len(examples))
        return ordered, index

    def load_plan(self, plan: tuple[list[int], int]) -> dict[str, Any]:
        """The IO half of ``__getitem__``: load frames for a :meth:`plan`.
        Consumes no rng — safe to run on worker threads in any order."""
        ordered, index = plan
        item = {
            "items": [self._in_context_dataset[i] for i in ordered]
            + [self._dataset[index]]
        }
        if self._transform is not None:
            item = self._transform(item)
        return item

    def __getitem__(self, index: int) -> dict[str, Any]:
        return self.load_plan(self.plan(index))

    def __len__(self) -> int:
        return len(self._dataset)


class FrameInterleavedPresampledDataset:
    def __init__(
        self,
        frames_dir: str,
        in_context_query_map_file_path: str,
        in_context_example_frames_dir: str,
        annotation_file: Optional[str] = None,
        in_context_example_annotation_file: Optional[str] = None,
        transform: Optional[Callable[[dict], Any]] = None,
        return_frames: bool = True,
        shuffle_in_context_example_frames: bool = False,
        rng: Optional[_random.Random] = None,
    ) -> None:
        self.return_frames = return_frames
        self.shuffle_in_context_example_frames = shuffle_in_context_example_frames
        self.rng = rng if rng is not None else _random.Random()
        self._transform = transform
        self._dataset = FrameDataset(
            frames_dir, annotation_file=annotation_file, return_frames=return_frames
        )
        self._in_context_dataset = FrameDataset(
            in_context_example_frames_dir,
            annotation_file=in_context_example_annotation_file,
            return_frames=return_frames,
        )
        self._in_context_query_map: list[dict[str, Any]] = []
        with open(in_context_query_map_file_path) as f:
            for line in f:
                self._in_context_query_map.append(json.loads(line))

    def _derangement(self, n: int) -> list[int]:
        """Permutation with no fixed points (used by the frame-shuffle ablation,
        reference frame.py:364-389). Expected ~e retries."""
        idx = list(range(n))
        while True:
            shuffled = idx[:]
            self.rng.shuffle(shuffled)
            if all(a != b for a, b in zip(idx, shuffled)):
                return shuffled

    def __getitem__(self, index: int) -> dict[str, Any]:
        entry = self._in_context_query_map[index]
        examples = [self._in_context_dataset[k] for k in entry["context"]]
        if self.shuffle_in_context_example_frames and len(examples) > 1:
            order = self._derangement(len(examples))
            videos = [examples[i]["video"] for i in order]
            for example, vid in zip(examples, videos):
                example["video"] = vid
        item = {"items": examples + [self._dataset[entry["query"]]]}
        if self._transform is not None:
            item = self._transform(item)
        return item

    def __len__(self) -> int:
        return len(self._in_context_query_map)
