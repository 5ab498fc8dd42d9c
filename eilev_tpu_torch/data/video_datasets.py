"""On-the-fly video datasets: Ego4D fho + EPIC-KITCHENS over the native decoder
(a copy of ``eilev_tpu/data/video_datasets.py`` over the port's own
``eilev_tpu_torch/native`` decoder; the port imports nothing of
``eilev_tpu``).

Parity targets: ``Ego4dFHOMainDataset`` (reference eilev/data/ego4d.py:37-109)
and ``EpicKitchensDataset`` (reference eilev/data/epic_kitchens.py:14-121),
which subclass pytorchvideo's ``LabeledVideoDataset`` (ffmpeg decode through PyAV
DataLoader workers). Here the decode path is this framework's own C++ libav stage
(eilev_tpu_torch/native) behind a generic :class:`ClipIterableDataset` that walks
(video, annotation) pairs with :class:`NarratedActionClipSampler` - one 8s
uniform clip per narrated action, sequential or shuffled per video.
"""

from __future__ import annotations

import csv
import json
import os
import random as _random
import re
from collections import defaultdict
from collections.abc import Callable, Iterator
from typing import Any, Optional

from .clip_sampler import NarratedActionClipSampler
from .text import C_REGEX, parse_timestamp


def filter_action(action: dict[str, Any]) -> bool:
    """Keep accepted, valid, camera-wearer ('#C C ...') actions
    (reference ego4d.py:12-18)."""
    return (
        not action["is_rejected"]
        and action["is_valid_action"]
        and C_REGEX.match(action["narration_text"]) is not None
    )


def get_structured_noun(action: dict) -> Optional[str]:
    """structured_noun of the object_of_change box on the pnr frame
    (reference ego4d.py:21-34)."""
    if action["frames"] is None:
        return None
    for frame in action["frames"]:
        if frame["frame_type"] != "pnr_frame":
            continue
        for box in frame["boxes"]:
            if box["object_type"] == "object_of_change" and box["structured_noun"] is not None:
                return box["structured_noun"]
    return None


class ClipIterableDataset:
    """Iterates (video_path, {narrated_actions, ...}) pairs, decoding one clip
    per narrated action with the native decoder.

    Yields dicts: the narrated action's fields + any video-level extras +
    ``video``: (C, T, H, W) uint8 (``num_frames`` uniform samples of the 8 s
    window; 0 = decode at the native frame positions of the window, then the
    caller subsamples).
    """

    def __init__(
        self,
        labeled_video_paths: list[tuple[str, dict[str, Any]]],
        *,
        num_frames: int,
        random_clip: bool = False,
        transform: Optional[Callable[[dict], Any]] = None,
        decode_height: int = 0,
        decode_width: int = 0,
        rng: Optional[_random.Random] = None,
    ) -> None:
        self._paths = labeled_video_paths
        self.num_frames = num_frames
        self.random_clip = random_clip
        self._transform = transform
        self.decode_height = decode_height
        self.decode_width = decode_width
        self.rng = rng if rng is not None else _random.Random()
        self.num_clips = sum(len(ann["narrated_actions"]) for _, ann in labeled_video_paths)

    def __len__(self) -> int:
        return self.num_clips

    def __iter__(self) -> Iterator[dict[str, Any]]:
        from ..native import VideoDecoder

        sampler = NarratedActionClipSampler(self.random_clip, rng=self.rng)
        for video_path, annotation in self._paths:
            if not annotation["narrated_actions"]:
                continue
            with VideoDecoder(video_path) as dec:
                duration = dec.duration
                while True:
                    info = sampler(0.0, duration, annotation)
                    action = annotation["narrated_actions"][info.clip_index]
                    video = dec.decode_clip(
                        float(info.clip_start_sec),
                        float(info.clip_end_sec),
                        self.num_frames,
                        height=self.decode_height,
                        width=self.decode_width,
                    )
                    item = {
                        k: v for k, v in annotation.items() if k != "narrated_actions"
                    }
                    item.update(action)
                    item["clip_index"] = info.clip_index
                    item["video"] = video
                    if self._transform is not None:
                        item = self._transform(item)
                    yield item
                    if info.is_last_clip:
                        break


class Ego4dFHOMainDataset(ClipIterableDataset):
    """Ego4D fho_main narrated actions from full_scale mp4s
    (reference ego4d.py:37-109)."""

    def __init__(
        self,
        annotation_path: str,
        split_path: str,
        video_dir_path: str,
        *,
        num_frames: int = 8,
        transform: Optional[Callable[[dict], Any]] = None,
        random_clip: bool = False,
        decode_height: int = 0,
        decode_width: int = 0,
        rng: Optional[_random.Random] = None,
    ) -> None:
        with open(annotation_path) as f:
            annotations = json.load(f)
        video_dict = {v["video_uid"]: v for v in annotations["videos"]}
        with open(split_path) as f:
            split_data = json.load(f)
        self.split = split_data["split"]

        paths = [
            (
                os.path.join(video_dir_path, video_uid + ".mp4"),
                {
                    "narrated_actions": [
                        {
                            "narration_timestamp_sec": a["narration_timestamp_sec"],
                            "narration_text": a["narration_text"],
                            "structured_verb": a["structured_verb"],
                            "structured_noun": get_structured_noun(a),
                        }
                        for interval in video_dict[video_uid]["annotated_intervals"]
                        for a in interval["narrated_actions"]
                        if filter_action(a)
                    ],
                    "video_uid": video_uid,
                },
            )
            for video_uid in split_data["videos"]
        ]
        super().__init__(
            paths,
            num_frames=num_frames,
            random_clip=random_clip,
            transform=transform,
            decode_height=decode_height,
            decode_width=decode_width,
            rng=rng,
        )


class EpicKitchensDataset(ClipIterableDataset):
    """EPIC-KITCHENS 55/100 narrations (reference epic_kitchens.py:14-121)."""

    ONE_HUNDRED_REGEX = re.compile(r"P\d\d_1\d\d")

    def __init__(
        self,
        annotation_path: str,
        epic_kitchen_55_video_dir_path: str,
        epic_kitchen_100_video_dir_path: str,
        *,
        num_frames: int = 8,
        transform: Optional[Callable[[dict], Any]] = None,
        random_clip: bool = False,
        decode_height: int = 0,
        decode_width: int = 0,
        rng: Optional[_random.Random] = None,
    ) -> None:
        video_dict: dict[str, list[dict[str, Any]]] = defaultdict(list)
        with open(annotation_path) as f:
            for row in csv.DictReader(f):
                if row.get("narration_timestamp"):
                    row["narration_timestamp_sec"] = parse_timestamp(row["narration_timestamp"])
                else:
                    # no narration timestamp: use the clip midpoint
                    row["narration_timestamp_sec"] = (
                        parse_timestamp(row["start_timestamp"])
                        + parse_timestamp(row["stop_timestamp"])
                    ) / 2
                video_dict[row["video_id"]].append(row)

        paths: list[tuple[str, dict]] = []
        for video_id, narration_data in video_dict.items():
            participant_id = video_id.split("_")[0]
            if self.ONE_HUNDRED_REGEX.match(video_id):
                video_path = os.path.join(
                    epic_kitchen_100_video_dir_path, participant_id, "videos", video_id + ".MP4"
                )
            else:
                # EK-55 videos may sit in train/ or test/ regardless of the
                # EK-100 annotation split
                video_path = os.path.join(
                    epic_kitchen_55_video_dir_path, "videos/train", participant_id, video_id + ".MP4"
                )
                if not os.path.exists(video_path):
                    video_path = os.path.join(
                        epic_kitchen_55_video_dir_path, "videos/test", participant_id, video_id + ".MP4"
                    )
                    if not os.path.exists(video_path):
                        raise FileNotFoundError(f"Video file {video_id}.MP4 not found.")
            paths.append((video_path, {"narrated_actions": narration_data}))

        super().__init__(
            paths,
            num_frames=num_frames,
            random_clip=random_clip,
            transform=transform,
            decode_height=decode_height,
            decode_width=decode_width,
            rng=rng,
        )
