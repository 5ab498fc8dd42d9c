"""8-second narrated-action clip sampling (a copy of
``eilev_tpu/data/clip_sampler.py``; the port imports nothing of
``eilev_tpu``).

Parity target: ``NarratedActionClipSampler`` (reference eilev/data/utils.py:244-313):
clips are 8 s centered on ``narration_timestamp_sec``, clamped into [0, duration];
per video, actions are visited once each, optionally in shuffled order, resetting
after the last clip. Framework-free and RNG-injectable.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass
from fractions import Fraction
from typing import Any, Optional, Union

Seconds = Union[float, Fraction]

CLIP_DURATION_SEC = 8


@dataclass
class ClipInfo:
    clip_start_sec: Seconds
    clip_end_sec: Seconds
    clip_index: int
    aug_index: int
    is_last_clip: bool


class NarratedActionClipSampler:
    def __init__(self, random: bool, rng: Optional[_random.Random] = None) -> None:
        """:param random: visit a video's narrated actions in shuffled order."""
        self.random = random
        self.rng = rng if rng is not None else _random.Random()
        self._clip_duration = Fraction(CLIP_DURATION_SEC)
        self._current_clip_index = 0
        self.sample_clip_indices: Optional[list[int]] = None

    def __call__(
        self,
        last_clip_time: Seconds,
        video_duration: Seconds,
        annotation: dict[str, Any],
    ) -> ClipInfo:
        del last_clip_time  # unused, mirrors the reference signature
        if self.sample_clip_indices is None:
            self.sample_clip_indices = list(range(len(annotation["narrated_actions"])))
            if self.random:
                self.rng.shuffle(self.sample_clip_indices)

        clip_index = self.sample_clip_indices[self._current_clip_index]
        narrated_action = annotation["narrated_actions"][clip_index]
        self._current_clip_index += 1
        is_last_clip = self._current_clip_index == len(self.sample_clip_indices)

        # 8 s window centered on the narration timestamp, clamped into the video
        clip_start_sec = max(
            Fraction(narrated_action["narration_timestamp_sec"]) - self._clip_duration / 2,
            Fraction(0),
        )
        clip_end_sec = clip_start_sec + self._clip_duration
        if clip_end_sec > video_duration:
            clip_end_sec = Fraction(video_duration)
            clip_start_sec = clip_end_sec - self._clip_duration

        if is_last_clip:
            self.reset()

        return ClipInfo(clip_start_sec, clip_end_sec, clip_index, 0, is_last_clip)

    def reset(self) -> None:
        self._current_clip_index = 0
        self.sample_clip_indices = None
