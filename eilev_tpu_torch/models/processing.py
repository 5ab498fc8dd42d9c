"""Processor shim: the ``process()`` convenience API (counterpart of
``eilev_tpu/models/processing.py``).

One call prepares both modalities, as the original EILeV's
``eilev/model/utils.py:process`` does: the (B, C, T, H, W) uint8 video through
the Blip2 image pipeline (resize to 224 bicubic -> rescale -> CLIP normalize)
over every frame, here ``ops/preprocess.process_videos`` on the model's
device, and the optional text tokenized and right-padded to the longest.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Union

import numpy as np
import torch

from ..configs import VideoBlipConfig
from ..ops.preprocess import process_videos


@dataclass
class VideoBlipProcessor:
    """Bundles a tokenizer with the video pipeline.

    ``__call__(video=..., text=...)`` returns a dict with ``pixel_values``
    (B, C, T, H, W) in ``dtype`` and, when text is given, ``input_ids`` /
    ``attention_mask`` (int64), every tensor on ``device`` (the card unless
    the caller asks for the CPU).
    """

    tokenizer: Any
    image_size: int = 224
    dtype: torch.dtype = torch.float32
    device: Union[str, torch.device] = "cuda"

    @classmethod
    def from_config(cls, tokenizer, config: VideoBlipConfig, dtype: torch.dtype = torch.float32,
                    device: Union[str, torch.device] = "cuda") -> "VideoBlipProcessor":
        return cls(tokenizer, image_size=config.vision_config.image_size, dtype=dtype, device=device)

    def __call__(
        self,
        video: Optional[Union[np.ndarray, torch.Tensor]] = None,
        text: Optional[Union[str, list[str]]] = None,
    ) -> dict[str, torch.Tensor]:
        out: dict[str, torch.Tensor] = {}
        if video is not None:
            video = torch.as_tensor(video).to(self.device)
            if video.ndim == 4:  # (C, T, H, W) -> add batch
                video = video[None]
            out["pixel_values"] = process_videos(
                video, height=self.image_size, width=self.image_size, dtype=self.dtype
            )
        if text is not None:
            texts = [text] if isinstance(text, str) else list(text)
            enc = [self.tokenizer(t)["input_ids"] for t in texts]
            longest = max(len(e) for e in enc)
            ids = torch.full((len(enc), longest), self.tokenizer.pad_token_id, dtype=torch.int64)
            mask = torch.zeros((len(enc), longest), dtype=torch.int64)
            for i, e in enumerate(enc):
                ids[i, : len(e)] = torch.as_tensor(e, dtype=torch.int64)
                mask[i, : len(e)] = 1
            out["input_ids"] = ids.to(self.device)
            out["attention_mask"] = mask.to(self.device)
        return out
