"""Video preprocessing, eval path (counterpart of ``eilev_tpu/ops/preprocess.py``).

(..., C, T, H, W) videos: uniform temporal subsample -> bicubic antialiased
resize -> rescale 1/255 -> CLIP-mean/std normalize, on the device of the input.
The training augmentations of the JAX module are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def uniform_temporal_subsample(video: torch.Tensor, num_samples: int) -> torch.Tensor:
    """pytorchvideo semantics: linspace(0, T-1, num).long() along the T axis of
    (..., C, T, H, W)."""
    t = video.shape[-3]
    idx = torch.linspace(0.0, t - 1, num_samples).long().to(video.device)
    return torch.index_select(video, -3, idx)


@functools.lru_cache(maxsize=64)
def _resize_matrix(in_size: int, out_size: int, antialias: bool) -> np.ndarray:
    """(out, in) separable Keys-cubic (a=-0.5) resampling weights, antialiased
    when downscaling - the same filter family as torchvision/PIL bicubic."""
    scale = out_size / in_size
    kernel_scale = min(scale, 1.0) if antialias else 1.0

    def cubic(x):
        x = np.abs(x)
        a = -0.5
        return np.where(
            x <= 1,
            (a + 2) * x**3 - (a + 3) * x**2 + 1,
            np.where(x < 2, a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a, 0.0),
        )

    out_pos = (np.arange(out_size) + 0.5) / scale - 0.5  # source coords
    in_pos = np.arange(in_size)
    w = cubic((out_pos[:, None] - in_pos[None, :]) * kernel_scale)
    w = w / w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


def resize_video(
    video: torch.Tensor, height: int, width: int, *, antialias: bool = True
) -> torch.Tensor:
    """Bicubic resize of the trailing (H, W) dims as two separable matmuls with
    precomputed cubic weights. Returns float32."""
    *_, h, w = video.shape
    x = video.float()
    if (h, w) == (height, width):
        return x
    wh = torch.from_numpy(_resize_matrix(h, height, antialias)).to(video.device)
    ww = torch.from_numpy(_resize_matrix(w, width, antialias)).to(video.device)
    x = torch.einsum("...hw,oh->...ow", x, wh)
    return torch.einsum("...hw,pw->...hp", x, ww)


def rescale(video: torch.Tensor) -> torch.Tensor:
    return video.float() / 255.0


def normalize(
    video: torch.Tensor,
    mean: Sequence[float] = CLIP_MEAN,
    std: Sequence[float] = CLIP_STD,
) -> torch.Tensor:
    """Channel-first normalize over (..., C, T, H, W)."""
    mean_t = torch.tensor(mean, dtype=video.dtype, device=video.device).reshape(-1, 1, 1, 1)
    std_t = torch.tensor(std, dtype=video.dtype, device=video.device).reshape(-1, 1, 1, 1)
    return (video - mean_t) / std_t


def process_videos(
    videos: torch.Tensor,
    num_frames: Optional[int] = None,
    height: int = 224,
    width: int = 224,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, C, T, H, W) uint8 -> subsample -> resize -> rescale -> normalize ->
    (B, C, num_frames, height, width) in ``dtype``. The resize is skipped when
    the size already matches, as in the JAX function."""
    x = videos
    if num_frames is not None:
        x = uniform_temporal_subsample(x, num_frames)
    if tuple(x.shape[-2:]) != (height, width):
        x = resize_video(x, height, width)
    x = rescale(x)
    x = normalize(x)
    return x.to(dtype)
