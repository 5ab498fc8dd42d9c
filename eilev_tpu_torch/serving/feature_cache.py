"""Cross-request video-feature cache: encode each distinct video once
(counterpart of ``eilev_tpu/serving/feature_cache.py``).

The two-stage ICL eval scores the same 17 videos of a datapoint twice (the
verb stage, then the noun stage), and across an eval set the in-context
example videos recur. This cache keeps, per video identity (any hashable key:
``frame_path`` in the eval), the video's ``encode_videos`` output after the
language projection, (num_query_tokens, text_hidden), on the model's device,
in least-recently-used order up to ``capacity`` videos.

Misses are encoded in fixed buckets of ``bucket`` videos (the last one
zero-padded), which also caps the vision tower's activation peak. Each
video's features are independent of its batch-mates, so they equal the
in-prompt encode up to the products' batch-size-dependent summation order.
With ``features(keys, loader=...)`` the pixel supply is lazy: frames are
loaded for the missed keys only.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable, Optional, Sequence

import numpy as np
import torch


class VideoFeatureCache:
    """LRU cache of per-video Q-Former features, keyed by caller identity.

    Usage::

        cache = VideoFeatureCache(model)
        feats = cache.features(frame_paths, pixel_values)  # (V*Q, text_hidden)
        generate(model, ..., video_features=feats)
    """

    def __init__(
        self,
        model,
        *,
        capacity: int = 2048,
        bucket: int = 8,
        preprocess: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if bucket < 1:
            raise ValueError(f"bucket must be >= 1, got {bucket}")
        self.model = model
        self.capacity = capacity
        self.bucket = bucket
        # applied to each stacked miss bucket ((bucket, C, T, H, W)) of raw
        # frames before encoding, e.g. ops.preprocess.process_videos; used on
        # the lazy ``loader=`` path only (``pixel_values`` rows are assumed
        # preprocessed)
        self.preprocess = preprocess
        self._store: OrderedDict[Hashable, torch.Tensor] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._store

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def features(
        self,
        keys: Sequence[Hashable],
        pixel_values: Optional[torch.Tensor] = None,
        *,
        loader: Optional[Callable[[Hashable], np.ndarray]] = None,
    ) -> torch.Tensor:
        """Per-video features for ``keys``, encoding only the cache misses.

        ``pixel_values`` rows ((V, C, T, H, W)) correspond 1:1 with ``keys``
        and may be omitted when every key is cached; ``loader(key) -> (C, T,
        H, W)`` instead supplies the raw frames of the missed keys only.
        Returns the flattened (len(keys) * num_query_tokens, text_hidden)
        tensor that ``generate(video_features=...)``,
        ``classify(video_features=...)`` and ``embed_and_scatter`` take.
        """
        keys = list(keys)
        local: dict[Hashable, Optional[torch.Tensor]] = {}
        miss_idx: list[int] = []
        for i, k in enumerate(keys):
            if k in local:
                self.hits += 1  # duplicate within this call: encoded once
            elif k in self._store:
                self.hits += 1
                self._store.move_to_end(k)
                local[k] = self._store[k]
            else:
                miss_idx.append(i)
                local[k] = None  # filled below
                self.misses += 1

        if miss_idx:
            if pixel_values is not None:
                if pixel_values.shape[0] != len(keys):
                    raise ValueError(
                        f"pixel_values has {pixel_values.shape[0]} videos for {len(keys)} keys"
                    )

                def pixels_of(idx):
                    return pixel_values[torch.as_tensor(idx, device=pixel_values.device)]

            elif loader is not None:

                def pixels_of(idx):
                    return torch.from_numpy(np.stack([loader(keys[i]) for i in idx]))

            else:
                missing = [keys[i] for i in miss_idx]
                raise ValueError(
                    f"pixel_values or loader is required: {len(missing)} "
                    f"uncached key(s), e.g. {missing[:3]}"
                )
            self._encode_misses(keys, pixels_of, miss_idx, local, raw=pixel_values is None)

        return torch.cat([local[k] for k in keys], dim=0)

    # -- internals ----------------------------------------------------------

    @torch.inference_mode()
    def _encode_misses(self, keys, pixels_of, miss_idx, local, raw: bool) -> None:
        param = next(self.model.parameters())
        q = self.model.config.num_query_tokens
        for start in range(0, len(miss_idx), self.bucket):
            chunk_idx = miss_idx[start : start + self.bucket]
            px = pixels_of(chunk_idx).to(param.device)
            pad = self.bucket - px.shape[0]
            if pad:
                px = torch.cat([px, px.new_zeros(pad, *px.shape[1:])])
            if raw and self.preprocess is not None:
                px = self.preprocess(px)
            feats = self.model.encode_videos(px.to(param.dtype)).reshape(self.bucket, q, -1)
            for j, i in enumerate(chunk_idx):
                key = keys[i]
                # a copy, so that an evicted entry frees its memory on its own
                local[key] = self._store[key] = feats[j].clone()
                self._store.move_to_end(key)
                if len(self._store) > self.capacity:
                    self._store.popitem(last=False)
                    self.evictions += 1
