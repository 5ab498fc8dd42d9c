"""Decode Ego4D fho clips into subsampled, resized frames and
``narrated_actions.csv`` (counterpart of ``scripts/ego4d/extract_frames.py``).

One 8 s clip around each narrated action, ``--num_subsample_frames``
uniform frames decoded by the native libav decoder (``native/``), a bicubic
resize to ``--target_size`` square (twice the model's image size: headroom
for RandomResizedCrop) on ``--device`` (the card by default), rounded and
clipped to uint8, written as PNGs named
``{video_uid}|{clip_index}/{video_uid}|{clip_index}|{i}.png`` (or one raw
``.npy`` a clip with ``--format raw``), and one CSV row a clip (frame_path,
video_uid, clip_index, narration_timestamp_sec, narration_text,
structured_verb, structured_noun).

    python -m eilev_tpu_torch.cli.ego4d.extract_frames --fho_main_path fho_main.json \\
        --split_path fho_main_train.json --video_dir_path VIDEOS --frames_dir FRAMES \\
        --num_subsample_frames 8 [--format raw] [--device cuda]

:func:`extract` takes decoded items, so clips can be fed in without the
decoder (which needs g++ and libav's headers to build).
"""

from __future__ import annotations

import argparse
import csv
import os
import time
from collections.abc import Callable, Iterable
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from ...data.frame import save_frame_video
from ...ops.preprocess import resize_video

FIELDS = [
    "frame_path",
    "video_uid",
    "clip_index",
    "narration_timestamp_sec",
    "narration_text",
    "structured_verb",
    "structured_noun",
]


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--fho_main_path", required=True)
    p.add_argument("--split_path", required=True)
    p.add_argument("--video_dir_path", required=True)
    add_extract_args(p)
    return p.parse_args(argv)


def add_extract_args(p: argparse.ArgumentParser) -> None:
    """The flags both extractors share."""
    p.add_argument("--frames_dir", required=True)
    p.add_argument("--num_subsample_frames", type=int, required=True)
    p.add_argument("--target_size", type=int, default=448, help="2x model image size")
    p.add_argument("--num_workers", type=int, default=8, help="threads encoding PNG frames")
    p.add_argument("--max_num_narrated_actions", type=int, default=0)
    p.add_argument("--csv_only", action="store_true")
    p.add_argument("--format", choices=("png", "raw"), default="png",
                   help="png: per-frame PNGs (the reference's format). raw: one uint8 .npy per clip, no decode "
                        "work at load time; larger on disk. Same directory + CSV contract either way.")
    p.add_argument("--device", default="cuda", help="torch device of the resize (default: the card)")


def resize_clip(video: np.ndarray, size: int, device) -> np.ndarray:
    """One (C, T, H, W) uint8 clip resized to ``size`` x ``size`` on
    ``device`` (``ops/preprocess.resize_video``), rounded, clipped and cast
    to uint8 as the JAX script does; back on the host."""
    resized = resize_video(torch.from_numpy(np.ascontiguousarray(video)).to(device), size, size)
    return resized.round().clamp(0, 255).to(torch.uint8).cpu().numpy()


def ego4d_row(item: dict[str, Any]) -> dict[str, Any]:
    """A decoded Ego4D item's CSV row."""
    return {
        "frame_path": f"{item['video_uid']}|{item['clip_index']}",
        "video_uid": item["video_uid"],
        "clip_index": item["clip_index"],
        "narration_timestamp_sec": item["narration_timestamp_sec"],
        "narration_text": str(item["narration_text"]).strip(),
        "structured_verb": item["structured_verb"],
        "structured_noun": item["structured_noun"],
    }


def extract(items: Iterable[dict[str, Any]], args: argparse.Namespace, device,
            row: Callable[[dict[str, Any]], dict[str, Any]] = ego4d_row) -> dict[str, float]:
    """Write each item's resized frames (unless ``--csv_only``) and its CSV
    row (``row(item)``) under ``--frames_dir``, up to
    ``--max_num_narrated_actions``. ``items`` yield ``video`` (C, T, H, W)
    uint8 beside the annotation's fields. Returns the clip count and the
    seconds spent waiting for items (the decode), resizing (device work
    included: the result is read back) and writing."""
    os.makedirs(args.frames_dir, exist_ok=True)
    stats = {"clips": 0, "decode_s": 0.0, "resize_s": 0.0, "write_s": 0.0}
    with ThreadPoolExecutor(args.num_workers) as pool, \
            open(os.path.join(args.frames_dir, "narrated_actions.csv"), "w", newline="") as csvfile:
        writer = csv.DictWriter(csvfile, FIELDS)
        writer.writeheader()
        it = iter(items)
        while True:
            t0 = time.perf_counter()
            item = next(it, None)
            stats["decode_s"] += time.perf_counter() - t0
            if item is None:
                break
            fields = row(item)
            if not args.csv_only:
                t0 = time.perf_counter()
                u8 = resize_clip(item["video"], args.target_size, device)
                t1 = time.perf_counter()
                save_frame_video(args.frames_dir, fields["frame_path"], u8, fmt=args.format, pool=pool)
                stats["resize_s"] += t1 - t0
                stats["write_s"] += time.perf_counter() - t1
            writer.writerow(fields)
            stats["clips"] += 1
            if stats["clips"] % 50 == 0:
                print(f"extracted {stats['clips']} narrated actions", flush=True)
            if args.max_num_narrated_actions and stats["clips"] >= args.max_num_narrated_actions:
                break
    return stats


def main(argv: Optional[list[str]] = None) -> dict[str, float]:
    args = parse_args(argv)
    from ...data.video_datasets import Ego4dFHOMainDataset

    dataset = Ego4dFHOMainDataset(args.fho_main_path, args.split_path, args.video_dir_path,
                                  num_frames=args.num_subsample_frames)
    stats = extract(dataset, args, torch.device(args.device))
    print(f"done: {stats['clips']} narrated actions -> {args.frames_dir}")
    return stats


if __name__ == "__main__":
    main()
