"""Decode EPIC-KITCHENS clips into subsampled, resized frames and
``narrated_actions.csv`` (counterpart of
``scripts/epic_kitchens/epic_kitchens_extract_frames.py``).

The Ego4D extractor's frame and CSV contract (``cli/ego4d/extract_frames``,
the resize on ``--device``, the card by default) over the EK-55/100 videos;
a CSV row carries the full-sentence narration and the verb/noun classes
(video_uid = video_id, narration_text = full_sent_narration,
structured_verb = verb, structured_noun = noun).

    python -m eilev_tpu_torch.cli.epic_kitchens.epic_kitchens_extract_frames \\
        --annotation_path full_sent.csv --epic_kitchens_55_video_dir_path EK55 \\
        --epic_kitchens_100_video_dir_path EK100 --frames_dir FRAMES --num_subsample_frames 8
"""

from __future__ import annotations

import argparse
from typing import Any, Optional

import torch

from ..ego4d.extract_frames import add_extract_args, extract


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--annotation_path", required=True, help="full-sentence EK annotation CSV")
    p.add_argument("--epic_kitchens_55_video_dir_path", required=True)
    p.add_argument("--epic_kitchens_100_video_dir_path", required=True)
    add_extract_args(p)
    return p.parse_args(argv)


def epic_kitchens_row(item: dict[str, Any]) -> dict[str, Any]:
    """A decoded EPIC-KITCHENS item's CSV row."""
    return {
        "frame_path": f"{item['video_id']}|{item['clip_index']}",
        "video_uid": item["video_id"],
        "clip_index": item["clip_index"],
        "narration_timestamp_sec": item["narration_timestamp_sec"],
        "narration_text": str(item.get("full_sent_narration", item.get("narration", ""))).strip(),
        "structured_verb": item.get("verb", ""),
        "structured_noun": item.get("noun", ""),
    }


def main(argv: Optional[list[str]] = None) -> dict[str, float]:
    args = parse_args(argv)
    from ...data.video_datasets import EpicKitchensDataset

    dataset = EpicKitchensDataset(args.annotation_path, args.epic_kitchens_55_video_dir_path,
                                  args.epic_kitchens_100_video_dir_path, num_frames=args.num_subsample_frames)
    stats = extract(dataset, args, torch.device(args.device), row=epic_kitchens_row)
    print(f"done: {stats['clips']} narrated actions -> {args.frames_dir}")
    return stats


if __name__ == "__main__":
    main()
