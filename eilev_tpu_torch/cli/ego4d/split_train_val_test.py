"""Video-level 75/25 x 75/25 train/val/test split of Ego4D fho_main by
narrated-action counts (counterpart of ``scripts/ego4d/split_train_val_test.py``).

Keeps the videos that exist on disk and have narrated actions that
``filter_action`` accepts, then assigns whole videos in a
``random.Random(--seed)`` order until each split's narrated-action target is
met; writes ``fho_main_{train,val,test}.json`` as
``{"split": ..., "videos": {video_uid: num_narrated_actions}}``. Host only.

    python -m eilev_tpu_torch.cli.ego4d.split_train_val_test fho_main.json SPLITS VIDEOS [--seed 42]
"""

from __future__ import annotations

import argparse
import json
import random
from pathlib import Path
from typing import Optional

from ...data.video_datasets import filter_action


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("fho_main_path")
    p.add_argument("split_output_path")
    p.add_argument("video_dir_path")
    p.add_argument("--seed", type=int, default=42)
    return p.parse_args(argv)


def split_videos(video_dict: dict, video_uids, goal_first: int, rng: random.Random) -> tuple[dict, dict]:
    """Whole videos, in a shuffled order, to the first split until it holds
    ``goal_first`` narrated actions; the rest to the second."""
    first, second = {}, {}
    count_first = 0
    for uid in rng.sample(list(video_uids), k=len(video_uids)):
        n = len(video_dict[uid]["narrated_actions"])
        if count_first < goal_first:
            first[uid] = n
            count_first += n
        else:
            second[uid] = n
    return first, second


def run(args: argparse.Namespace) -> dict[str, dict]:
    """Write the three split files; returns {split: {video_uid: count}}."""
    with open(args.fho_main_path) as f:
        data = json.load(f)

    video_dir = Path(args.video_dir_path)
    video_dict = {v["video_uid"]: v for v in data["videos"] if (video_dir / (v["video_uid"] + ".mp4")).exists()}
    print(f"num videos before filtering: {len(video_dict)}")
    for video in video_dict.values():
        video["narrated_actions"] = [
            a for interval in video["annotated_intervals"] for a in interval["narrated_actions"] if filter_action(a)
        ]
    video_dict = {k: v for k, v in video_dict.items() if v["narrated_actions"]}
    print(f"num videos after filtering: {len(video_dict)}")

    total = sum(len(v["narrated_actions"]) for v in video_dict.values())
    goal_train_val = round(total * 0.75)
    goal_train = round(goal_train_val * 0.75)
    print(f"total narrated actions: {total}; goals train={goal_train} "
          f"val={goal_train_val - goal_train} test={total - goal_train_val}")

    rng = random.Random(args.seed)
    train_val, test = split_videos(video_dict, video_dict.keys(), goal_train_val, rng)
    train, val = split_videos(video_dict, train_val.keys(), goal_train, rng)

    splits = {"train": train, "val": val, "test": test}
    if total != sum(sum(videos.values()) for videos in splits.values()):
        raise RuntimeError("the splits lost narrated actions")
    out = Path(args.split_output_path)
    out.mkdir(parents=True, exist_ok=True)
    for name, videos in splits.items():
        with open(out / f"fho_main_{name}.json", "w") as f:
            json.dump({"split": name, "videos": videos}, f)
        print(f"{name}: {len(videos)} videos, {sum(videos.values())} narrated actions")
    return splits


def main(argv: Optional[list[str]] = None) -> dict[str, dict]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
