"""Backfill the structured_verb and structured_noun columns of a
``narrated_actions.csv`` from fho_main.json (counterpart of
``scripts/ego4d/add_structured_verb_noun.py``).

A row's frame_path is ``{video_uid}|{clip index}``, the clip index running
over the video's actions that ``filter_action`` accepts, as the extractor
numbers them. Host only.

    python -m eilev_tpu_torch.cli.ego4d.add_structured_verb_noun fho_main.json narrated_actions.csv OUT.csv
"""

from __future__ import annotations

import argparse
import csv
import json
from typing import Optional

from ...data.video_datasets import filter_action, get_structured_noun
from .extract_frames import FIELDS


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("fho_main")
    p.add_argument("narrated_actions_csv")
    p.add_argument("outfile")
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> None:
    with open(args.fho_main) as f:
        fho_main = json.load(f)

    verb_map: dict[str, str] = {}
    noun_map: dict[str, Optional[str]] = {}
    for video in fho_main["videos"]:
        clip_id = 0
        for interval in video["annotated_intervals"]:
            for action in interval["narrated_actions"]:
                if not filter_action(action):
                    continue
                frame_path = f"{video['video_uid']}|{clip_id}"
                clip_id += 1
                verb_map[frame_path] = action["structured_verb"]
                noun_map[frame_path] = get_structured_noun(action)

    with open(args.narrated_actions_csv, newline="") as inf, open(args.outfile, "w", newline="") as outf:
        writer = csv.DictWriter(outf, FIELDS)
        writer.writeheader()
        for row in csv.DictReader(inf):
            writer.writerow({"structured_verb": verb_map[row["frame_path"]],
                             "structured_noun": noun_map[row["frame_path"]], **row})


def main(argv: Optional[list[str]] = None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
