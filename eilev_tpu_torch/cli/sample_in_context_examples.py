"""Pre-sample in-context example -> query maps to JSONL (counterpart of
``scripts/sample_in_context_examples.py``).

Runs the verb/noun-bucket sampler with ``return_frames=False`` and writes
``{"context": [frame_paths...], "query": frame_path}`` lines, which
``FrameInterleavedPresampledDataset`` and ``cli/generate_narration_texts.py``
read. Host only: no model, no device.

    python -m eilev_tpu_torch.cli.sample_in_context_examples --in_context_frames_dir TRAIN \\
        --eval_frames_dir EVAL --num_shot 16 --verb_noun_ratio 0.5 --output_prefix maps/icl
"""

from __future__ import annotations

import argparse
import json
import random
from typing import Optional


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--in_context_frames_dir", required=True)
    p.add_argument("--in_context_annotation_file")
    p.add_argument("--eval_frames_dir", required=True)
    p.add_argument("--eval_annotation_file")
    p.add_argument("--num_shot", required=True, type=int)
    p.add_argument("--output_prefix", required=True)
    p.add_argument("--verb_noun_ratio", required=True, type=float)
    p.add_argument("--random_seed", type=int, default=42)
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> str:
    """Write ``<output_prefix>-<num_shot>-shot.jsonl``; returns its path."""
    from ..data.frame import FrameInterleavedDataset

    dataset = FrameInterleavedDataset(
        args.eval_frames_dir,
        annotation_file=args.eval_annotation_file,
        in_context_example_frames_dir=args.in_context_frames_dir,
        in_context_example_annotation_file=args.in_context_annotation_file,
        num_in_context_examples_per_sample=args.num_shot,
        verb_noun_ratio=args.verb_noun_ratio,
        return_frames=False,
        rng=random.Random(args.random_seed),
    )
    fname = f"{args.output_prefix}-{args.num_shot}-shot.jsonl"
    with open(fname, "w") as f:
        for i in range(len(dataset)):
            frame_paths = [item["frame_path"] for item in dataset[i]["items"]]
            f.write(json.dumps({"context": frame_paths[:-1], "query": frame_paths[-1]}) + "\n")
    print(f"wrote {len(dataset)} maps to {fname}")
    return fname


def main(argv: Optional[list[str]] = None) -> str:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
