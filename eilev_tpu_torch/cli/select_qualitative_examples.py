"""Filter the combined analysis JSONL by a metric threshold (counterpart of
``scripts/select_qualitative_examples.py``).

Keeps the rows whose ``--metric`` is at most ``--threshold`` (at least, with
``--above``); a row without the metric gets its ROUGE-L of ``generated``
against ``ground_truth``. Host only:

    python -m eilev_tpu_torch.cli.select_qualitative_examples --combined_jsonl combined.jsonl \\
        --metric rougeL --threshold 0.9 --above --output selected.jsonl
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

from ..eval.metrics import rouge_l


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--combined_jsonl", required=True)
    p.add_argument("--metric", default="rougeL", help="per-row metric column to threshold")
    p.add_argument("--threshold", type=float, required=True)
    p.add_argument("--above", action="store_true", help="keep rows >= threshold (default <=)")
    p.add_argument("--output", required=True)
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> int:
    """Write the kept rows to ``--output``; returns their count."""
    kept = 0
    with open(args.combined_jsonl) as inf, open(args.output, "w") as outf:
        for line in inf:
            row = json.loads(line)
            if args.metric not in row:
                row[args.metric] = rouge_l([row["generated"]], [row["ground_truth"]])
            v = float(row[args.metric])
            if (v >= args.threshold) if args.above else (v <= args.threshold):
                outf.write(json.dumps(row) + "\n")
                kept += 1
    print(f"kept {kept} rows -> {args.output}")
    return kept


def main(argv: Optional[list[str]] = None) -> int:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
