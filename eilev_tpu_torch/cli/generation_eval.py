"""Score generated narrations against ground truth (counterpart of
``scripts/generation_eval.py``).

Reads the CSV written by ``cli/generate_narration_texts.py`` and computes
the metric suite of ``eval/metrics.py``: BLEU and ROUGE-L always;
BERTScore, the STS bi-encoder and the STS cross-encoder when local model
checkpoints are given, on ``--device`` (the card by default).

    python -m eilev_tpu_torch.cli.generation_eval --input_csv generated.csv \\
        --sts_biencoder_model DIR --output_json metrics.json
"""

from __future__ import annotations

import argparse
import csv
import json
from typing import Optional


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input_csv", required=True)
    p.add_argument("--generated_column", default="generated")
    p.add_argument("--ground_truth_column", default="ground_truth")
    p.add_argument("--bert_score_model", default=None, help="local checkpoint dir")
    p.add_argument("--sts_biencoder_model", default=None, help="e.g. local all-mpnet-base-v2")
    p.add_argument("--sts_crossencoder_model", default=None, help="e.g. local stsb-roberta-large")
    p.add_argument("--output_json", default=None)
    p.add_argument("--wandb_project", default=None)
    p.add_argument("--device", default="cuda", help="torch device of the encoders (default: the card)")
    return p.parse_args(argv)


def read_columns(path: str, generated: str = "generated", ground_truth: str = "ground_truth"):
    """(predictions, references) from a narration CSV."""
    preds, refs = [], []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            preds.append(row[generated])
            refs.append(row[ground_truth])
    return preds, refs


def run(args: argparse.Namespace) -> dict[str, float]:
    """Score ``--input_csv``, print the metrics, log them and write
    ``--output_json``. Returns the metrics."""
    from ..eval.metrics import generation_metric_suite
    from ..utils import WandbLogger

    preds, refs = read_columns(args.input_csv, args.generated_column, args.ground_truth_column)
    metrics = generation_metric_suite(
        preds,
        refs,
        bert_score_model=args.bert_score_model,
        sts_biencoder_model=args.sts_biencoder_model,
        sts_crossencoder_model=args.sts_crossencoder_model,
        device=args.device,
    )
    print(json.dumps(metrics, indent=2))
    WandbLogger(project=args.wandb_project, enabled=args.wandb_project is not None)(0, metrics)
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(metrics, f)
    return metrics


def main(argv: Optional[list[str]] = None) -> dict[str, float]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
