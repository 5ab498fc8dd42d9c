"""Sentence-ify the VideoMAE baseline's verb/noun predictions with a local
LM (counterpart of ``scripts/baselines/videomae_generate_full_sent.py``).

The original's baselines/videomae/videomae_generate_full_sent.py (Llama-2
there). Reads ``videomae_predict``'s CSV and writes a 'generated' column, so
the output feeds ``cli/generation_eval`` directly. Predicted classes are
reduced to their head word (split on '_'), as in the original. The LM is
``TextLM`` on ``--device`` (the card by default).

    python -m eilev_tpu_torch.cli.baselines.videomae_generate_full_sent --model LLAMA_DIR \\
        --predictions_csv videomae.csv --output_csv videomae_sent.csv
"""

from __future__ import annotations

import argparse
from typing import Optional

from .full_sent import PROMPT_TEMPLATE, load_lm, sentenceify

__all__ = ["PROMPT_TEMPLATE", "main", "parse_args", "run"]


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    from . import full_sent

    return full_sent.parse_args(argv, __doc__, "videomae_predict")


def run(args: argparse.Namespace, lm) -> list[dict]:
    """Sentence-ify the CSV with ``lm`` (a ``TextLM``); returns the rows."""
    return sentenceify(args, lm, head_word=True)


def main(argv: Optional[list[str]] = None) -> list[dict]:
    args = parse_args(argv)
    return run(args, load_lm(args))


if __name__ == "__main__":
    main()
