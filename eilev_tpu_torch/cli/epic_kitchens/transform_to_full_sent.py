"""Rewrite EPIC-KITCHENS phrase narrations as full camera-wearer sentences
(counterpart of ``scripts/epic_kitchens/transform_to_full_sent.py``).

Each row's ``narration`` goes into a few-shot "Rewrite the phrase..." prompt,
decoded greedily by ``TextLM`` (a local LLaMA- or OPT-family checkpoint) on
``--device`` (the card by default) up to a newline; the output is the
annotation CSV plus a ``full_sent_narration`` column, which
``epic_kitchens_extract_frames`` reads.

    python -m eilev_tpu_torch.cli.epic_kitchens.transform_to_full_sent --model LLAMA_DIR \\
        --annotation EPIC_100_train.csv --output full_sent.csv
"""

from __future__ import annotations

import argparse
import csv
from typing import Optional

from ..baselines.full_sent import first_sentence, newline_config

PROMPT_TEMPLATE = """Rewrite the phrase as a full sentence using "the camera wearer" as the subject.

Phrase: open door
Sentence: The camera wearer opens the door.

Phrase: wash carrot
Sentence: The camera wearer washes the carrot.

Phrase: put down plate
Sentence: The camera wearer puts down the plate.

Phrase: %s
Sentence:"""


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, help="local decoder-only LM dir")
    p.add_argument("--int8_lm", action="store_true", help="weight-only int8 LM serving (ops/quantization.py)")
    p.add_argument("--annotation", required=True, help="EK annotation CSV with a 'narration' column")
    p.add_argument("--output", required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p.parse_args(argv)


def run(args: argparse.Namespace, lm) -> list[dict]:
    """Write ``--output`` with ``lm`` (a ``TextLM``); returns the rows."""
    from ...data.text import generate_chunks

    gen_cfg = newline_config(lm, args.max_new_tokens)
    with open(args.annotation, newline="") as f:
        rows = list(csv.DictReader(f))

    with open(args.output, "w", newline="") as f:
        writer = csv.DictWriter(f, list(rows[0]) + ["full_sent_narration"])
        writer.writeheader()
        for batch in generate_chunks(rows, args.batch_size):
            texts = lm.generate([PROMPT_TEMPLATE % r["narration"] for r in batch], gen_cfg)
            for row, text in zip(batch, texts):
                row["full_sent_narration"] = first_sentence(text)
            writer.writerows(batch)
    print(f"wrote {len(rows)} rows to {args.output}")
    return rows


def main(argv: Optional[list[str]] = None) -> list[dict]:
    args = parse_args(argv)
    from ...generation.text_lm import TextLM

    return run(args, TextLM(args.model, int8=args.int8_lm, device=args.device))


if __name__ == "__main__":
    main()
