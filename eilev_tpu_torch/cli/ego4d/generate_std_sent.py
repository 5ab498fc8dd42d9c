"""Few-shot generation of standard sentences from verb/noun classes
(counterpart of ``scripts/ego4d/generate_std_sent.py``).

Each annotation row with a structured verb and noun becomes the
sentence-ifier's few-shot prompt (``cli/baselines/full_sent.PROMPT_TEMPLATE``)
over the classes' head words, decoded greedily by ``TextLM`` (a local LLaMA-
or OPT-family checkpoint) on ``--device`` (the card by default) up to a
newline; the first sentence replaces the row's ``narration_text`` (or is
appended as it). Rows without a verb or noun are dropped.

    python -m eilev_tpu_torch.cli.ego4d.generate_std_sent --model LLAMA_DIR \\
        --annotation narrated_actions.csv --annotation_with_std_sent std.csv
"""

from __future__ import annotations

import argparse
import csv
from typing import Optional

from ..baselines.full_sent import PROMPT_TEMPLATE, first_sentence, newline_config


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, help="local decoder-only LM dir")
    p.add_argument("--int8_lm", action="store_true", help="weight-only int8 LM serving (ops/quantization.py)")
    p.add_argument("--annotation", required=True)
    p.add_argument("--annotation_with_std_sent", required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p.parse_args(argv)


def run(args: argparse.Namespace, lm) -> list[dict]:
    """Write ``--annotation_with_std_sent`` with ``lm`` (a ``TextLM``);
    returns the rows written."""
    from ...data.text import generate_chunks

    gen_cfg = newline_config(lm, args.max_new_tokens)
    rows = []
    with open(args.annotation, newline="") as f:
        for row in csv.DictReader(f):
            if row["structured_verb"] == "" or row["structured_noun"] == "":
                continue
            row["verb"] = row["structured_verb"].split("_", 1)[0]
            row["noun"] = row["structured_noun"].split("_", 1)[0]
            rows.append(row)

    # narration_text is replaced when present, appended otherwise
    fields = list(dict.fromkeys([k for k in rows[0] if k not in {"verb", "noun"}] + ["narration_text"]))
    with open(args.annotation_with_std_sent, "w", newline="") as f:
        writer = csv.DictWriter(f, fields)
        writer.writeheader()
        for batch in generate_chunks(rows, args.batch_size):
            texts = lm.generate([PROMPT_TEMPLATE % (r["verb"], r["noun"]) for r in batch], gen_cfg)
            for row, text in zip(batch, texts):
                row["narration_text"] = first_sentence(text)
                del row["verb"], row["noun"]
            writer.writerows(batch)
    print(f"wrote {len(rows)} rows to {args.annotation_with_std_sent}")
    return rows


def main(argv: Optional[list[str]] = None) -> list[dict]:
    args = parse_args(argv)
    from ...generation.text_lm import TextLM

    return run(args, TextLM(args.model, int8=args.int8_lm, device=args.device))


if __name__ == "__main__":
    main()
