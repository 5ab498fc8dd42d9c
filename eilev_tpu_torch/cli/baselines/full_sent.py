"""The baselines' sentence-ifier: a verb and a noun -> "The camera wearer
<verbs> the <noun>." through a local decoder-only LM (``TextLM``), shared by
``majority_generate_full_sent`` and ``videomae_generate_full_sent`` (the
JAX scripts each hold a copy of it)."""

from __future__ import annotations

import argparse
import csv

PROMPT_TEMPLATE = """Use the verb and noun to generate a sentence using "the camera wearer" as the subject.

Verb: cut
Noun: plant
Generated: The camera wearer cuts the plant.

Verb: repair
Noun: car
Generated: The camera wearer repairs the car.

Verb: move
Noun: tablet
Generated: The camera wearer moves the tablet.

Verb: %s
Noun: %s
Generated:"""


def parse_args(argv, description: str, predictions_from: str) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=description, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, help="local decoder-only LM dir")
    p.add_argument("--int8_lm", action="store_true",
                   help="weight-only int8 LM serving (ops/quantization.py)")
    p.add_argument("--predictions_csv", required=True, help=f"from {predictions_from}")
    p.add_argument("--output_csv", required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p.parse_args(argv)


def load_lm(args: argparse.Namespace):
    from ...generation.text_lm import TextLM

    return TextLM(args.model, int8=args.int8_lm, device=args.device)


def sentenceify(args: argparse.Namespace, lm, head_word: bool) -> list[dict]:
    """Read ``--predictions_csv``, add the ``generated`` and ``ground_truth``
    columns (greedy, up to 64 tokens, ending at a newline) and write
    ``--output_csv``; ``head_word`` reduces a class to its head word (split on
    '_'). Returns the rows."""
    from ...data.text import generate_chunks
    from ...generation import GenerationConfig

    newline_id = lm.tokenizer("\n", add_special_tokens=False)["input_ids"][0]
    gen_cfg = GenerationConfig(
        max_new_tokens=64, eos_token_id=(newline_id,), pad_token_id=lm.tokenizer.pad_token_id
    )

    def word(value: str, default: str) -> str:
        value = value or default
        return value.split("_", 1)[0] if head_word else value

    with open(args.predictions_csv, newline="") as f:
        rows = list(csv.DictReader(f))

    fields = list(rows[0]) + ["generated", "ground_truth"]
    with open(args.output_csv, "w", newline="") as f:
        writer = csv.DictWriter(f, fields)
        writer.writeheader()
        for batch in generate_chunks(rows, args.batch_size):
            prompts = [PROMPT_TEMPLATE % (word(r["predicted_verb"], "do"), word(r["predicted_noun"], "thing"))
                       for r in batch]
            texts = lm.generate(prompts, gen_cfg)
            for row, text in zip(batch, texts):
                row["generated"] = text.strip().split(".", maxsplit=1)[0] + "."
                row["ground_truth"] = row["ground_truth_narration_text"]
            writer.writerows(batch)
    print(f"wrote {len(rows)} rows to {args.output_csv}")
    return rows
