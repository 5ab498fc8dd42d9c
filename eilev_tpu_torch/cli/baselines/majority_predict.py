"""Majority-class baseline: predict the majority ROOT verb / dobj noun of the
in-context example narrations (counterpart of
``scripts/baselines/majority_predict.py``).

The original's baselines/majority/majority_predict.py: a spaCy dependency
parse of the cleaned narrations; the most common ROOT lemma is the verb,
the most common dobj child lemma the noun. Needs spaCy and a local model
(en_core_web_sm); without them it raises a clear ``SystemExit``. Host only:
no model of the port, no device.

    python -m eilev_tpu_torch.cli.baselines.majority_predict --eval_frames_dir EVAL \\
        --in_context_query_map_file MAP.jsonl --in_context_example_frames_dir TRAIN \\
        --output_csv majority.csv
"""

from __future__ import annotations

import argparse
import csv
from collections import Counter
from typing import Optional


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--eval_frames_dir", required=True)
    p.add_argument("--eval_annotation_file")
    p.add_argument("--in_context_query_map_file", required=True)
    p.add_argument("--in_context_example_frames_dir", required=True)
    p.add_argument("--in_context_example_annotation_file")
    p.add_argument("--print_predictions", action="store_true")
    p.add_argument("--num_eval_datapoints", default=None, type=int)
    p.add_argument("--spacy_model", default="en_core_web_sm", help="name or local path")
    p.add_argument("--output_csv", required=True)
    return p.parse_args(argv)


def load_spacy(name: str):
    """The spaCy pipeline ``name``, or ``SystemExit`` when spaCy or the model
    is missing."""
    try:
        import spacy  # type: ignore

        return spacy.load(name)
    except Exception as e:
        raise SystemExit(
            f"spaCy model unavailable ({e}). Install spacy and a local "
            "en_core_web_sm (no network in this environment)."
        )


def load_dataset(args: argparse.Namespace):
    from ...data.frame import FrameInterleavedPresampledDataset

    return FrameInterleavedPresampledDataset(
        args.eval_frames_dir,
        args.in_context_query_map_file,
        args.in_context_example_frames_dir,
        annotation_file=args.eval_annotation_file,
        in_context_example_annotation_file=args.in_context_example_annotation_file,
        return_frames=False,
    )


def run(args: argparse.Namespace, nlp, dataset) -> list[dict]:
    """Predict each datapoint's verb and noun from its in-context examples
    with the spaCy pipeline ``nlp``; write ``--output_csv``. Returns the rows."""
    from ...data.text import clean_narration_text

    rows = []
    n = len(dataset) if args.num_eval_datapoints is None else min(args.num_eval_datapoints, len(dataset))
    for i in range(n):
        datapoint = dataset[i]
        examples, query = datapoint["items"][:-1], datapoint["items"][-1]
        narrations = [clean_narration_text(e["narration_text"]) for e in examples]
        verb_counter: Counter = Counter()
        noun_counter: Counter = Counter()
        for doc in nlp.pipe(narrations, disable=["ner"]):
            for token in doc:
                if token.dep_ == "ROOT":
                    verb_counter[token.lemma_] += 1
                    for child in token.children:
                        if child.dep_ == "dobj":
                            noun_counter[child.lemma_] += 1
        pred_verb = verb_counter.most_common(1)[0][0] if verb_counter else ""
        pred_noun = noun_counter.most_common(1)[0][0] if noun_counter else ""
        if args.print_predictions:
            print(f"verb: {pred_verb} vs {query['structured_verb']}; "
                  f"noun: {pred_noun} vs {query['structured_noun']}")
        rows.append(
            {
                "frame_path": query["frame_path"],
                "video_uid": query["video_uid"],
                "clip_index": query["clip_index"],
                "predicted_verb": pred_verb,
                "ground_truth_structured_verb": query["structured_verb"],
                "predicted_noun": pred_noun,
                "ground_truth_structured_noun": query["structured_noun"],
                "ground_truth_narration_text": query["narration_text"],
            }
        )

    with open(args.output_csv, "w", newline="") as f:
        w = csv.DictWriter(f, list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {len(rows)} predictions to {args.output_csv}")
    return rows


def main(argv: Optional[list[str]] = None) -> list[dict]:
    args = parse_args(argv)
    nlp = load_spacy(args.spacy_model)
    return run(args, nlp, load_dataset(args))


if __name__ == "__main__":
    main()
