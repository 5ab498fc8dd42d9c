"""Paired verb+noun VideoMAE inference over a frame dataset (counterpart of
``scripts/baselines/videomae_predict.py``).

The original's baselines/videomae/videomae_predict.py: both fine-tuned
classifiers run on each clip, a CSV of predictions for the sentence-ifier
and an F1 summary. Reads the ``params.pkl`` + ``labels.json`` that either
package's ``videomae_train`` writes; runs on ``--device`` (the card by
default).

    python -m eilev_tpu_torch.cli.baselines.videomae_predict --verb_classifier VERB_DIR \\
        --noun_classifier NOUN_DIR --frames_dir EVAL --output_csv videomae.csv
"""

from __future__ import annotations

import argparse
import csv
import json
import pickle
from typing import Any, Optional

import numpy as np
import torch

from .videomae_train import eval_item, labeled


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--verb_classifier", required=True, help="videomae_train output dir")
    p.add_argument("--noun_classifier", required=True)
    p.add_argument("--frames_dir", required=True)
    p.add_argument("--annotation_file", default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_eval_datapoints", type=int, default=None)
    p.add_argument("--output_csv", required=True)
    p.add_argument("--print_predictions", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p.parse_args(argv)


def load_classifier(path: str, device="cuda"):
    """(model on ``device``, labels) from a ``videomae_train`` output dir."""
    from ...models.convert import flax_to_state_dict
    from ...models.videomae import VideoMAEConfig, VideoMAEForVideoClassification

    with open(path + "/labels.json") as f:
        meta = json.load(f)
    with open(path + "/params.pkl", "rb") as f:
        params = pickle.load(f)
    model = VideoMAEForVideoClassification(VideoMAEConfig(**meta["config"]), device="meta")
    model.load_state_dict(flax_to_state_dict(params), strict=True, assign=True)
    return model.to(device).eval().requires_grad_(False), meta["labels"]


def run(args: argparse.Namespace, verb: tuple, noun: tuple, dataset) -> list[dict]:
    """Classify each clip of ``dataset`` with ``verb`` and ``noun`` (each a
    (model, labels) pair), print both macro F1s and write ``--output_csv``.
    Returns the rows."""
    from ...data.text import generate_chunks
    from ...eval.metrics import MulticlassF1

    (verb_model, verb_labels), (noun_model, noun_labels) = verb, noun
    vcfg, device = verb_model.config, torch.device(args.device)
    verb_f1 = MulticlassF1(len(verb_labels))
    noun_f1 = MulticlassF1(len(noun_labels))
    verb_id = {l: i for i, l in enumerate(verb_labels)}
    noun_id = {l: i for i, l in enumerate(noun_labels)}

    n_total = len(dataset) if args.num_eval_datapoints is None else min(args.num_eval_datapoints, len(dataset))
    rows = []
    for chunk in generate_chunks(list(range(n_total)), args.batch_size):
        items = [dataset[i] for i in chunk]
        pixel = torch.stack([eval_item(torch.from_numpy(np.asarray(it["video"])).to(device), vcfg.num_frames,
                                       vcfg.image_size) for it in items])
        with torch.no_grad():
            v_pred = verb_model(pixel)["logits"].argmax(-1).cpu().numpy()
            n_pred = noun_model(pixel)["logits"].argmax(-1).cpu().numpy()
        for it, vi, ni in zip(items, v_pred, n_pred):
            pv, pn = verb_labels[vi], noun_labels[ni]
            if it["structured_verb"] in verb_id:
                verb_f1([int(vi)], [verb_id[it["structured_verb"]]])
            if it["structured_noun"] in noun_id:
                noun_f1([int(ni)], [noun_id[it["structured_noun"]]])
            if args.print_predictions:
                print(f"verb: {pv} vs {it['structured_verb']}; noun: {pn} vs {it['structured_noun']}")
            rows.append(
                {
                    "frame_path": it["frame_path"],
                    "video_uid": it["video_uid"],
                    "clip_index": it["clip_index"],
                    "predicted_verb": pv,
                    "ground_truth_structured_verb": it["structured_verb"],
                    "predicted_noun": pn,
                    "ground_truth_structured_noun": it["structured_noun"],
                    "ground_truth_narration_text": it["narration_text"],
                }
            )

    with open(args.output_csv, "w", newline="") as f:
        w = csv.DictWriter(f, list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    print(f"verb F1: {verb_f1.compute():.4f}  noun F1: {noun_f1.compute():.4f}")
    print(f"wrote {len(rows)} predictions to {args.output_csv}")
    return rows


def main(argv: Optional[list[str]] = None) -> list[dict]:
    args = parse_args(argv)
    from ...data.frame import FrameDataset

    dataset: Any = FrameDataset(args.frames_dir, annotation_file=args.annotation_file, data_filter=labeled)
    return run(args, load_classifier(args.verb_classifier, args.device),
               load_classifier(args.noun_classifier, args.device), dataset)


if __name__ == "__main__":
    main()
