"""Verb/noun in-context-learning classification eval on Ego4D fho
(counterpart of ``scripts/icl_eval.py``).

Two-stage classification ("...Answer: The camera wearer" -> verb, then
"...The camera wearer {verb}" -> noun) by mean log-likelihood over the class
prompt sets, macro F1 against the fho-lta taxonomy, through
``eval.IclEvaluator`` on ``--device`` (the card by default).

    python -m eilev_tpu_torch.cli.icl_eval --model DIR --fho_lta_taxonomy T.json \\
        --fho_main fho_main.json --train_narrated_actions_dir TRAIN \\
        --eval_narrated_actions_dir EVAL --num_shot 16 --output_json out.json

Class prompt CSVs use the original schema (``prompt,structured_verb`` /
``prompt,structured_noun``); the defaults are the vendored ones under
``scripts/ego4d/eval-data``.
"""

from __future__ import annotations

import argparse
import json
import os
import random
from typing import Any, Optional

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EVAL_DATA = os.path.join(REPO, "scripts", "ego4d", "eval-data")
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, help="HF save_pretrained dir")
    p.add_argument("--processor", default=None, help="tokenizer dir (default: --model)")
    p.add_argument("--dtype", choices=list(DTYPES), default="bf16")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.add_argument("--fho_lta_taxonomy", required=True)
    p.add_argument("--fho_main", required=True)
    p.add_argument("--structured_verb_prompt", default=os.path.join(EVAL_DATA, "structured_verb_prompt.csv"),
                   help="prompt->verb-class CSV (default: the vendored 188-row map)")
    p.add_argument("--structured_noun_prompt", default=os.path.join(EVAL_DATA, "structured_noun_prompt.csv"),
                   help="prompt->noun-class CSV (default: the vendored 793-row map)")
    p.add_argument("--train_narrated_actions_dir", required=True)
    p.add_argument("--eval_narrated_actions_dir", required=True)
    p.add_argument("--num_shot", required=True, type=int)
    p.add_argument("--num_eval_datapoints", default=0, type=int)
    p.add_argument("--random-seed", type=int, default=42)
    p.add_argument("--class_batch_size", type=int, default=None)
    p.add_argument("--vision_cache", type=int, default=0,
                   help="LRU video-feature cache capacity (videos); encodes each distinct video "
                        "once across the verb+noun stages and across datapoints (0 = off)")
    p.add_argument("--model_parallel", type=int, default=0,
                   help="shard the model weights over N devices; not ported (one device)")
    p.add_argument("--eval_batch_size", type=int, default=4, help="datapoints classified per classify call")
    p.add_argument("--log_verb_preds", action="store_true")
    p.add_argument("--log_noun_preds", action="store_true")
    p.add_argument("--wandb_project", default=None)
    p.add_argument("--output_json", default=None)
    p.add_argument("--fast_gelu", action="store_true",
                   help="tanh gelu serving mode in the ViT (ops/gelu.py; NOT bit-parity)")
    p.add_argument("--int8_lm", action="store_true", help="weight-only int8 LM matmuls (NOT bit-parity)")
    p.add_argument("--int8_kv", action="store_true",
                   help="int8 KV prompt cache; class scoring dequantizes it on the read side")
    p.add_argument("--int8_vision", action="store_true", help="W8A8 vision tower")
    p.add_argument("--int8_qformer", action="store_true", help="W8A8 Q-Former matmuls")
    p.add_argument("--w8a8_prefill", action="store_true", help="with --int8_lm: LM prefill matmuls W8A8")
    return p.parse_args(argv)


def load_datasets(args: argparse.Namespace) -> dict[str, Any]:
    """The taxonomy, prompt maps and the filtered train/eval frame datasets
    (metadata only with ``--vision_cache``, then a lazy frame loader)."""
    from ..data.frame import FrameDataset
    from ..eval import add_and_filter_verb_noun, load_narrated_action_verb_noun, load_prompt_map

    with open(args.fho_lta_taxonomy) as f:
        taxonomy = json.load(f)
    verb_noun = load_narrated_action_verb_noun(args.fho_main)
    lazy = bool(args.vision_cache)
    train = add_and_filter_verb_noun(
        verb_noun, FrameDataset(args.train_narrated_actions_dir, return_frames=not lazy), 0)
    eval_ds = add_and_filter_verb_noun(
        verb_noun, FrameDataset(args.eval_narrated_actions_dir, return_frames=not lazy), args.num_eval_datapoints)
    frame_loader = None
    if lazy:
        train_raw = FrameDataset(args.train_narrated_actions_dir)
        eval_raw = FrameDataset(args.eval_narrated_actions_dir)

        def frame_loader(key):
            ds = train_raw if key in train_raw.dict_data else eval_raw
            return ds[key]["video"]

    return {
        "taxonomy": taxonomy,
        "verb_prompts": load_prompt_map(args.structured_verb_prompt, "structured_verb"),
        "noun_prompts": load_prompt_map(args.structured_noun_prompt, "structured_noun"),
        "train": train,
        "eval": eval_ds,
        "frame_loader": frame_loader,
    }


def run(args: argparse.Namespace, model, tokenizer, datasets: dict[str, Any]):
    """Classify ``datasets["eval"]`` with shots from ``datasets["train"]``
    (any sequences of datapoints with ``frame_path``, ``narration_text``,
    ``structured_verb``, ``structured_noun`` and, without a
    ``frame_loader``, ``video``), print and log the F1s, write
    ``--output_json``. Returns the ``IclEvalResult``."""
    from ..eval import IclEvaluator
    from ..utils import WandbLogger

    taxonomy, verb_prompts, noun_prompts = datasets["taxonomy"], datasets["verb_prompts"], datasets["noun_prompts"]
    assert set(taxonomy["verbs"]) == set(verb_prompts.values())
    assert set(taxonomy["nouns"]) == set(noun_prompts.values())
    evaluator = IclEvaluator(
        model,
        tokenizer,
        verb_prompts=verb_prompts,
        noun_prompts=noun_prompts,
        verbs=taxonomy["verbs"],
        nouns=taxonomy["nouns"],
        num_shot=args.num_shot,
        class_batch_size=args.class_batch_size,
        rng=random.Random(args.random_seed),
        dtype=DTYPES[args.dtype],
        vision_cache=args.vision_cache or None,
        frame_loader=datasets.get("frame_loader"),
        device=args.device,
    )
    result = evaluator.evaluate(datasets["eval"], datasets["train"], progress=True,
                                batch_size=args.eval_batch_size)

    print(f"Verb F1: {result.verb_f1}")
    print(f"Noun F1: {result.noun_f1}")
    logger = WandbLogger(project=args.wandb_project, enabled=args.wandb_project is not None)
    logger(0, {"verb_f1": result.verb_f1, "noun_f1": result.noun_f1})
    for flag, name, preds in ((args.log_verb_preds, "verb_pred_table", result.verb_predictions),
                              (args.log_noun_preds, "noun_pred_table", result.noun_predictions)):
        if flag and preds:
            cols = list(preds[0])
            logger.log_table(name, cols, [[r[c] for c in cols] for r in preds])
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump({"verb_f1": result.verb_f1, "noun_f1": result.noun_f1,
                       "verb_predictions": result.verb_predictions,
                       "noun_predictions": result.noun_predictions}, f)
    return result


def main(argv: Optional[list[str]] = None):
    args = parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model_parallel > 1 is not ported: the port runs on one device (it waits for parallel/)"
        )
    from ..models.auto import load_model, load_tokenizer

    if args.fast_gelu:
        from ..ops.gelu import set_gelu_impl

        set_gelu_impl("fast")
    model, _ = load_model(
        args.model, dtype=DTYPES[args.dtype], int8_lm=args.int8_lm, int8_kv=args.int8_kv,
        int8_vision=args.int8_vision, int8_qformer=args.int8_qformer, w8a8_prefill=args.w8a8_prefill,
        device=args.device,
    )
    tokenizer = load_tokenizer(args.processor or args.model)
    return run(args, model, tokenizer, load_datasets(args))


if __name__ == "__main__":
    main()
