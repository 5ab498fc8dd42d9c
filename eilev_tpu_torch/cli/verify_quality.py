"""Quality-parity gate: replay the published EILeV quality table end to end
(counterpart of ``scripts/verify_quality.py``).

Given a local HF checkpoint (e.g. kpyu/eilev-blip2-opt-2.7b exported
locally) and an extracted-frames dir, this runs the full eval pipeline per
shot count, in this process: sample ICL maps (``cli/sample_in_context_examples``)
-> batched narration generation (``cli/generate_narration_texts``) -> metric
suite (``eval/metrics.py``), and diffs the result against the PUBLISHED
numbers (the original's figures/icl_eval_figures.ipynb cell 3, in
``eval/published.py``). One command, prints a PASS/FAIL table, exit code 1 on
failure. The model and the encoders run on ``--device`` (the card by
default).

Full run:
  python -m eilev_tpu_torch.cli.verify_quality \\
    --model /ckpts/eilev-blip2-opt-2.7b \\
    --eval_frames_dir frames/val --in_context_frames_dir frames/train \\
    --sts_biencoder_model /ckpts/all-mpnet-base-v2 \\
    --num_shots 0 16 --tolerance 0.02

Mocked mode (CI / pre-generated narrations): skip generation, score existing CSVs:
  python -m eilev_tpu_torch.cli.verify_quality --generated_csv 0=gen0.csv 16=gen16.csv \\
    --tolerance 0.02
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Optional


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    # full-pipeline inputs
    p.add_argument("--model", default=None, help="HF save_pretrained dir (full run)")
    p.add_argument("--eval_frames_dir", default=None)
    p.add_argument("--eval_annotation_file", default=None)
    p.add_argument("--in_context_frames_dir", default=None)
    p.add_argument("--in_context_annotation_file", default=None)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_eval_datapoints", type=int, default=None)
    p.add_argument("--dtype", choices=["fp32", "bf16"], default="bf16")
    p.add_argument("--verb_noun_ratio", type=float, default=0.5)
    p.add_argument("--random_seed", type=int, default=42)
    # mocked mode
    p.add_argument("--generated_csv", nargs="*", default=None,
                   help="SHOT=PATH pairs of pre-generated narration CSVs")
    # scoring / comparison
    p.add_argument("--num_shots", nargs="*", type=int, default=[0, 16])
    p.add_argument("--published_table", default="ego4d-opt-2.7b",
                   choices=["ego4d-opt-2.7b", "ego4d-flan-t5-xl",
                            "epic-kitchens-opt-2.7b", "novel-opt-2.7b"])
    p.add_argument("--tolerance", type=float, default=0.02,
                   help="absolute metric tolerance vs published")
    p.add_argument("--sts_biencoder_model", default=None,
                   help="local all-mpnet-base-v2 dir (needed for the STS-BE column)")
    p.add_argument("--bert_score_model", default=None)
    p.add_argument("--output_json", default=None)
    p.add_argument("--work_dir", default=None, help="keep intermediate files here")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p.parse_args(argv)


def run_pipeline(args: argparse.Namespace, shot: int, work: str, model=None, tokenizer=None) -> str:
    """sample ICL map -> generate narrations, in this process; returns the
    generated CSV path. ``model`` and ``tokenizer`` (both or neither) take
    the place of loading ``--model``."""
    from . import generate_narration_texts as gen
    from . import sample_in_context_examples as sample

    prefix = os.path.join(work, f"icl-{shot}shot")
    sample.main(
        ["--in_context_frames_dir", args.in_context_frames_dir,
         *(["--in_context_annotation_file", args.in_context_annotation_file]
           if args.in_context_annotation_file else []),
         "--eval_frames_dir", args.eval_frames_dir,
         *(["--eval_annotation_file", args.eval_annotation_file]
           if args.eval_annotation_file else []),
         "--num_shot", str(shot), "--output_prefix", prefix,
         "--verb_noun_ratio", str(args.verb_noun_ratio),
         "--random_seed", str(args.random_seed)]
    )
    out_csv = os.path.join(work, f"generated-{shot}shot.csv")
    gen_argv = [
        "--model", args.model, "--dtype", args.dtype, "--device", args.device,
        "--eval_frames_dir", args.eval_frames_dir,
        *(["--eval_annotation_file", args.eval_annotation_file]
          if args.eval_annotation_file else []),
        "--in_context_query_map_file", f"{prefix}-{shot}-shot.jsonl",
        "--in_context_example_frames_dir", args.in_context_frames_dir,
        *(["--in_context_example_annotation_file", args.in_context_annotation_file]
          if args.in_context_annotation_file else []),
        "--batch_size", str(args.batch_size),
        "--random_seed", str(args.random_seed),
        "--output_csv", out_csv,
    ]
    if args.num_eval_datapoints:
        gen_argv += ["--num_eval_datapoints", str(args.num_eval_datapoints)]
    if model is None:
        gen.main(gen_argv)
    else:
        gen_args = gen.parse_args(gen_argv)
        gen.run(gen_args, model, tokenizer, gen.load_datasets(gen_args))
    return out_csv


def score_csv(args: argparse.Namespace, path: str) -> dict:
    from ..eval.metrics import generation_metric_suite
    from .generation_eval import read_columns

    preds, refs = read_columns(path)
    return generation_metric_suite(
        preds, refs,
        bert_score_model=args.bert_score_model,
        sts_biencoder_model=args.sts_biencoder_model,
        device=args.device,
    )


def run(args: argparse.Namespace, model=None, tokenizer=None) -> dict:
    """Score every shot's CSV (generated here in the full mode), print the
    PASS/FAIL table and write ``--output_json``; raise ``SystemExit(1)`` when
    a metric is outside the tolerance. Returns ``{"results", "failures"}``."""
    from ..eval.published import TABLES

    published = TABLES[args.published_table]

    csvs: dict[int, str] = {}
    work = args.work_dir or tempfile.mkdtemp(prefix="verify-quality-")
    os.makedirs(work, exist_ok=True)
    if args.generated_csv:
        for pair in args.generated_csv:
            shot, path = pair.split("=", 1)
            csvs[int(shot)] = path
    else:
        required = ("model", "eval_frames_dir", "in_context_frames_dir")
        missing = [k for k in required if getattr(args, k) is None]
        if missing:
            raise SystemExit(f"full run needs --{', --'.join(missing)} (or use --generated_csv)")
        for shot in args.num_shots:
            csvs[shot] = run_pipeline(args, shot, work, model, tokenizer)

    results: dict[str, dict] = {}
    failures = []
    for shot, path in sorted(csvs.items()):
        metrics = score_csv(args, path)
        results[str(shot)] = metrics
        expect = published.get(shot, {})
        for name, pub in expect.items():
            if name not in metrics:
                print(f"[skip] {shot}-shot {name}: published {pub:.4f}, not computed "
                      "(pass the local encoder checkpoint to enable)")
                continue
            got = metrics[name]
            ok = abs(got - pub) <= args.tolerance
            status = "PASS" if ok else "FAIL"
            print(f"[{status}] {shot}-shot {name}: got {got:.4f}, published {pub:.4f} "
                  f"(tol ±{args.tolerance})")
            if not ok:
                failures.append((shot, name, got, pub))

    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump({"results": results, "failures": failures,
                       "tolerance": args.tolerance, "table": args.published_table}, f)
    if failures:
        print(f"quality parity FAILED: {len(failures)} metric(s) outside ±{args.tolerance}")
        raise SystemExit(1)
    print("quality parity PASSED")
    return {"results": results, "failures": failures}


def main(argv: Optional[list[str]] = None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
