"""Batched narration generation over presampled in-context example maps
(counterpart of ``scripts/generate_narration_texts.py``).

Left-padded batched generation with the fixed "Question: What is the camera
wearer doing? Answer:" prompt through ``generation.generate`` on
``--device`` (the card by default; ``--draft``/``--draft_layers`` for
speculative decoding), writing (frame_path, video_uid,
clip_index, generated, ground_truth, in_context_frame_paths) rows to a CSV.

    python -m eilev_tpu_torch.cli.generate_narration_texts --model DIR \\
        --eval_frames_dir EVAL --in_context_query_map_file MAP.jsonl \\
        --in_context_example_frames_dir TRAIN --batch_size 4 --output_csv out.csv

``--model_parallel N`` shards the model over N processes, one card each
(tensor parallelism, ``parallel/tensor.py``), started by
``torchrun --nproc_per_node N -m eilev_tpu_torch.cli.generate_narration_texts
... --model_parallel N``; every rank generates the same tokens, rank 0
writes the CSV. The attention dispatch is set to ``xla`` there, as the JAX
CLI sets it (the packed and decode kernels K1-K4 still run, on the local
heads). The int8 weight modes do not run under it (``--int8_kv`` does).
"""

from __future__ import annotations

import argparse
import csv
import json
import random
from typing import Any, Optional

import numpy as np
import torch

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
PROMPT = "Question: What is the camera wearer doing? Answer:"


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True)
    p.add_argument("--processor", default=None)
    p.add_argument("--dtype", choices=list(DTYPES), default="bf16")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.add_argument("--vision_chunks", type=int, default=1,
                   help="run the ViT in N sequential chunks (caps the activation peak for large --batch_size)")
    p.add_argument("--fast_gelu", action="store_true", help="serving mode: tanh vision gelu (ops/gelu.py)")
    p.add_argument("--int8_lm", action="store_true", help="weight-only int8 LM matmuls (serving mode)")
    p.add_argument("--int8_kv", action="store_true", help="int8 KV cache, read by kernel K4 (serving mode)")
    p.add_argument("--int8_qformer", action="store_true", help="W8A8 Q-Former matmuls (serving mode)")
    p.add_argument("--w8a8_prefill", action="store_true", help="with --int8_lm: LM prefill matmuls W8A8")
    p.add_argument("--int8_vision", action="store_true", help="W8A8 vision tower (serving mode)")
    p.add_argument("--model_parallel", type=int, default=0,
                   help="shard the model weights over N processes, one device each (torchrun --nproc_per_node N)")
    p.add_argument("--draft_layers", type=int, default=0,
                   help="> 0: token-identical speculative greedy decoding with the first N layers self-drafting")
    p.add_argument("--draft_tokens", type=int, default=None,
                   help="draft tokens per verify pass (default 4 with --draft_layers, 8 with --draft "
                        "prompt_lookup, whose drafts cost no model pass)")
    p.add_argument("--draft", choices=("prompt_lookup",), default=None,
                   help="prompt_lookup: model-free token-identical speculative decoding, drafts from n-gram "
                        "matches against the prompt and the text generated so far")
    p.add_argument("--draft_match_len", type=int, default=3, help="longest n-gram tail of --draft prompt_lookup")
    p.add_argument("--vision_cache", type=int, default=0,
                   help="LRU video-feature cache capacity (videos), keyed by frame_path: each distinct "
                        "video runs the vision tower once across the whole run (0 = off)")
    p.add_argument("--eval_frames_dir", required=True)
    p.add_argument("--eval_annotation_file")
    p.add_argument("--in_context_query_map_file", required=True)
    p.add_argument("--in_context_example_frames_dir", required=True)
    p.add_argument("--in_context_example_annotation_file")
    p.add_argument("--batch_size", default=1, type=int)
    p.add_argument("--print_narration_texts", action="store_true")
    p.add_argument("--num_eval_datapoints", default=None, type=int)
    p.add_argument("--random_seed", type=int, default=42)
    p.add_argument("--generation_config", default='{"max_new_tokens": 512}')
    p.add_argument("--shuffle_in_context_example_frames", action="store_true")
    p.add_argument("--output_csv", required=True)
    p.add_argument("--wandb_project", default=None)
    return p.parse_args(argv)


def check_args(args: argparse.Namespace) -> None:
    """Refuse what cannot be combined."""
    if args.vision_cache and args.shuffle_in_context_example_frames:
        # the derangement ablation permutes videos relative to their
        # frame_paths, so path-keyed caching would reuse wrong features
        raise ValueError("--vision_cache cannot be combined with --shuffle_in_context_example_frames")


def load_datasets(args: argparse.Namespace) -> dict[str, Any]:
    """The presampled interleaved dataset (metadata only with
    ``--vision_cache``, then a lazy frame loader keyed by frame_path)."""
    from ..data.frame import FrameDataset, FrameInterleavedPresampledDataset

    dataset = FrameInterleavedPresampledDataset(
        args.eval_frames_dir,
        args.in_context_query_map_file,
        args.in_context_example_frames_dir,
        annotation_file=args.eval_annotation_file,
        in_context_example_annotation_file=args.in_context_example_annotation_file,
        return_frames=not args.vision_cache,
        shuffle_in_context_example_frames=args.shuffle_in_context_example_frames,
        rng=random.Random(args.random_seed),
    )
    frame_loader = None
    if args.vision_cache:
        ctx_raw = FrameDataset(args.in_context_example_frames_dir,
                               annotation_file=args.in_context_example_annotation_file)
        eval_raw = FrameDataset(args.eval_frames_dir, annotation_file=args.eval_annotation_file)

        def frame_loader(key):
            ds = ctx_raw if key in ctx_raw.dict_data else eval_raw
            return ds[key]["video"]

    return {"dataset": dataset, "frame_loader": frame_loader}


def run(args: argparse.Namespace, model, tokenizer, datasets: dict[str, Any]) -> list[dict]:
    """Narrate ``datasets["dataset"]`` (a sequence of ``{"items": [...shots,
    query]}``, each item with ``frame_path``, ``video_uid``, ``clip_index``,
    ``narration_text`` and, without a ``frame_loader``, ``video``) in
    batches of ``--batch_size``; write the CSV. Returns its rows."""
    from ..data.collate import DataCollatorForInterleavedVideoSeq2Seq
    from ..data.prompts import generate_input_ids_and_labels_from_interleaved
    from ..data.text import clean_narration_text, generate_chunks
    from ..generation import generate, generation_config_from_json
    from ..ops.preprocess import process_videos
    from ..parallel.distributed import is_primary
    from ..utils import WandbLogger

    check_args(args)
    config = model.config
    dtype, device = DTYPES[args.dtype], torch.device(args.device)
    img = config.vision_config.image_size
    dataset = datasets["dataset"]

    vision_cache = None
    if args.vision_cache:
        from ..serving import VideoFeatureCache

        vision_cache = VideoFeatureCache(
            model, capacity=args.vision_cache, bucket=max(args.vision_chunks, 1) * 8,
            preprocess=lambda px: process_videos(px, height=img, width=img, dtype=dtype),
        )

    def preprocess(datapoint):
        items = datapoint["items"]
        inputs = generate_input_ids_and_labels_from_interleaved(
            tokenizer,
            [(PROMPT + " " + clean_narration_text(i["narration_text"]), 1) for i in items[:-1]] + [(PROMPT, 1)],
            None,
            config.num_query_tokens,
            config.use_decoder_only_language_model,
        )
        query = items[-1]
        out = {
            "narration_text": clean_narration_text(query["narration_text"]),
            "in_context_frame_paths": [i["frame_path"] for i in items[:-1]],
            "frame_path": query["frame_path"],
            "video_uid": query["video_uid"],
            "clip_index": query["clip_index"],
            **inputs,
        }
        if "video" in items[0]:
            out["pixel_values"] = np.stack([i["video"] for i in items])
        return out

    # batch generation needs left padding
    collator = DataCollatorForInterleavedVideoSeq2Seq(pad_token_id=tokenizer.pad_token_id, padding_side="left")
    # the HF GenerationConfig JSON contract of the original CLI; unsupported
    # keys fail with the supported-key list
    gen_cfg = generation_config_from_json(
        json.loads(args.generation_config), pad_token_id=tokenizer.pad_token_id, default_max_new_tokens=512)

    def tensor(array) -> torch.Tensor:
        return torch.from_numpy(np.asarray(array)).to(device)

    logger = WandbLogger(project=args.wandb_project, enabled=args.wandb_project is not None and is_primary())
    rows: list[dict] = []
    meta_keys = ("frame_path", "video_uid", "clip_index", "narration_text", "in_context_frame_paths")
    n = len(dataset) if args.num_eval_datapoints is None else min(args.num_eval_datapoints, len(dataset))
    for chunk in generate_chunks(list(range(n)), args.batch_size):
        feats = [preprocess(dataset[i]) for i in chunk]
        meta = [{k: f.pop(k) for k in meta_keys} for f in feats]
        batch = collator(feats)
        pixel = video_features = None
        if vision_cache is not None:
            # key order matches the collator's video order: per row, the
            # in-context examples then the query
            keys = [p for m in meta for p in (*m["in_context_frame_paths"], m["frame_path"])]
            video_features = vision_cache.features(keys, loader=datasets.get("frame_loader"))
        else:
            pixel = process_videos(tensor(batch["pixel_values"]), height=img, width=img, dtype=dtype)
        tokens = generate(
            model,
            input_ids=tensor(batch["input_ids"]),
            attention_mask=tensor(batch["attention_mask"]),
            pixel_values=pixel,
            video_input_mask=tensor(batch["video_input_mask"]),
            generation_config=gen_cfg,
            vision_chunks=args.vision_chunks,
            draft_layers=args.draft_layers or None,
            draft_tokens=args.draft_tokens or (8 if args.draft == "prompt_lookup" else 4),
            draft=args.draft,
            draft_match_len=args.draft_match_len,
            video_features=video_features,
        )
        texts = tokenizer.batch_decode(tokens.cpu().numpy(), skip_special_tokens=True)
        if len(texts) != len(meta):
            # num_return_sequences > 1: generate returns nrs rows per input,
            # interleaved; each returned sequence gets its own output row
            nrs = len(texts) // len(meta)
            meta = [m for m in meta for _ in range(nrs)]
        for m, text in zip(meta, texts):
            row = {
                "frame_path": m["frame_path"],
                "video_uid": m["video_uid"],
                "clip_index": m["clip_index"],
                "generated": text.strip(),
                "ground_truth": m["narration_text"],
                "in_context_frame_paths": "|".join(m["in_context_frame_paths"]),
            }
            rows.append(row)
            if args.print_narration_texts and is_primary():
                print(f"Generated: {row['generated']}  |  GT: {row['ground_truth']}")

    if not is_primary():  # tensor parallelism: every rank holds the same rows
        return rows
    with open(args.output_csv, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    logger.log_table("generated_narration_texts", list(rows[0]), [[r[c] for c in rows[0]] for r in rows])
    print(f"wrote {len(rows)} rows to {args.output_csv}")
    return rows


def main(argv: Optional[list[str]] = None) -> list[dict]:
    args = parse_args(argv)
    check_args(args)
    from ..models.auto import load_model, load_tokenizer

    if args.fast_gelu:
        from ..ops.gelu import set_gelu_impl

        set_gelu_impl("fast")
    args, mesh = model_parallel_mesh(args)
    model, _ = load_model(
        args.model, dtype=DTYPES[args.dtype], int8_lm=args.int8_lm, int8_kv=args.int8_kv,
        int8_vision=args.int8_vision, int8_qformer=args.int8_qformer, w8a8_prefill=args.w8a8_prefill,
        device=args.device, mesh=mesh,
    )
    tokenizer = load_tokenizer(args.processor or args.model)
    return run(args, model, tokenizer, load_datasets(args))


def model_parallel_mesh(args: argparse.Namespace) -> tuple[argparse.Namespace, Any]:
    """(args, None) for one process; under ``--model_parallel N`` > 1 the
    tensor-parallel mesh of this rank (``parallel/mesh.tensor_parallel_mesh``),
    with ``--device`` made this rank's card and the attention dispatch set to
    ``xla``, as the JAX CLIs set it."""
    if args.model_parallel <= 1:
        return args, None
    from ..ops.attention import set_default_attention_impl
    from ..parallel.mesh import tensor_parallel_mesh

    mesh = tensor_parallel_mesh(args.model_parallel, args.device)
    set_default_attention_impl("xla")
    return argparse.Namespace(**{**vars(args), "device": str(mesh.device)}), mesh


if __name__ == "__main__":
    main()
