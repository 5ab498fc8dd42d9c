"""Continuous-batching narration serving over a presampled in-context map
(counterpart of ``scripts/serve.py``).

Requests arrive on an open-loop clock (``--arrival_rate`` requests a second,
exponential gaps from ``--random_seed``; 0 submits everything up front),
join the engine's fixed slots at decode-chunk boundaries and complete on
their own (``serving/engine.py``), on ``--device`` (the card by default).
Writes the CSV of ``generate_narration_texts`` (greedy rows are
token-identical per request) and prints one JSON line of serving metrics:
request latency p50/p95/p99/max, time to first chunk p50/p95, videos a
second, the cache compactions and resets, and with ``--draft`` the
speculative counters.

    python -m eilev_tpu_torch.cli.serve --model DIR --eval_frames_dir EVAL \\
        --in_context_query_map_file MAP.jsonl --in_context_example_frames_dir TRAIN \\
        --output_csv out.csv

At the defaults (bf16, ``--prefill_bucket 128``) every OPT admission whose
prompt is shorter than its bucket is left-padded, and such a request's rows
are token 0 (the reference's mask value is -inf in bf16: the padded query
rows are NaN); the JAX CLI behaves the same. Serve OPT in fp32 or with
``--prefill_bucket`` dividing the prompt length for real narrations.
"""

from __future__ import annotations

import argparse
import csv
import json
import random
import time
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
    p.add_argument("--eval_frames_dir", required=True)
    p.add_argument("--in_context_query_map_file", required=True)
    p.add_argument("--in_context_example_frames_dir", required=True)
    p.add_argument("--eval_annotation_file", default=None)
    p.add_argument("--in_context_example_annotation_file", default=None)
    p.add_argument("--num_eval_datapoints", type=int, default=None)
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--max_slots", type=int, default=4)
    p.add_argument("--max_len", type=int, default=2048)
    p.add_argument("--chunk_tokens", type=int, default=8)
    p.add_argument("--prefill_bucket", type=int, default=128)
    p.add_argument("--max_prompt_len", type=int, default=2048,
                   help="T5 engines: width of the per-slot cross-K/V buffers (seq2seq prompts never enter "
                        "the shared self cache)")
    p.add_argument("--draft", choices=["prompt_lookup"], default=None,
                   help="per-slot speculative decoding in the engine: each slot drafts from its own "
                        "prompt + emitted corpus and advances by its own acceptance (token-identical to "
                        "plain greedy serving)")
    p.add_argument("--draft_gamma", type=int, default=8, help="speculative window: drafted tokens per verify pass")
    p.add_argument("--draft_match_len", type=int, default=3,
                   help="longest n-gram tail tried by the prompt-lookup matcher")
    p.add_argument("--arrival_rate", type=float, default=0.0,
                   help="requests/sec (open loop, exponential gaps, seed --random_seed); 0 = submit "
                        "everything up front")
    p.add_argument("--vision_chunks", type=int, default=1)
    p.add_argument("--vision_cache", type=int, default=0,
                   help="LRU video-feature cache capacity (videos), keyed by frame_path: recurring "
                        "in-context videos skip the vision tower (0 = off)")
    p.add_argument("--model_parallel", type=int, default=0,
                   help="shard the model weights over N devices; not ported (one device)")
    p.add_argument("--int8_lm", action="store_true")
    p.add_argument("--int8_kv", action="store_true")
    p.add_argument("--int8_vision", action="store_true")
    p.add_argument("--int8_qformer", action="store_true")
    p.add_argument("--w8a8_prefill", action="store_true")
    p.add_argument("--fast_gelu", action="store_true")
    p.add_argument("--random_seed", type=int, default=42)
    p.add_argument("--output_csv", required=True)
    return p.parse_args(argv)


def check_args(args: argparse.Namespace) -> None:
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model_parallel > 1 is not ported: the port runs on one device (it waits for parallel/)")


def load_datasets(args: argparse.Namespace) -> dict[str, Any]:
    """The presampled interleaved dataset (metadata only with
    ``--vision_cache``, then a lazy frame loader keyed by frame_path)."""
    from .generate_narration_texts import load_datasets as narration_datasets

    return narration_datasets(argparse.Namespace(**vars(args), shuffle_in_context_example_frames=False))


def run(args: argparse.Namespace, model, tokenizer, datasets: dict[str, Any]):
    """Serve ``datasets["dataset"]`` (a sequence of ``{"items": [...shots,
    query]}``, each item with ``frame_path``, ``video_uid``, ``clip_index``,
    ``narration_text`` and, without a ``frame_loader``, ``video``) through
    the engine on the open-loop arrival clock; write the CSV and print the
    metrics line. Returns (rows, metrics)."""
    from ..data.prompts import generate_input_ids_and_labels_from_interleaved
    from ..data.text import clean_narration_text
    from ..generation import GenerationConfig
    from ..ops.preprocess import process_videos
    from ..serving import ContinuousBatchingEngine, Request, VideoFeatureCache

    check_args(args)
    config = model.config
    dtype, device = DTYPES[args.dtype], torch.device(args.device)
    img = config.vision_config.image_size
    dataset = datasets["dataset"]

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
            "frame_path": query["frame_path"],
            "video_uid": query["video_uid"],
            "clip_index": query["clip_index"],
            "in_context_frame_paths": [i["frame_path"] for i in items[:-1]],
            **inputs,
        }
        if "video" in items[0]:
            out["pixel_values"] = np.stack([i["video"] for i in items])
        return out

    gen_cfg = GenerationConfig(max_new_tokens=args.max_new_tokens, pad_token_id=tokenizer.pad_token_id)
    if gen_cfg.eos_token_id is None:  # the model's eos, as generate()
        gen_cfg = gen_cfg.with_eos(config.text_config.eos_token_id)

    feature_cache = None
    if args.vision_cache:
        feature_cache = VideoFeatureCache(
            model, capacity=args.vision_cache, bucket=max(args.vision_chunks, 1) * 8,
            preprocess=lambda px: process_videos(px, height=img, width=img, dtype=dtype),
        )
    engine = ContinuousBatchingEngine(
        model, gen_cfg,
        max_slots=args.max_slots, max_len=args.max_len, chunk_tokens=args.chunk_tokens,
        prefill_bucket=args.prefill_bucket, max_prompt_len=args.max_prompt_len,
        vision_chunks=args.vision_chunks, feature_cache=feature_cache,
        feature_loader=datasets.get("frame_loader") if feature_cache is not None else None,
        speculative=args.draft, spec_gamma=args.draft_gamma, spec_match_len=args.draft_match_len,
    )

    n = len(dataset) if args.num_eval_datapoints is None else min(args.num_eval_datapoints, len(dataset))
    arrival_rng = random.Random(args.random_seed)
    arrivals, gap = [], 0.0
    for _ in range(n):
        arrivals.append(gap)
        if args.arrival_rate > 0:
            gap += arrival_rng.expovariate(args.arrival_rate)

    meta: dict[int, dict] = {}
    submit_t: dict[int, float] = {}
    first_t: dict[int, float] = {}
    done: dict[int, Any] = {}
    latency: dict[int, float] = {}
    pending = list(range(n))
    videos_per_request = None
    t0 = time.perf_counter()
    while pending or not engine.idle:
        now = time.perf_counter() - t0
        for i in [i for i in pending if arrivals[i] <= now]:
            feats = preprocess(dataset[i])
            pixel = None
            if feature_cache is None:
                pixel = process_videos(torch.from_numpy(np.asarray(feats["pixel_values"])).to(device),
                                       height=img, width=img, dtype=dtype)
            keys = [*feats["in_context_frame_paths"], feats["frame_path"]]
            videos_per_request = len(keys)
            rid = engine.submit(Request(
                input_ids=np.asarray(feats["input_ids"]),
                pixel_values=pixel,
                video_input_mask=np.asarray(feats["video_input_mask"]),
                feature_keys=keys if feature_cache is not None else None,
            ))
            meta[rid] = feats
            submit_t[rid] = time.perf_counter() - t0
            pending.remove(i)
        if pending and engine.idle and arrivals[min(pending)] > now:
            time.sleep(min(0.01, arrivals[min(pending)] - now))
            continue
        completed = engine.step()
        now = time.perf_counter() - t0
        for rid in [*engine.started(), *(c.rid for c in completed)]:
            first_t.setdefault(rid, now - submit_t[rid])
        for c in completed:
            done[c.rid] = c
            latency[c.rid] = now - submit_t[c.rid]
    wall = time.perf_counter() - t0

    rows = []
    for rid in sorted(done):
        m = meta[rid]
        text = tokenizer.decode(done[rid].tokens, skip_special_tokens=True)
        rows.append({
            "frame_path": m["frame_path"],
            "video_uid": m["video_uid"],
            "clip_index": m["clip_index"],
            "generated": text.strip(),
            "ground_truth": m["narration_text"],
            "in_context_frame_paths": "|".join(m["in_context_frame_paths"]),
        })
    with open(args.output_csv, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["frame_path", "video_uid", "clip_index", "generated",
                                               "ground_truth", "in_context_frame_paths"])
        writer.writeheader()
        writer.writerows(rows)

    def pct(values: list, q: float):
        values = sorted(values)
        return round(values[min(len(values) - 1, int(len(values) * q))], 3) if values else None

    lats = sorted(latency.values())
    metrics = {
        "requests": n,
        "wall_sec": round(wall, 3),
        "videos_per_sec": round(n * (videos_per_request or 0) / wall, 3),
        "latency_p50_sec": round(lats[len(lats) // 2], 3) if lats else None,
        "latency_p95_sec": pct(lats, 0.95),
        "latency_p99_sec": pct(lats, 0.99),
        "latency_max_sec": round(lats[-1], 3) if lats else None,
        # time from submission to the step that gave a request its first tokens
        "first_chunk_p50_sec": pct(list(first_t.values()), 0.5),
        "first_chunk_p95_sec": pct(list(first_t.values()), 0.95),
        # cache-pressure events: compactions are the rolling reclaim (no
        # stall); resets only ever fire on an empty engine
        "cache_compactions": engine.stats["compactions"],
        "cache_resets": engine.stats["resets"],
        "arrival_rate": args.arrival_rate,
        "max_slots": args.max_slots,
        "chunk_tokens": args.chunk_tokens,
    }
    if args.draft:
        # realised speculative advance: emitted tokens per live row a pass
        metrics["spec_tokens_per_pass"] = round(engine.stats["spec_tokens"] / max(engine.stats["spec_rows"], 1), 3)
        metrics["spec_passes"] = engine.stats["spec_passes"]
        metrics["spec_fallback_chunks"] = engine.stats["spec_fallback_chunks"]
        metrics["evictions"] = engine.stats["evictions"]
    print(json.dumps(metrics))
    return rows, metrics


def main(argv: Optional[list[str]] = None):
    args = parse_args(argv)
    check_args(args)
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
