"""On-card smoke test of the PyTorch port (eilev_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero, without the
final result line):

1. Print the card's name and power limit (nvidia-smi) and build the CUDA
   kernels from eilev_tpu_torch/csrc with nvcc, one process per source, all
   started together.
2. Check each kernel against its plain PyTorch twin in bf16 at the shapes of
   the greedy-narration path: K1 (packed ViT attention) at (136, 257,
   3*1408), 16 heads x 88; K2 (packed causal OPT prefill attention) at
   (4, 766, 3*2560), 32 heads x 80, with all-ones and right-padded masks;
   K3 (decode attention, bf16 stacked cache) at (L=32, B=4, S=798, 32x80),
   layer 17, with a full and a mid-decode mask (slots >= 780 unfilled), and
   at a GQA shape (32 heads over 8 kv heads x 128, S=2048, score-side
   scale); K4 (decode attention, int8 cache + bf16 scales) at the flagship
   shape against dequantize_kv + the twin. Tolerance atol = rtol = 2e-2 for
   K1-K3 (one bf16 ulp of a rounded score, after scaling, moves a probability
   by under 1%) and 3e-2 for K4 (the JAX int8 kernel test's bar).
3. Time each kernel against its twin with CUDA events, in turns (plain,
   kernel, kernel, plain; warm-up, median of 20), each call queued behind a
   device sleep so that the events measure device time. K3/K4 are timed as
   one decode step's 32 launches, one per layer of the 1 GB cache, so no
   call finds its layer in the 50 MB L2 cache; the time given is per launch.
4. Drive the main path at the full eilev-blip2-opt-2.7b geometry with random
   bf16 weights N(0, 0.02) from a seeded generator on the card: the 16-shot
   prompt layout of bench.py (17 videos x 8 frames x 224^2, 766 tokens),
   uint8 frames -> process_videos -> generate (greedy, 32 new tokens), at
   batch 1 and batch 4. Per run the launch counters must rise by 39 (K1, one
   per ViT layer), 32 (K2, one per OPT layer) and 32 per one-token LM
   forward (K3); every logit must be finite; the prefill logits through K2
   must agree with the plain causal path on the same embeddings.
5. The int8 serving mode (load_model(int8_lm=True, int8_kv=True)): the same
   model quantized on the card, in place, from its own bf16 weights; batch 1
   and batch 4. K1 = 39, K2 = 32, K4 = 32 per one-token forward, K3 = 0;
   every logit finite; the prefill logits' min cosine against the bf16
   model's on the same embeddings above INT8_MIN_COSINE.
6. One batch-4 run with every serving mode on: also W8A8 prefill, W8A8
   vision tower and Q-Former, fast gelu. Counts and finiteness as in 5.

Prints every number tagged with the card's name and power limit, then one
JSON line of per-kernel results, then the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SHOTS = 16
FRAMES = 8
MAX_NEW_TOKENS = 32
TEXT_TOKENS_PER_SHOT = 12
NEWLINE = 50118  # OPT "\n", the narration eos
# int8 per-channel weight rounding puts about 0.2% relative noise on each of
# the 128 LM matmuls; with random N(0, 0.02) weights at full depth and bf16
# activations that is a cosine near 0.999 (the JAX int8 test asks 0.999 of a
# 2-layer model). 0.99 leaves room for the depth and still fails a wrong
# scale, transpose or layer, which give a cosine near 0.
INT8_MIN_COSINE = 0.99
# device sleep before each timed call: ~20 ms at the H100's 1.98 GHz, longer
# than the host takes to enqueue a 32-layer decode step of the plain twin
SLEEP_CYCLES = 40_000_000


def card_tag() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def build_prompt(num_query_tokens: int, batch: int):
    """bench.py's interleaved 16-shot layout: bos + per video [32 query slots +
    newline + 12 text tokens]."""
    rng = np.random.default_rng(0)
    ids, vim = [2], [0]
    for _ in range(SHOTS + 1):
        ids += [1] * num_query_tokens + [NEWLINE]
        vim += [1] * num_query_tokens + [0]
        toks = rng.integers(1000, 40000, size=TEXT_TOKENS_PER_SHOT).tolist()
        ids += toks
        vim += [0] * len(toks)
    ids = np.asarray([ids] * batch)
    vim = np.asarray([vim] * batch)
    return ids, np.ones_like(ids), vim


def random_init_(model: torch.nn.Module, generator: torch.Generator, std: float = 0.02) -> None:
    """Every parameter N(0, std) from ``generator``, norms included, as bench.py
    initialises the JAX model."""
    with torch.no_grad():
        for param in model.parameters():
            param.normal_(0.0, std, generator=generator)


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` by CUDA events. Each timed call is queued
    behind a device sleep (~20 ms), so the host has enqueued all of its launches
    before the start event fires: the events bracket device work, not the
    host's launch overhead (which exceeds a decode-attention launch)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def counters() -> dict:
    """The four kernels' launch counters, by kernel name."""
    from eilev_tpu_torch.ops import decode_attention as da
    from eilev_tpu_torch.ops import fused_attention as fa

    return {
        "packed_qkv_attention": fa.packed_qkv_attention.launches,
        "packed_qkv_causal_attention": fa.packed_qkv_causal_attention.launches,
        "decode_attention_stacked_bf16": da.decode_attention_stacked.launches_bf16,
        "decode_attention_stacked_int8": da.decode_attention_stacked.launches_int8,
    }


def reset_counters() -> None:
    from eilev_tpu_torch.ops import decode_attention as da
    from eilev_tpu_torch.ops import fused_attention as fa

    fa.packed_qkv_attention.launches = 0
    fa.packed_qkv_causal_attention.launches = 0
    da.decode_attention_stacked.launches_bf16 = 0
    da.decode_attention_stacked.launches_int8 = 0


def build_kernels(tag: str) -> None:
    from eilev_tpu_torch.ops._build import decode_attention_lib, packed_attention_lib

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=2) as pool:  # nvcc runs outside the GIL
        futures = {src: pool.submit(timed, fn) for src, fn in (
            ("packed_attention.cu", packed_attention_lib), ("decode_attention.cu", decode_attention_lib))}
        for src, fut in futures.items():
            print(f"[{tag}] built eilev_tpu_torch/csrc/{src} in {fut.result()} s")


def check_close(tag: str, label: str, out, ref, tol: float) -> float:
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    print(f"[{tag}] {label} max_abs_err={err}")
    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)
    return err


def check_kernels(tag: str, dev: torch.device) -> list[dict]:
    from eilev_tpu_torch.ops import decode_attention as da
    from eilev_tpu_torch.ops import fused_attention as fa

    g = torch.Generator(device=dev).manual_seed(0)
    results = []

    k1_qkv = torch.randn(136, 257, 3 * 1408, device=dev, generator=g).to(torch.bfloat16)
    k1 = lambda: fa.packed_qkv_attention(k1_qkv, 16, 88)  # noqa: E731
    k1_plain = lambda: fa.packed_qkv_attention_reference(k1_qkv, 16, 88, 88**-0.5)  # noqa: E731
    err = check_close(tag, "K1 packed_qkv_attention (136,257,16x88)", k1(), k1_plain(), 2e-2)
    results.append({"name": "packed_qkv_attention", "source": "eilev_tpu_torch/csrc/packed_attention.cu",
                    "replaces": "eilev_tpu/ops/fused_attention.py:81",
                    "max_abs_err": err, "run": k1, "plain": k1_plain, "per_call": 1})

    k2_qkv = torch.randn(4, 766, 3 * 2560, device=dev, generator=g).to(torch.bfloat16)
    ones = torch.ones(4, 766, dtype=torch.int32, device=dev)
    right = ones.clone()
    right[1, 600:] = 0
    right[3, 700:] = 0
    errs = []
    for name, mask in (("all-ones", ones), ("right-padded", right)):
        errs.append(check_close(
            tag, f"K2 packed_qkv_causal_attention (4,766,32x80) {name} mask",
            fa.packed_qkv_causal_attention(k2_qkv, 32, 80, mask),
            fa.packed_qkv_causal_attention_reference(k2_qkv, 32, 80, mask, 80**-0.5), 2e-2))
    k2 = lambda: fa.packed_qkv_causal_attention(k2_qkv, 32, 80, ones)  # noqa: E731
    k2_plain = lambda: fa.packed_qkv_causal_attention_reference(k2_qkv, 32, 80, ones, 80**-0.5)  # noqa: E731
    results.append({"name": "packed_qkv_causal_attention", "source": "eilev_tpu_torch/csrc/packed_attention.cu",
                    "replaces": "eilev_tpu/ops/fused_attention.py:187",
                    "max_abs_err": max(errs), "run": k2, "plain": k2_plain, "per_call": 1})

    # K3 / K4 at the flagship decode shape: 32 layers, batch 4, 766 + 32 slots
    n_layers, b, s, nh, hd = 32, 4, 798, 32, 80
    q = torch.randn(b, nh * hd, device=dev, generator=g).to(torch.bfloat16)
    k5 = torch.randn(n_layers, b, s, nh, hd, device=dev, generator=g).to(torch.bfloat16)
    v5 = torch.randn(n_layers, b, s, nh, hd, device=dev, generator=g).to(torch.bfloat16)
    kb, vb = k5.view(n_layers, b, s, nh * hd), v5.view(n_layers, b, s, nh * hd)
    full = torch.ones(b, s, dtype=torch.int32, device=dev)
    mid = full.clone()
    mid[:, 780:] = 0
    kw = dict(num_heads=nh, head_dim=hd)
    errs = [check_close(
        tag, f"K3 decode_attention_stacked bf16 (32,4,798,32x80) layer 17 {name} mask",
        da.decode_attention_stacked(q, kb, vb, mask, 17, **kw),
        da.decode_attention_stacked_reference(q, kb, vb, mask, 17, **kw), 2e-2)
        for name, mask in (("full", full), ("mid-decode", mid))]
    gq = torch.randn(4, 32 * 128, device=dev, generator=g).to(torch.bfloat16)
    gk = torch.randn(2, 4, 2048, 8 * 128, device=dev, generator=g).to(torch.bfloat16)
    gv = torch.randn(2, 4, 2048, 8 * 128, device=dev, generator=g).to(torch.bfloat16)
    gkw = dict(num_heads=32, head_dim=128, kv_heads=8, scale_query=False)
    errs.append(check_close(
        tag, "K3 decode_attention_stacked bf16 GQA (2,4,2048,32 over 8 x128) score-side scale",
        da.decode_attention_stacked(gq, gk, gv, full.new_ones(4, 2048), 1, **gkw),
        da.decode_attention_stacked_reference(gq, gk, gv, full.new_ones(4, 2048), 1, **gkw), 2e-2))
    del gq, gk, gv
    k3 = lambda: [da.decode_attention_stacked(q, kb, vb, mid, i, **kw) for i in range(n_layers)]  # noqa: E731
    k3_plain = lambda: [da.decode_attention_stacked_reference(q, kb, vb, mid, i, **kw)  # noqa: E731
                        for i in range(n_layers)]
    results.append({"name": "decode_attention_stacked_bf16", "source": "eilev_tpu_torch/csrc/decode_attention.cu",
                    "replaces": "eilev_tpu/ops/decode_attention.py:117",
                    "max_abs_err": max(errs), "run": k3, "plain": k3_plain, "per_call": n_layers})

    k8, ks = da.quantize_kv(k5)
    v8, vs = da.quantize_kv(v5)
    k8f, v8f = k8.view(n_layers, b, s, nh * hd), v8.view(n_layers, b, s, nh * hd)
    i8 = dict(k_scale=ks, v_scale=vs, **kw)
    layer = 17
    ref = da.decode_attention_stacked_reference(
        q, da.dequantize_kv(k8[layer:layer + 1], ks[layer:layer + 1]).view(1, b, s, nh * hd),
        da.dequantize_kv(v8[layer:layer + 1], vs[layer:layer + 1]).view(1, b, s, nh * hd), mid, 0, **kw)
    err = check_close(tag, "K4 decode_attention_stacked int8 (32,4,798,32x80) layer 17 mid-decode mask"
                      " vs dequantize_kv + twin", da.decode_attention_stacked(q, k8f, v8f, mid, layer, **i8),
                      ref, 3e-2)
    k4 = lambda: [da.decode_attention_stacked(q, k8f, v8f, mid, i, **i8) for i in range(n_layers)]  # noqa: E731
    k4_plain = lambda: [da.decode_attention_stacked_reference(q, k8f, v8f, mid, i, **i8)  # noqa: E731
                        for i in range(n_layers)]
    results.append({"name": "decode_attention_stacked_int8", "source": "eilev_tpu_torch/csrc/decode_attention.cu",
                    "replaces": "eilev_tpu/ops/decode_attention.py:75",
                    "max_abs_err": err, "run": k4, "plain": k4_plain, "per_call": n_layers})

    for r in results:
        # in turns, plain first: plain, kernel, kernel, plain. The closures
        # are dropped after, so their 1.6 GB of test caches are freed before
        # the main path's peak memory is read.
        n, run, plain = r.pop("per_call"), r.pop("run"), r.pop("plain")
        p1 = median_ms(plain) / n
        k_a = median_ms(run) / n
        k_b = median_ms(run) / n
        p2 = median_ms(plain) / n
        r["ms"], r["plain_ms"] = min(k_a, k_b), min(p1, p2)
        print(f"[{tag}] {r['name']} kernel_ms={k_a},{k_b} plain_ms={p1},{p2} (per launch)")
    return results


class Narration:
    """The main path's inputs at one batch size, and the calls that drive it."""

    def __init__(self, model, cfg, batch: int, dev: torch.device):
        ids, mask, vim = build_prompt(cfg.num_query_tokens, batch)
        self.model, self.batch = model, batch
        self.n_videos = batch * (SHOTS + 1)
        self.frames = torch.from_numpy(
            np.random.default_rng(1).integers(0, 256, size=(self.n_videos, 3, FRAMES, 224, 224), dtype=np.uint8)
        ).to(dev)
        self.ids = torch.from_numpy(ids).to(dev)
        self.mask = torch.from_numpy(mask).to(dev)
        self.vim = torch.from_numpy(vim).to(dev)

    def generate(self):
        from eilev_tpu_torch.generation import GenerationConfig, generate
        from eilev_tpu_torch.ops.preprocess import process_videos

        pixel = process_videos(self.frames, dtype=torch.bfloat16)
        return generate(self.model, input_ids=self.ids, attention_mask=self.mask, pixel_values=pixel,
                        video_input_mask=self.vim,
                        generation_config=GenerationConfig(
                            max_new_tokens=MAX_NEW_TOKENS, pad_token_id=1, eos_token_id=(NEWLINE,)))

    @torch.inference_mode()
    def embeds(self):
        from eilev_tpu_torch.ops.preprocess import process_videos

        return self.model.embed_and_scatter(self.ids, process_videos(self.frames, dtype=torch.bfloat16), self.vim)

    @torch.inference_mode()
    def prefill_logits(self, embeds):
        """(B, S, vocab) logits of the prefill into a fresh cache (K2 path)."""
        from eilev_tpu_torch.models import init_cache

        cache = init_cache(self.model.config.text_config, self.batch, embeds.shape[1] + MAX_NEW_TOKENS,
                           dtype=embeds.dtype, device=embeds.device)
        logits, _ = self.model.lm_forward(embeds, attention_mask=self.mask, cache=cache)
        return logits


def drive(tag: str, label: str, run: Narration, lm_calls: list, expect: dict, reps: int) -> dict:
    """One counted run (counters at 0 just before, read just after), its checks,
    then ``reps`` timed runs. ``expect`` maps a kernel to its launches per
    forward, "lm" meaning per LM layer and one-token forward."""
    n_vit = run.model.config.vision_config.num_hidden_layers
    n_lm = run.model.config.text_config.num_hidden_layers
    torch.cuda.reset_peak_memory_stats()
    lm_calls.clear()
    reset_counters()
    tokens = run.generate()
    torch.cuda.synchronize()
    counts = counters()
    one_token = sum(1 for s_len, _ in lm_calls if s_len == 1)
    print(f"[{tag}] {label} batch={run.batch} launches {counts} one_token_lm_forwards={one_token} "
          f"tokens_shape={tuple(tokens.shape)}")
    print(f"[{tag}] {label} batch={run.batch} first tokens={tokens[0, :8].tolist()}")
    want = {"packed_qkv_attention": n_vit, "packed_qkv_causal_attention": n_lm}
    want.update({name: n_lm * one_token if per == "lm" else per for name, per in expect.items()})
    assert counts == want, f"launch counts {counts}, expected {want}"
    assert one_token >= 1, "no decode step ran"
    assert tokens.shape[0] == run.batch and tokens.shape[1] <= MAX_NEW_TOKENS, tokens.shape
    assert lm_calls and all(bool(ok) for _, ok in lm_calls), "non-finite logits"
    print(f"[{tag}] {label} batch={run.batch} all {len(lm_calls)} LM forwards gave finite logits")
    peak = torch.cuda.max_memory_allocated()

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.generate()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    p50 = statistics.median(times)
    print(f"[{tag}] {label} batch={run.batch} generate_s={times} p50_s={p50} "
          f"videos_per_s={run.n_videos / p50} max_memory_allocated_bytes={peak}")
    return counts


def run_main_path(tag: str, dev: torch.device, launches: dict):
    """The bf16 path (phase 4). Returns the model, its LM forward log and the
    per-batch inputs, for the serving phases."""
    from eilev_tpu_torch import configs
    from eilev_tpu_torch.generation.decoding import _prefill
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration

    cfg = configs.blip2_opt_2_7b()
    t0 = time.perf_counter()
    model = VideoBlipForConditionalGeneration(cfg, device=dev, dtype=torch.bfloat16).eval()
    random_init_(model, torch.Generator(device=dev).manual_seed(42), std=0.02)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[{tag}] model eilev-blip2-opt-2.7b bf16 params={n_params} init_s={time.perf_counter() - t0}")

    # (sequence length, all logits finite) per LM forward; the flag stays a
    # device tensor, so the hook adds no host synchronisation to timed runs
    lm_calls: list = []
    model.language_model.register_forward_hook(
        lambda mod, args, out: lm_calls.append((args[0].shape[1], torch.isfinite(out[0]).all()))
    )
    runs = {batch: Narration(model, cfg, batch, dev) for batch in (1, 4)}
    for batch, reps in ((1, 5), (4, 3)):
        counts = drive(tag, "bf16", runs[batch], lm_calls,
                       {"decode_attention_stacked_bf16": "lm", "decode_attention_stacked_int8": 0}, reps)
        if batch == 1:
            launches.update({k: counts[k] for k in
                             ("packed_qkv_attention", "packed_qkv_causal_attention", "decode_attention_stacked_bf16")})

    # prefill logits through K2 against the plain causal path (no cache) on
    # the same embeddings
    run = runs[1]
    with torch.inference_mode():
        embeds = run.embeds()
        k2_logits, _ = _prefill(model, embeds, run.mask, MAX_NEW_TOKENS)
        plain_logits, _ = model.language_model(embeds, attention_mask=run.mask)
        a, b = k2_logits.float(), plain_logits[:, -1].float()
        cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
        rel = ((a - b).abs().max() / b.abs().max()).item()
        same = bool((a.argmax(-1) == b.argmax(-1)).all())
    print(f"[{tag}] prefill logits K2 vs plain: min_cosine={cos} max_rel_err={rel} same_argmax={same}")
    assert cos > 0.999 and rel < 5e-2, (cos, rel)
    return model, lm_calls, runs


def run_int8_serving(tag: str, model, lm_calls: list, runs: dict, launches: dict) -> None:
    """Phases 5 and 6: the int8 serving modes, quantized in place on the card."""
    from eilev_tpu_torch.ops.gelu import set_gelu_impl
    from eilev_tpu_torch.ops.quantization import quantize_model_

    int8_counts = {"decode_attention_stacked_bf16": 0, "decode_attention_stacked_int8": "lm"}
    # the bf16 model's prefill logits on the embeddings the int8 LM will see
    # (the vision tower and Q-Former stay bf16 in this mode)
    embeds = {batch: run.embeds() for batch, run in runs.items()}
    bf16_logits = {batch: run.prefill_logits(embeds[batch]) for batch, run in runs.items()}

    t0 = time.perf_counter()
    quantize_model_(model, int8_lm=True, int8_kv=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[{tag}] quantized the LM in place (int8_lm, int8_kv) in {time.perf_counter() - t0} s; "
          f"memory_allocated_bytes={torch.cuda.memory_allocated()}")
    for batch, reps in ((1, 3), (4, 2)):
        run = runs[batch]
        counts = drive(tag, "int8 serving", run, lm_calls, int8_counts, reps)
        if batch == 1:
            launches["decode_attention_stacked_int8"] = counts["decode_attention_stacked_int8"]
        a = run.prefill_logits(embeds[batch]).float().flatten(0, 1)
        b = bf16_logits[batch].float().flatten(0, 1)
        cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
        same = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        print(f"[{tag}] int8 serving batch={batch} prefill logits vs bf16 over {a.shape[0]} positions: "
              f"min_cosine={cos.min().item()} mean_cosine={cos.mean().item()} same_argmax_share={same}")
        assert bool(torch.isfinite(a).all()), "non-finite int8 prefill logits"
        assert cos.min().item() > INT8_MIN_COSINE, cos.min().item()
    del bf16_logits, embeds

    quantize_model_(model, int8_lm=True, int8_kv=True, w8a8_prefill=True, int8_vision=True, int8_qformer=True)
    torch.cuda.empty_cache()
    set_gelu_impl("fast")
    try:
        drive(tag, "every serving mode (int8 LM+KV, W8A8 prefill/vision/Q-Former, fast gelu)",
              runs[4], lm_calls, int8_counts, reps=2)
    finally:
        set_gelu_impl("exact")


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; this script runs only on a GPU")
    dev = torch.device("cuda", 0)
    tag = card_tag()
    print(tag)  # nvidia-smi --query-gpu=name,power.limit, as it prints it
    print(f"[{tag}] torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    try:
        build_kernels(tag)
        kernels = check_kernels(tag, dev)
        launches: dict = {}
        model, lm_calls, runs = run_main_path(tag, dev, launches)
        run_int8_serving(tag, model, lm_calls, runs, launches)
    except Exception:
        traceback.print_exc()
        return 1
    line = {"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"], "replaces": k["replaces"],
         "launches": launches[k["name"]], "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"]}
        for k in kernels
    ]}
    assert all(k["launches"] > 0 for k in line["kernels"]), line
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
