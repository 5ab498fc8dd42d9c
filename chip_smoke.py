"""On-card smoke test of the PyTorch port (eilev_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero, without the
final result line):

1. Print the card's name and power limit (nvidia-smi) and build the CUDA
   kernels from eilev_tpu_torch/csrc with nvcc.
2. Check each kernel against its plain PyTorch twin in bf16 at the shapes of
   the greedy-narration path: K1 (packed ViT attention) at (136, 257,
   3*1408), 16 heads x 88; K2 (packed causal OPT prefill attention) at
   (4, 766, 3*2560), 32 heads x 80, with all-ones and right-padded masks.
   Tolerance atol = rtol = 2e-2: one bf16 ulp of a rounded score, after
   scaling, moves a probability by under 1%.
3. Time each kernel against its twin with CUDA events (warm-up, median of 20).
4. Drive the main path at the full eilev-blip2-opt-2.7b geometry with random
   bf16 weights N(0, 0.02) from a seeded generator on the card: the 16-shot
   prompt layout of bench.py (17 videos x 8 frames x 224^2, 766 tokens),
   uint8 frames -> process_videos -> generate (greedy, 32 new tokens), at
   batch 1 and batch 4. The kernels' launch counters must rise by 39 (K1,
   one per ViT layer) and 32 (K2, one per OPT layer) per forward; every
   logit must be finite; the prefill logits through K2 must agree with the
   plain causal attention path on the same embeddings.

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

import numpy as np
import torch

SHOTS = 16
FRAMES = 8
MAX_NEW_TOKENS = 32
TEXT_TOKENS_PER_SHOT = 12
NEWLINE = 50118  # OPT "\n", the narration eos


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
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernels(tag: str, dev: torch.device) -> list[dict]:
    from eilev_tpu_torch.ops import fused_attention as fa

    g = torch.Generator(device=dev).manual_seed(0)
    results = []

    k1_qkv = torch.randn(136, 257, 3 * 1408, device=dev, generator=g).to(torch.bfloat16)
    k1 = lambda: fa.packed_qkv_attention(k1_qkv, 16, 88)  # noqa: E731
    k1_plain = lambda: fa.packed_qkv_attention_reference(k1_qkv, 16, 88, 88**-0.5)  # noqa: E731
    out, ref = k1(), k1_plain()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    print(f"[{tag}] K1 packed_qkv_attention (136,257,16x88) max_abs_err={err}")
    torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2)
    results.append({"name": "packed_qkv_attention", "replaces": "eilev_tpu/ops/fused_attention.py:81",
                    "max_abs_err": err, "run": k1, "plain": k1_plain})

    k2_qkv = torch.randn(4, 766, 3 * 2560, device=dev, generator=g).to(torch.bfloat16)
    ones = torch.ones(4, 766, dtype=torch.int32, device=dev)
    right = ones.clone()
    right[1, 600:] = 0
    right[3, 700:] = 0
    errs = []
    for name, mask in (("all-ones", ones), ("right-padded", right)):
        out = fa.packed_qkv_causal_attention(k2_qkv, 32, 80, mask)
        ref = fa.packed_qkv_causal_attention_reference(k2_qkv, 32, 80, mask, 80**-0.5)
        torch.cuda.synchronize()
        e = (out.float() - ref.float()).abs().max().item()
        print(f"[{tag}] K2 packed_qkv_causal_attention (4,766,32x80) {name} mask max_abs_err={e}")
        torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2)
        errs.append(e)
    k2 = lambda: fa.packed_qkv_causal_attention(k2_qkv, 32, 80, ones)  # noqa: E731
    k2_plain = lambda: fa.packed_qkv_causal_attention_reference(k2_qkv, 32, 80, ones, 80**-0.5)  # noqa: E731
    results.append({"name": "packed_qkv_causal_attention",
                    "replaces": "eilev_tpu/ops/fused_attention.py:187",
                    "max_abs_err": max(errs), "run": k2, "plain": k2_plain})

    for r in results:
        # in turns, plain first: plain, kernel, kernel, plain
        p1 = median_ms(r["plain"])
        k_a = median_ms(r["run"])
        k_b = median_ms(r["run"])
        p2 = median_ms(r["plain"])
        r["ms"], r["plain_ms"] = min(k_a, k_b), min(p1, p2)
        print(f"[{tag}] {r['name']} kernel_ms={k_a},{k_b} plain_ms={p1},{p2}")
    return results


def run_main_path(tag: str, dev: torch.device, counts: dict) -> None:
    from eilev_tpu_torch import configs
    from eilev_tpu_torch.generation import GenerationConfig, generate
    from eilev_tpu_torch.generation.decoding import _prefill
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration
    from eilev_tpu_torch.ops import fused_attention as fa
    from eilev_tpu_torch.ops.preprocess import process_videos

    cfg = configs.blip2_opt_2_7b()
    t0 = time.perf_counter()
    model = VideoBlipForConditionalGeneration(cfg, device=dev, dtype=torch.bfloat16).eval()
    random_init_(model, torch.Generator(device=dev).manual_seed(42), std=0.02)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[{tag}] model eilev-blip2-opt-2.7b bf16 params={n_params} init_s={time.perf_counter() - t0}")

    finite = []
    model.language_model.register_forward_hook(
        lambda mod, args, out: finite.append(torch.isfinite(out[0]).all())
    )
    gen_cfg = GenerationConfig(max_new_tokens=MAX_NEW_TOKENS, pad_token_id=1, eos_token_id=(NEWLINE,))
    n_layers_vit = cfg.vision_config.num_hidden_layers
    n_layers_lm = cfg.text_config.num_hidden_layers

    for batch, reps in ((1, 5), (4, 3)):
        ids, mask, vim = build_prompt(cfg.num_query_tokens, batch)
        n_videos = batch * (SHOTS + 1)
        frames = torch.from_numpy(
            np.random.default_rng(1).integers(0, 256, size=(n_videos, 3, FRAMES, 224, 224), dtype=np.uint8)
        ).to(dev)
        ids_d = torch.from_numpy(ids).to(dev)
        mask_d = torch.from_numpy(mask).to(dev)
        vim_d = torch.from_numpy(vim).to(dev)

        def step():
            pixel = process_videos(frames, dtype=torch.bfloat16)
            return generate(model, input_ids=ids_d, attention_mask=mask_d, pixel_values=pixel,
                            video_input_mask=vim_d, generation_config=gen_cfg)

        # the counted run: counters at 0 just before, read just after
        torch.cuda.reset_peak_memory_stats()
        fa.packed_qkv_attention.launches = 0
        fa.packed_qkv_causal_attention.launches = 0
        finite.clear()
        tokens = step()
        torch.cuda.synchronize()
        k1_n, k2_n = fa.packed_qkv_attention.launches, fa.packed_qkv_causal_attention.launches
        print(f"[{tag}] batch={batch} launches K1={k1_n} K2={k2_n} tokens_shape={tuple(tokens.shape)}")
        print(f"[{tag}] batch={batch} first tokens={tokens[0, :8].tolist()}")
        if batch == 1:
            counts["packed_qkv_attention"] = k1_n
            counts["packed_qkv_causal_attention"] = k2_n
        assert k1_n == n_layers_vit, f"K1 launched {k1_n} times, expected {n_layers_vit}"
        assert k2_n == n_layers_lm, f"K2 launched {k2_n} times, expected {n_layers_lm}"
        assert tokens.shape[0] == batch and tokens.shape[1] <= MAX_NEW_TOKENS, tokens.shape
        assert finite and bool(torch.stack(finite).all()), "non-finite logits"
        print(f"[{tag}] batch={batch} all {len(finite)} LM forwards gave finite logits")
        peak = torch.cuda.max_memory_allocated()

        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        p50 = statistics.median(times)
        print(f"[{tag}] batch={batch} generate_s={times} p50_s={p50} "
              f"videos_per_s={n_videos / p50} max_memory_allocated_bytes={peak}")

        if batch == 1:
            # prefill logits through K2 against the plain causal path (no
            # cache) on the same embeddings
            with torch.inference_mode():
                embeds = model.embed_and_scatter(ids_d, process_videos(frames, dtype=torch.bfloat16), vim_d)
                k2_logits, _ = _prefill(model, embeds, mask_d, MAX_NEW_TOKENS)
                plain_logits, _ = model.language_model(embeds, attention_mask=mask_d)
                a, b = k2_logits.float(), plain_logits[:, -1].float()
                cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
                rel = ((a - b).abs().max() / b.abs().max()).item()
                same = bool((a.argmax(-1) == b.argmax(-1)).all())
            print(f"[{tag}] prefill logits K2 vs plain: min_cosine={cos} max_rel_err={rel} same_argmax={same}")
            assert cos > 0.999 and rel < 5e-2, (cos, rel)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; this script runs only on a GPU")
    dev = torch.device("cuda", 0)
    tag = card_tag()
    print(tag)  # nvidia-smi --query-gpu=name,power.limit, as it prints it
    print(f"[{tag}] torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    try:
        from eilev_tpu_torch.ops._build import packed_attention_lib

        t0 = time.perf_counter()
        packed_attention_lib()
        print(f"[{tag}] built eilev_tpu_torch/csrc/packed_attention.cu in {time.perf_counter() - t0} s")
        kernels = check_kernels(tag, dev)
        counts: dict = {}
        run_main_path(tag, dev, counts)
    except Exception:
        traceback.print_exc()
        return 1
    line = {"kernels": [
        {"name": k["name"], "route": "cuda", "source": "eilev_tpu_torch/csrc/packed_attention.cu",
         "replaces": k["replaces"], "launches": counts[k["name"]], "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"]}
        for k in kernels
    ]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
