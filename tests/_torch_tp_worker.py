"""The rank side of tests/test_torch_parallel_tp.py and
tests/test_torch_parallel_tp_generate.py: one process of a 2-rank gloo group
on the CPU, every rank on one model axis of 2 (tensor parallelism). It
imports torch and the port only (no jax), so that a spawned rank starts in
seconds; the parent passes numpy params and inputs, and reads what each rank
saved (``rank{r}.pt``)."""

import datetime
import os
import time

import numpy as np
import torch
import torch.multiprocessing as mp

RANKS = 2
DEADLINE_S = 240


def spawn(target, out_dir, *args):
    """Start ``target(rank, init_file, out_dir, *args)`` on 2 ranks; returns
    the spawn context (join it with :func:`join`)."""
    return mp.spawn(target, args=(os.path.join(out_dir, "rendezvous"), out_dir, *args), nprocs=RANKS, join=False)


def join(ctx, out_dir) -> list:
    """Wait for the ranks (killed after ``DEADLINE_S``) and load their results."""
    start = time.monotonic()
    while not ctx.join(timeout=5):
        if time.monotonic() - start > DEADLINE_S:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the gloo ranks did not finish in {DEADLINE_S} s")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(RANKS)]


def _mesh(rank, init_file):
    torch.set_num_threads(1)
    from eilev_tpu_torch.parallel import distributed, make_mesh

    distributed.initialize("cpu", init_method=f"file://{init_file}", world_size=RANKS, rank=rank,
                           timeout=datetime.timedelta(seconds=120))
    return make_mesh(data=1, model=RANKS, device="cpu")


def _sharded(cls, config, params, tp, **kw):
    """The port module ``cls`` of ``config`` with local heads under ``tp``,
    holding this rank's part of the numpy flax ``params``."""
    from eilev_tpu_torch.models.convert import flax_to_state_dict
    from eilev_tpu_torch.parallel.tensor import shard_state_dict

    model = cls(config, tp=tp, **kw)
    model.load_state_dict(shard_state_dict(flax_to_state_dict(params), config, tp), strict=True)
    return model.eval().requires_grad_(False)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_tp.py: the LMs' forwards
# ---------------------------------------------------------------------------


def _decoder_only(model, init_cache, inp) -> dict:
    """embed, the no-cache forward and a prefill + decode steps of an OPT or
    LLaMA model (this rank's heads, the gathered logits)."""
    out = {"embed": model.embed(_t(inp["ids"])),
           "logits": model(_t(inp["embeds"]), attention_mask=_t(inp["mask"]))[0]}
    b, s = inp["mask"].shape
    cache = init_cache(model.config, b, s + len(inp["steps"]), tp=model.tp)
    out["heads"] = cache["k"].shape[3]
    steps = []
    for x, m in [(inp["embeds"], inp["mask"])] + inp["steps"]:
        logits, cache = model(_t(x), attention_mask=_t(m), cache=cache)
        steps.append(logits)
    out["cached"] = steps
    return out


def _t5(model, inp) -> dict:
    emb, mask, dec = _t(inp["emb"]), _t(inp["mask"]), _t(inp["dec"])
    enc = model.encode(emb, mask)
    out = {"encoder": enc, "logits": model(emb, mask, dec, _t(inp["dec_mask"])),
           "classes": model.score_classes(_t(inp["classes"]), _t(inp["class_mask"]), enc, mask)}
    cache = model.init_decode_cache(enc, dec.shape[1])
    out["heads"] = cache["k"].shape[3]
    steps = []
    for j in range(dec.shape[1]):
        logits, cache = model.decode_step(dec[:, j:j + 1], None, mask, cache)
        steps.append(logits)
    out["cached"] = steps
    return out


@torch.no_grad()
def forwards_main(rank, init_file, out_dir, cases):
    """``cases``: name -> (config, numpy flax params, inputs) for "llama",
    "opt" and "t5"; saves each forward's outputs."""
    from eilev_tpu_torch.models.llama import LlamaForCausalLM
    from eilev_tpu_torch.models.opt import OPTForCausalLM, init_cache
    from eilev_tpu_torch.models.t5 import T5ForConditionalGeneration

    mesh = _mesh(rank, init_file)
    try:
        out = {}
        for name, cls in (("llama", LlamaForCausalLM), ("opt", OPTForCausalLM)):
            cfg, params, inp = cases[name]
            out[name] = _decoder_only(_sharded(cls, cfg, params, mesh.tp), init_cache, inp)
        cfg, params, inp = cases["t5"]
        out["t5"] = _t5(_sharded(T5ForConditionalGeneration, cfg, params, mesh.tp), inp)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_tp_generate.py: generate, classify and the CLIs
# ---------------------------------------------------------------------------


def _videoblip(config, params, tp):
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration, params_from_jax
    from eilev_tpu_torch.parallel.tensor import shard_state_dict

    model = VideoBlipForConditionalGeneration(config, device="cpu", tp=tp)
    model.load_state_dict(shard_state_dict(params_from_jax(params, config), config, tp), strict=True)
    return model.eval()


def generate_main(rank, init_file, out_dir, models, inputs, cli_runs):
    """``models``: name -> (config, numpy params) of tiny VideoBLIPs ("opt",
    "opt_int8_kv", "t5"); ``inputs`` the shared prompt, videos and classes;
    ``cli_runs``: (CLI name, argv) pairs, each run with ``--model_parallel 2``
    (rank 0 writes its output file). Saves the tokens and scores."""
    from eilev_tpu_torch.generation import GenerationConfig, generate
    from eilev_tpu_torch.generation.classify import classify

    mesh = _mesh(rank, init_file)
    try:
        out = {}
        batch = {k: _t(inputs[k]) for k in ("input_ids", "attention_mask", "pixel_values", "video_input_mask")}
        for name, beams in (("opt", 1), ("opt", 3), ("opt_int8_kv", 1), ("t5", 1)):
            model = _videoblip(*models[name], mesh.tp)
            cfg = GenerationConfig(max_new_tokens=5, num_beams=beams, pad_token_id=1)
            out[f"{name}_beams{beams}"] = generate(model, generation_config=cfg, **batch)
        for name in ("opt", "t5"):
            model = _videoblip(*models[name], mesh.tp)
            out[f"{name}_classify"] = classify(
                model, prompt_input_ids=batch["input_ids"], prompt_attention_mask=batch["attention_mask"],
                pixel_values=batch["pixel_values"], prompt_video_input_mask=batch["video_input_mask"],
                class_input_ids=_t(inputs["class_ids"]), class_batch_size=4)
        from eilev_tpu_torch.cli import generate_narration_texts, icl_eval

        mains = {"generate_narration_texts": generate_narration_texts.main, "icl_eval": icl_eval.main}
        for name, argv in cli_runs:
            mains[name](argv + ["--model_parallel", str(RANKS), "--device", "cpu"])
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
