"""The rank side of tests/test_torch_parallel_tp.py,
tests/test_torch_parallel_tp_generate.py, tests/test_torch_parallel_tp_serving.py
and tests/test_torch_parallel_tp_int8.py (one process of a 2-rank gloo group
on the CPU, every rank on one model axis of 2) and of
tests/test_torch_parallel_tp_train.py (4 ranks: data 2 x model 2). It
imports torch and the port only (no jax), so that a spawned rank starts in
seconds; the parent passes numpy params and inputs, and reads what each rank
saved (``rank{r}.pt``)."""

import dataclasses
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
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(len(ctx.processes))]


def _mesh(rank, init_file, data=1, model=RANKS):
    torch.set_num_threads(1)
    from eilev_tpu_torch.parallel import distributed, make_mesh

    distributed.initialize("cpu", init_method=f"file://{init_file}", world_size=data * model, rank=rank,
                           timeout=datetime.timedelta(seconds=120))
    return make_mesh(data=data, model=model, device="cpu")


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
    # contrastive search's helpers: three steps with their hidden states on
    # a fresh cache, then the candidates over it
    cache = model.init_decode_cache(enc, dec.shape[1])
    out["step_hidden"] = []
    for j in range(3):
        logits, hidden, cache = model.decode_step_hidden(dec[:, j:j + 1], None, mask, cache)
        out["step_hidden"] += [logits, hidden]
    out["candidates"] = model.candidates(_t(inp["cands"]), mask, cache)
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


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_tp_serving.py: the engine, the feature cache,
# ChatSession and serve --model_parallel
# ---------------------------------------------------------------------------


def drive(eng, requests, depth: int = 2) -> dict:
    """Keep ``depth`` requests queued while any remain (staggered submits:
    slots never all drain); {rid: tokens}."""
    done, pending, steps = {}, [dataclasses.replace(r) for r in requests], 0
    while pending or not eng.idle:
        while pending and len(eng._queue) < depth:
            eng.submit(pending.pop(0))
        done.update((c.rid, torch.from_numpy(c.tokens)) for c in eng.step())
        steps += 1
        assert steps < 300
    return done


def _engine_cases(models, cases) -> dict:
    """Each engine case ``name -> (model name, generation kwargs, engine
    kwargs, requests, feature-cache capacity or 0, generator seed or None)``
    on this rank's model: its rows, stats, and its cache's counters and key
    order."""
    from eilev_tpu_torch.generation import GenerationConfig
    from eilev_tpu_torch.serving import ContinuousBatchingEngine, VideoFeatureCache

    out = {}
    for name, (model_name, gen_kw, eng_kw, requests, capacity, seed) in cases.items():
        model = models[model_name]
        kw = dict(eng_kw)
        if capacity:
            kw["feature_cache"] = VideoFeatureCache(model, capacity=capacity, bucket=2)
        if seed is not None:
            kw["generator"] = torch.Generator().manual_seed(seed)
        eng = ContinuousBatchingEngine(model, GenerationConfig(**gen_kw), **kw)
        out[name] = {"rows": drive(eng, requests), "stats": dict(eng.stats)}
        if capacity:
            cache = kw["feature_cache"]
            out[name]["cache"] = (cache.hits, cache.misses, cache.evictions, list(cache._store))
    return out


def _chat(model, turns, gen_kw, **kw) -> list:
    """ChatSession's replies to ``turns`` ((ids, videos, vim) of the whole
    conversation so far; each reply is appended to the next turn's ids)."""
    from eilev_tpu_torch.generation import GenerationConfig
    from eilev_tpu_torch.serving import ChatSession

    sess = ChatSession(model, GenerationConfig(**gen_kw), **kw)
    replies, ids, vim = [], None, None
    for extra_ids, videos, extra_vim in turns:
        ids = extra_ids if ids is None else np.concatenate([ids, replies[-1].astype(ids.dtype), extra_ids])
        vim = extra_vim if vim is None else np.concatenate([vim, np.zeros(len(replies[-1]), vim.dtype), extra_vim])
        replies.append(sess.turn(ids, videos, vim))
        assert sess.reused_last_turn == (len(replies) > 1)
    return replies


def serving_main(rank, init_file, out_dir, models, cases, chat, serve_argv):
    """``models``: name -> (config, numpy params) of tiny VideoBLIPs;
    ``cases`` the engine cases (:func:`_engine_cases`); ``chat`` (model
    name, turns, generation kwargs, session kwargs); ``serve_argv`` the
    serve CLI's arguments, run with ``--model_parallel 2`` and, on rank 1,
    ``time.perf_counter`` running 3x slow. Saves the rows."""
    mesh = _mesh(rank, init_file)
    try:
        tp_models = {name: _videoblip(*models[name], mesh.tp) for name in models}
        out = _engine_cases(tp_models, cases)
        name, turns, gen_kw, kw = chat
        out["chat"] = _chat(tp_models[name], turns, gen_kw, **kw)
        from eilev_tpu_torch.cli import serve

        real = time.perf_counter
        if rank == 1:  # a clock 3x slow: only rank 0's may decide the arrivals
            time.perf_counter = lambda: real() / 3
        try:
            out["serve"] = serve.main(serve_argv + ["--model_parallel", str(RANKS), "--device", "cpu"])
        finally:
            time.perf_counter = real
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_tp_int8.py: the int8 weight modes under tensor parallelism
# ---------------------------------------------------------------------------

#: the row-parallel layers whose int8 leaves the int8 test reads, by tower
ROW_LAYERS = {
    "opt_out_proj": "language_model.layers.0.self_attn.out_proj",
    "opt_fc2": "language_model.layers.1.fc2",
    "vit_projection": "vision_model.vision.layers.0.self_attn.projection",
    "vit_fc2": "vision_model.vision.layers.1.mlp.fc2",
    "qformer_dense": "qformer.layers.0.crossattention.output.dense",
    "qformer_output": "qformer.layers.1.ffn_query.output",
}


def int8_main(rank, init_file, out_dir, model, inputs, dense, cli_argv):
    """``model``: (config, numpy float params) of a tiny VideoBLIP-OPT;
    ``inputs`` the generate batch; ``dense`` (weight (out, in), bias, x) of
    one row-parallel W8A8 layer; ``cli_argv`` generate_narration_texts's
    arguments, run with ``--model_parallel 2``. Quantizes this rank's model
    in every int8 mode and saves the row-parallel layers' int8 leaves, the
    greedy tokens, the layer's output and its int8 leaves."""
    import torch.nn as nn

    from eilev_tpu_torch.generation import GenerationConfig, generate
    from eilev_tpu_torch.ops.quantization import Int8W8A8Dense, quantize_model_
    from eilev_tpu_torch.parallel.tensor import RowParallelLinear

    mesh = _mesh(rank, init_file)
    try:
        tp = mesh.tp
        vb = _videoblip(*model, tp)
        quantize_model_(vb, int8_lm=True, w8a8_prefill=True, int8_vision=True, int8_qformer=True)
        mods = dict(vb.named_modules())
        out = {"layers": {k: (mods[path].w8.clone(), mods[path].scale.clone(), mods[path].tp is tp)
                          for k, path in ROW_LAYERS.items()}}
        batch = {k: _t(inputs[k]) for k in ("input_ids", "attention_mask", "pixel_values", "video_input_mask")}
        out["tokens"] = generate(vb, generation_config=GenerationConfig(max_new_tokens=5, pad_token_id=1), **batch)

        weight, bias, x = (_t(a) for a in dense)
        per, start = tp.block(weight.shape[1])
        row = RowParallelLinear(per, weight.shape[0], tp=tp)
        with torch.no_grad():
            row.weight.copy_(weight[:, start:start + per])
            row.bias.copy_(bias)
        layer = Int8W8A8Dense.from_linear(row)
        assert isinstance(row, nn.Linear) and layer.tp is tp
        with torch.no_grad():
            out["dense"] = {"y": layer(x[:, start:start + per]), "w8": layer.w8, "scale": layer.scale}

        from eilev_tpu_torch.cli import generate_narration_texts

        generate_narration_texts.main(cli_argv + ["--model_parallel", str(RANKS), "--device", "cpu"])
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_tp_train.py: tensor-parallel training, data 2 x model 2
# ---------------------------------------------------------------------------

TRAIN_DATA, TRAIN_MODEL = 2, 2


def train_spawn(out_dir, *args):
    """Start :func:`train_main` on the 2 x 2 mesh's 4 ranks (join with :func:`join`)."""
    return mp.spawn(train_main, args=(os.path.join(out_dir, "rendezvous"), out_dir, *args),
                    nprocs=TRAIN_DATA * TRAIN_MODEL, join=False)


def train_model(cfg, params, tp=None, dtype=None):
    """The port VideoBLIP of ``cfg`` on the CPU holding the numpy flax
    ``params`` (this rank's slices under ``tp``), its towers frozen, cast to
    ``dtype`` when given."""
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration, params_from_jax
    from eilev_tpu_torch.parallel.tensor import shard_state_dict
    from eilev_tpu_torch.training import freeze_towers

    model = VideoBlipForConditionalGeneration(cfg, device="cpu", tp=tp)
    model.load_state_dict(shard_state_dict(params_from_jax(params, cfg), cfg, tp), strict=True)
    freeze_towers(model)
    return model if dtype is None else model.to(dtype)


def run_steps(cfg, params, batch, ocfg, steps, *, dropout, mesh=None, zero=False, dtype=None):
    """``steps`` train steps of the port (one process, or this rank's under
    ``mesh``; the model and the batch's floats in ``dtype`` when given);
    (model, state, [metrics as floats])."""
    from eilev_tpu_torch.training import TrainState, freeze_towers, make_optimizer, make_train_step
    from eilev_tpu_torch.training.train_state import zero_sharded_opt_state

    model = train_model(cfg, params, None if mesh is None else mesh.tp, dtype)
    if dtype is not None:
        batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
    state = TrainState.create(freeze_towers(model)[0], make_optimizer(ocfg))
    if zero:
        state = dataclasses.replace(state, opt_state=zero_sharded_opt_state(state, mesh))
    step = make_train_step(model, accum_steps=batch["labels"].shape[0], dropout=dropout, mesh=mesh,
                           zero_shard_opt_state=zero)
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return model, state, metrics


def adam_rms(nu: dict, count: int, beta2: float) -> dict:
    """Adam's RMS of each element after ``count`` updates: sqrt of the
    bias-corrected second moment ``nu``."""
    return {k: (v / (1.0 - beta2**count)).sqrt() for k, v in nu.items()}


def _function_cases(tp, inp) -> dict:
    """Each collective Function's forward and input gradient, and the
    vocab-parallel loss and its gradient to the local logits, on this rank."""
    from eilev_tpu_torch.parallel.tensor import copy_to_model, local_vocab, vocab_parallel_cross_entropy

    x, w, v, c, c2 = (_t(inp[k]) for k in ("x", "w", "v", "c", "c2"))
    per, start = tp.block(w.shape[0])
    out = {}
    xc = x.clone().requires_grad_()
    y = copy_to_model(xc, tp)
    (y @ w[start:start + per].T * c[:, start:start + per]).sum().backward()  # a column block
    out["copy"] = {"y": y.detach(), "grad": xc.grad}
    per, start = tp.block(x.shape[1])
    xr = x[:, start:start + per].clone().requires_grad_()
    y = tp.all_reduce(xr @ v[:, start:start + per].T)  # a row block's partial product, summed
    (y * c2).sum().backward()
    out["reduce"] = {"y": y.detach(), "grad": xr.grad}
    vocab = inp["logits"].shape[-1]
    local = local_vocab(_t(inp["logits"]), tp, vocab).clone().requires_grad_()
    loss = vocab_parallel_cross_entropy(local, _t(inp["labels"]), tp, vocab)
    loss.backward()
    out["loss"] = {"y": loss.detach(), "grad": local.grad}
    return out


def train_main(rank, init_file, out_dir, cases, fn_inputs, ocfg, steps, cli_argv):
    """Every case of tests/test_torch_parallel_tp_train.py on this rank of the
    2 x 2 mesh. ``cases``: name -> (torch config, numpy params, the global
    numpy batch) for "opt" and "t5"; ``fn_inputs`` the Functions' inputs;
    ``cli_argv`` train_v2's arguments (its model parallel flags added here).
    Saves ``rank{rank}.pt``."""
    import torch.distributed as dist

    from eilev_tpu_torch.parallel import shard_batch
    from eilev_tpu_torch.parallel.tensor import is_model_sharded, unshard_state_dict
    from eilev_tpu_torch.training import restore_checkpoint, save_checkpoint, whole_state
    from eilev_tpu_torch.training import TrainState, freeze_towers, make_optimizer
    from eilev_tpu_torch.training.checkpoint import _to
    from eilev_tpu_torch.training.train_state import zero_sharded_opt_state

    mesh = _mesh(rank, init_file, TRAIN_DATA, TRAIN_MODEL)
    try:
        tp = mesh.tp
        out = {"coords": (mesh.data_rank, mesh.model_rank),
               "groups": (dist.get_process_group_ranks(mesh.data_group),
                          dist.get_process_group_ranks(mesh.model_group)),
               "functions": _function_cases(tp, fn_inputs)}
        for name, (cfg, params, batch) in cases.items():
            local = shard_batch({k: _t(x) for k, x in batch.items()}, mesh, axis=1)
            for dropout in (False, True):
                _, state, metrics = run_steps(cfg, params, local, ocfg, steps, dropout=dropout, mesh=mesh)
                out[f"{name}_dropout_{dropout}"] = {
                    "metrics": metrics, "trainable": unshard_state_dict(state.trainable, cfg, tp),
                    "replicated": {k: p.detach().clone() for k, p in state.trainable.items()
                                   if not is_model_sharded(k, cfg, tp)},
                    "sharded": sorted(k for k in state.trainable if is_model_sharded(k, cfg, tp))}

        # ZeRO beside TP, its checkpoint, and the restore onto this mesh
        cfg, params, batch = cases["opt"]
        local = shard_batch({k: _t(x) for k, x in batch.items()}, mesh, axis=1)
        model, state, metrics = run_steps(cfg, params, local, ocfg, steps, dropout=False, mesh=mesh, zero=True)
        whole, _ = whole_state(state, mesh, cfg)
        out["zero"] = {"metrics": metrics, "trainable": unshard_state_dict(state.trainable, cfg, tp),
                       "rows": {k: (state.opt_state["mu"][k].shape[0], p.shape[0])
                                for k, p in state.trainable.items()},
                       "whole_opt_state": _to(whole.opt_state, "cpu")}
        path = save_checkpoint(os.path.join(out_dir, "tp_ckpt"), state, mesh=mesh, config=cfg)
        dist.barrier()
        fresh = TrainState.create(freeze_towers(train_model(cfg, params, tp))[0], make_optimizer(ocfg))
        back = restore_checkpoint(path, fresh, mesh=mesh, config=cfg)
        back = dataclasses.replace(back, opt_state=zero_sharded_opt_state(back, mesh))
        out["restored_equal"] = (
            back.step == state.step
            and all(torch.equal(back.trainable[k], p) for k, p in state.trainable.items())
            and all(torch.equal(back.opt_state[m][k], t) for m in ("mu", "nu")
                    for k, t in state.opt_state[m].items()))

        from eilev_tpu_torch.cli import train_v2

        train_v2.main(cli_argv + ["--model_parallel", str(TRAIN_MODEL), "--data_parallel", str(TRAIN_DATA),
                                  "--device", "cpu"])
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
