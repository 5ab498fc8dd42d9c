"""Tensor parallelism (eilev_tpu_torch/parallel/tensor.py, parallel/mesh.py
and the local-head models) held against the JAX package on the CPU.

In this process: the layout rule gives every 2-D projection of OPT, LLaMA,
T5, the ViT and the Q-Former a sharded layout, and the towers built with
local heads hold 1/tp of each such weight (the counterpart of JAX's
``test_llama_tp_specs_shard_every_projection``); the rank -> (data, model)
arithmetic of 1x2, 2x1 and 2x2 meshes; ``shard_state_dict``'s shards put
back together give the full state dict.

One ``torch.multiprocessing.spawn`` of 2 gloo ranks (tests/_torch_tp_worker.py)
runs the tiny LLaMA (4 heads over 2 kv heads, one kv head a rank), OPT and
T5 at tp 2 with odd vocabularies (uneven vocab blocks, the tail masked):
the embeddings, the no-cache forward, a prefill and decode steps on the
local-head cache, and for T5 the encoder, cached decode steps, class
scores, and contrastive search's helpers (three decode_step_hidden steps'
logits and hidden states, then candidates over that cache) equal the JAX
modules' within fp32 1e-5, on both ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu import configs as jconfigs
from eilev_tpu.models import llama as jl
from eilev_tpu.models import opt as jopt
from eilev_tpu.models import t5 as jt5
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.models import VideoBlipForConditionalGeneration
from eilev_tpu_torch.models.llama import LlamaForCausalLM
from eilev_tpu_torch.models.opt import OPTForCausalLM
from eilev_tpu_torch.models.t5 import T5ForConditionalGeneration
from eilev_tpu_torch.parallel import mesh as tmesh
from eilev_tpu_torch.parallel import tensor as ttensor

from . import _torch_tp_worker as worker
from ._torch_port import random_params, to_np

TOL = 1e-5
B, S, VOCAB = 2, 9, 61


def _llama_cfg(mod):
    return mod.LlamaConfig(vocab_size=97, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=2, intermediate_size=64, max_position_embeddings=128)


def _opt_cfg(mod):
    return mod.tiny_config(hidden=32, heads=4, vocab_size=VOCAB).text_config


def _t5_cfg(mod):
    return mod.tiny_config(text_model="t5", hidden=32, heads=4, vocab_size=VOCAB).text_config


def _decoder_inputs(d, vocab, seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, S), np.int32)
    mask[1, :3] = 0  # left padding
    steps = [(rng.normal(size=(B, 1, d)).astype(np.float32), np.ones((B, 1), np.int32)) for _ in range(3)]
    return {"ids": rng.integers(0, vocab, size=(B, S)).astype(np.int32),
            "embeds": rng.normal(size=(B, S, d)).astype(np.float32), "mask": mask, "steps": steps}


def _decoder_refs(jmodel, params, jcfg, inp):
    v = {"params": params}
    step = jax.jit(lambda x, m, cache: jmodel.apply(v, x, attention_mask=m, cache=cache))
    ref = {"embed": jmodel.apply(v, jnp.asarray(inp["ids"]), method=type(jmodel).embed),
           "logits": step(jnp.asarray(inp["embeds"]), jnp.asarray(inp["mask"]), None)[0]}
    cache = jopt.init_cache(jcfg, B, S + len(inp["steps"]))
    ref["cached"] = []
    for x, m in [(inp["embeds"], inp["mask"])] + inp["steps"]:
        logits, cache = step(jnp.asarray(x), jnp.asarray(m), cache)
        ref["cached"].append(logits)
    return ref


def _t5_inputs(seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, S), np.int32)
    mask[1, -3:] = 0
    class_mask = np.ones((3, 4), np.int32)
    class_mask[1, 2:] = 0
    return {"emb": rng.normal(size=(B, S, 32)).astype(np.float32), "mask": mask,
            "dec": rng.integers(0, VOCAB, size=(B, 5)).astype(np.int32),
            "dec_mask": np.ones((B, 5), np.int32),
            "classes": rng.integers(0, VOCAB, size=(3, 4)).astype(np.int32), "class_mask": class_mask,
            "cands": rng.integers(0, VOCAB, size=(B, 4)).astype(np.int32)}


def _t5_refs(jmodel, params, inp):
    v = {"params": params}
    emb, mask, dec = jnp.asarray(inp["emb"]), jnp.asarray(inp["mask"]), jnp.asarray(inp["dec"])
    enc = jax.jit(lambda e, m: jmodel.apply(v, e, m, method=jmodel.encode))(emb, mask)
    ref = {"encoder": enc,
           "logits": jax.jit(lambda *a: jmodel.apply(v, *a))(emb, mask, dec, jnp.asarray(inp["dec_mask"])),
           "classes": jax.jit(lambda *a: jmodel.apply(v, *a, method=jmodel.score_classes))(
               jnp.asarray(inp["classes"]), jnp.asarray(inp["class_mask"]), enc, mask)}
    cache = jmodel.apply(v, enc, dec.shape[1], method=jmodel.init_decode_cache)
    step = jax.jit(lambda tok, cache: jmodel.apply(v, tok, enc, mask, cache, method=jmodel.decode_step))
    ref["cached"] = []
    for j in range(dec.shape[1]):
        logits, cache = step(dec[:, j:j + 1], cache)
        ref["cached"].append(logits)
    cache = jmodel.apply(v, enc, dec.shape[1], method=jmodel.init_decode_cache)
    step_hidden = jax.jit(lambda tok, cache: jmodel.apply(v, tok, enc, mask, cache, method=jmodel.decode_step_hidden))
    ref["step_hidden"] = []
    for j in range(3):
        logits, hidden, cache = step_hidden(dec[:, j:j + 1], cache)
        ref["step_hidden"] += [logits, hidden]
    ref["candidates"] = jmodel.apply(v, jnp.asarray(inp["cands"]), mask, cache, method=jmodel.candidates)
    return ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the ranks on the three LMs, compute JAX's outputs meanwhile;
    (rank results, references, the LMs' configs)."""
    cases, refs, cfgs = {}, {}, {}
    jcfg = _llama_cfg(jconfigs)
    jmodel = jl.LlamaForCausalLM(jcfg)
    params = random_params(jmodel, 5, jnp.zeros((B, S), jnp.int32), method=lambda m, i: (m.embed(i), m(m.embed(i))))
    cases["llama"] = (_llama_cfg(tconfigs), jax.tree.map(np.asarray, params), _decoder_inputs(32, 97, 6))
    jopt_cfg = _opt_cfg(jconfigs)
    jopt_model = jopt.OPTForCausalLM(jopt_cfg)
    opt_params = random_params(jopt_model, 4, jnp.zeros((B, S, 32)))
    cases["opt"] = (_opt_cfg(tconfigs), jax.tree.map(np.asarray, opt_params), _decoder_inputs(32, VOCAB, 7))
    jt5_cfg = _t5_cfg(jconfigs)
    jt5_model = jt5.T5ForConditionalGeneration(jt5_cfg)
    t5_inp = _t5_inputs(8)
    t5_params = random_params(jt5_model, 1, t5_inp["emb"], t5_inp["mask"], t5_inp["dec"])
    cases["t5"] = (_t5_cfg(tconfigs), jax.tree.map(np.asarray, t5_params), t5_inp)

    out_dir = str(tmp_path_factory.mktemp("tp"))
    ctx = worker.spawn(worker.forwards_main, out_dir, cases)
    refs["llama"] = _decoder_refs(jmodel, params, jcfg, cases["llama"][2])
    refs["opt"] = _decoder_refs(jopt_model, opt_params, jopt_cfg, cases["opt"][2])
    refs["t5"] = _t5_refs(jt5_model, t5_params, t5_inp)
    cfgs = {name: case[0] for name, case in cases.items()}
    return worker.join(ctx, out_dir), refs, cfgs


def _close(ours, ref):
    np.testing.assert_allclose(to_np(ours), np.asarray(ref, np.float32), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["llama", "opt", "t5"])
def test_tp_forward_matches_jax(ranks, name):
    results, refs, cfgs = ranks
    heads = cfgs[name].num_key_value_heads if name == "llama" else 4
    keys = ("encoder", "logits", "classes", "candidates") if name == "t5" else ("embed", "logits")
    lists = ("cached", "step_hidden") if name == "t5" else ("cached",)
    for out in results:  # every rank holds the full outputs
        assert out[name]["heads"] == heads // worker.RANKS  # the cache holds the local heads
        for key in keys:
            _close(out[name][key], refs[name][key])
        for key in lists:
            assert len(out[name][key]) == len(refs[name][key])
            for ours, ref in zip(out[name][key], refs[name][key]):
                _close(ours, ref)


# ---------------------------------------------------------------------------
# in this process: the layout rule, the mesh arithmetic, the shards
# ---------------------------------------------------------------------------

# 2-D parameters that stay whole on every rank, as in JAX
WHOLE_2D = ("embed_positions", "patch_kernel", "position_embedding", "relative_attention_bias",
            "language_projection", "query_tokens")


def _towers():
    """(name, config, module class) of every tower the layout covers."""
    vb = tconfigs.tiny_config(hidden=32, heads=4)
    return [
        ("opt", _opt_cfg(tconfigs), OPTForCausalLM),
        ("llama", _llama_cfg(tconfigs), LlamaForCausalLM),
        ("t5", _t5_cfg(tconfigs), T5ForConditionalGeneration),
        ("videoblip", vb, VideoBlipForConditionalGeneration),
    ]


def _full_and_local(config, cls):
    full = cls(config, device="meta").state_dict()
    local = [cls(config, device="meta", tp=ttensor.TensorParallel(2, r)).state_dict() for r in range(2)]
    return full, local


@pytest.mark.parametrize("name,config,cls", _towers(), ids=[t[0] for t in _towers()])
def test_layout_rule_shards_every_projection(name, config, cls):
    """Every 2-D weight but the whole ones has a sharded layout, and the
    local-head tower's copy holds 1/tp of it (a vocab table ceil(V/tp)
    rows); what stays whole has the full shape."""
    full, local = _full_and_local(config, cls)
    sharded = 0
    for key, tensor in full.items():
        kind = ttensor.param_layout(key)
        whole = any(part in key for part in WHOLE_2D)
        if tensor.ndim == 2 and not whole:
            assert kind != ttensor.REPLICATED, key
        for rank_sd in local:
            shape = rank_sd[key].shape
            if kind == ttensor.REPLICATED:
                assert shape == tensor.shape, key
            elif kind == ttensor.VOCAB:
                assert shape == (-(-tensor.shape[0] // 2), tensor.shape[1]), key
            else:
                assert shape.numel() * 2 == tensor.numel(), key
                sharded += 1
    assert sharded > 0
    if name == "videoblip":  # one tower each: every family of projections is sharded
        kinds = {ttensor.param_layout(k) for k in full if k.startswith(("vision_model", "qformer"))}
        assert {ttensor.PACKED, ttensor.COLUMN, ttensor.ROW} <= kinds


def test_tower_whole_when_the_axis_does_not_divide_it():
    """The Q-Former's 12 heads at tp 8 stay whole; LLaMA's kv heads must divide."""
    tp8 = ttensor.TensorParallel(8, 3)
    assert ttensor.tower_tp(tp8, tconfigs.QFormerConfig()) is None
    assert ttensor.tower_tp(tp8, tconfigs.VisionConfig()) is tp8
    assert ttensor.tower_tp(ttensor.TensorParallel(1, 0), tconfigs.VisionConfig()) is None
    with pytest.raises(ValueError, match="kv heads"):
        ttensor.tower_tp(ttensor.TensorParallel(4, 0), _llama_cfg(tconfigs))


@pytest.mark.parametrize("data,model", [(1, 2), (2, 1), (2, 2)])
def test_mesh_coords(data, model):
    """rank = d * model + m, as JAX's reshape(data, model); each model group
    is a run of consecutive ranks."""
    coords = [tmesh.mesh_coords(r, data, model) for r in range(data * model)]
    assert coords == [(d, m) for d in range(data) for m in range(model)]
    groups = [tmesh.model_group_ranks(d, model) for d in range(data)]
    assert sorted(r for g in groups for r in g) == list(range(data * model))
    for r, (d, m) in enumerate(coords):
        assert groups[d][m] == r
    with pytest.raises(ValueError, match="not on"):
        tmesh.mesh_coords(data * model, data, model)


def test_make_mesh_one_process():
    """One process: model=1 is the data mesh as before; model=2 asks for a
    second process."""
    mesh = tmesh.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.tp is None
    with pytest.raises(ValueError, match="torchrun"):
        tmesh.make_mesh(model=2, device="cpu")


def _merge(shards, key, config):
    """The full tensor ``key`` from its per-rank shards (the test's own inverse)."""
    kind = ttensor.param_layout(key)
    if kind == ttensor.REPLICATED:
        assert all(torch.equal(s, shards[0]) for s in shards)
        return shards[0]
    if kind == ttensor.ROW:
        return torch.cat(shards, dim=1)
    if kind == ttensor.PACKED:
        _, widths = ttensor._split_dims(config)
        thirds = [s.split([w // len(shards) for w in widths]) for s in shards]
        return torch.cat([torch.cat([t[i] for t in thirds]) for i in range(3)])
    return torch.cat(shards)


@pytest.mark.parametrize("name,config,cls", _towers(), ids=[t[0] for t in _towers()])
def test_shard_state_dict_round_trips(name, config, cls):
    """The shards, put back together (row: columns; packed: each of q, k and
    v by heads; vocab: rows, the zero tail cut), are the full state dict;
    each shard has the local-head module's shapes."""
    torch.manual_seed(0)
    full = {k: torch.randn(v.shape) for k, v in cls(config, device="meta").state_dict().items()}
    _, local_shapes = _full_and_local(config, cls)
    shards = [ttensor.shard_state_dict(full, config, ttensor.TensorParallel(2, r)) for r in range(2)]
    for rank, shard in enumerate(shards):
        assert {k: v.shape for k, v in shard.items()} == {k: v.shape for k, v in local_shapes[rank].items()}
    for key, tensor in full.items():
        merged = _merge([s[key] for s in shards], key, ttensor._tower_config(key, config))
        if ttensor.param_layout(key) == ttensor.VOCAB:
            assert (merged[tensor.shape[0]:] == 0).all(), key
            merged = merged[:tensor.shape[0]]
        assert torch.equal(merged, tensor), key
    assert ttensor.shard_state_dict(full, config, None) == full


def test_vocab_blocks_are_uneven_here():
    """The forwards above run vocab blocks with a zero tail (61 = 31 + 30 + 1 pad)."""
    tp = ttensor.TensorParallel(2, 1)
    assert ttensor.vocab_block(VOCAB, tp) == 31 and ttensor.vocab_block(97, tp) == 49
