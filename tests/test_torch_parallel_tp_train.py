"""Tensor-parallel training (``parallel/tensor.py``'s collectives with their
gradients and vocab-parallel loss, the data groups of ``parallel/mesh.py``,
``training/train_state.py``'s step and clip under a model axis, the TP
checkpoints and ``train_v2 --model_parallel``) held against one process and
against the JAX package on the CPU.

One ``torch.multiprocessing.spawn`` of 4 gloo ranks, data 2 x model 2
(tests/_torch_tp_worker.py), at ``tiny_config(hidden=32, heads=4)`` in fp32
with an odd vocabulary of 61 (uneven vocab blocks, the tail masked). The
global batch: 2 micro-batches of 4 rows, each data replica holding 2 rows of
each, with unequal valid-label counts. Two steps (lr 1e-3, Adam eps 1e-6,
the recipe's clip at 1.0, which the gradients here exceed):

- each Function's forward and input gradient, and the vocab-parallel loss
  and its gradient to the local logits, within 1e-6 of one process;
- OPT and T5, dropout off and on: loss, grad_norm and every gathered
  trainable leaf within 1e-5 of the port's one-process step over the global
  batch (the same masks), evaluated in fp64: the TP step and the fp32
  one-process step, two fp32 evaluations in different orders, part by up to
  2e-5 after two steps here (Adam turns the rounding of a near-zero
  gradient, as the attention key biases' exact zero, into a step of up to
  lr), so neither is the other's yardstick; OPT with dropout off within
  1e-5 of JAX's
  ``make_train_step`` (run unsharded: tests/training/test_trainer_parallel.py
  shows TP = DP there);
- ZeRO beside TP bit-identical to TP alone, each rank holding half the rows
  of its local moments; the replicated leaves bit-identical across the
  model ranks; the TP x ZeRO checkpoint restored onto one process
  bit-identical and back onto the 2 x 2 mesh equal to the saved shards;
- ``train_v2 --model_parallel 2 --data_parallel 2`` on
  tests/test_torch_cli.py's world exports, within 1e-5, what the
  one-process CLI exports over the same global batches (each data replica's
  stride of its own copy of the dataset, concatenated), but for the
  elements whose gradient is rounding noise to Adam at the CLI's eps 1e-8
  (tests/test_torch_train_step.py's rule: an Adam RMS below NOISE_EPS x eps,
  read off the run's checkpoint; each such element within the sum of the
  steps' lrs, and fewer than 2% of them).

In this process: the dropout masks do not depend on the model axis, the
data groups are {0, 2} and {1, 3}, and a model axis with a model built
without its ``tp`` raises.
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu import configs as jconfigs
from eilev_tpu.models import VideoBlipForConditionalGeneration as JVB
from eilev_tpu.training import OptimizerConfig as JOptimizerConfig
from eilev_tpu.training import TrainState as JTrainState
from eilev_tpu.training import make_optimizer as jmake_optimizer
from eilev_tpu.training import make_train_step as jmake_train_step
from eilev_tpu.training.train_state import partition_params as jpartition
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.cli import train_v2
from eilev_tpu_torch.models import auto
from eilev_tpu_torch.models.convert import flax_to_state_dict
from eilev_tpu_torch.models.video_blip import masked_cross_entropy
from eilev_tpu_torch.ops.dropout import DropoutRng, dropout
from eilev_tpu_torch.parallel import Mesh, TensorParallel, data_group_ranks
from eilev_tpu_torch.parallel.mesh import mesh_coords, model_group_ranks
from eilev_tpu_torch.training import (OptimizerConfig, TrainState, freeze_towers, make_optimizer,
                                      make_train_step, partition_params, restore_checkpoint)
from eilev_tpu_torch.training.checkpoint import CHECKPOINT_FILE, latest_checkpoint
from eilev_tpu_torch.training.train_state import make_schedule

from . import _torch_tp_worker as worker
from ._torch_port import random_params
from ._torch_train import tiny_batch
from .test_torch_cli import world  # noqa: F401  (the module-scoped world fixture)

TOL = 1e-5
FN_TOL = 1e-6
NOISE_EPS = 10  # tests/test_torch_train_step.py's
STEPS = 2
VOCAB = 61
OCFG = OptimizerConfig(learning_rate=1e-3, eps=1e-6, warmup_steps=0, total_steps=5)
CLI_ARGS = ["--num_subsample_frames", "2", "--max_length", "64", "--num_train_steps", "2",
            "--gradient_accumulation_steps", "2", "--learning_rate", "1e-3", "--warmup_steps", "0",
            "--eval_steps", "2", "--save_steps", "2", "--logging_steps", "1", "--export_hf", "--dtype", "fp32",
            "--train_num_in_context_examples_per_sample", "1", "--val_num_in_context_examples_per_sample", "1"]


def _cfg(mod, text_model):
    return mod.tiny_config(text_model=text_model, hidden=32, heads=4, vocab_size=VOCAB)


def _opt_batch(cfg):
    batch = tiny_batch(cfg, 2, 4, seed=7, padded=False)
    batch["labels"][:, 0, 7:] = -100  # data replica 0's rows hold fewer valid labels
    batch["labels"][:, 1, 11:] = -100
    return batch


def _t5_batch(cfg, accum=2, micro=4, seq=12, n_labels=5, seed=9):
    """A seq2seq batch (accum, micro, ...): one video a row at positions
    1..1+Q, row 3 right-padded by 2; labels apart, replica 0's cut short."""
    rng = np.random.default_rng(seed)
    b, img, q = accum * micro, cfg.vision_config.image_size, cfg.num_query_tokens
    vim = np.zeros((b, seq), np.int64)
    vim[:, 1:1 + q] = 1
    mask = np.ones((b, seq), np.int64)
    mask[3::micro, -2:] = 0
    labels = rng.integers(2, VOCAB, size=(b, n_labels))
    labels[0::micro, 2:] = -100
    labels[1::micro, 4:] = -100
    batch = {"input_ids": rng.integers(2, VOCAB, size=(b, seq)), "attention_mask": mask, "labels": labels,
             "video_input_mask": vim, "pixel_values": rng.normal(size=(b, 3, 2, img, img)).astype(np.float32)}
    return {k: v.reshape(accum, micro, *v.shape[1:]) for k, v in batch.items()}


def _params(cfg, batch, seed):
    micro = {k: jnp.asarray(v[0]) for k, v in batch.items() if k in ("input_ids", "pixel_values",
                                                                     "video_input_mask")}
    if not cfg.use_decoder_only_language_model:
        micro["decoder_input_ids"] = jnp.zeros((batch["labels"].shape[1], 1), jnp.int32)
    return jax.tree.map(np.asarray, random_params(JVB(cfg), seed, **micro))


def _fn_inputs():
    rng = np.random.default_rng(5)
    labels = rng.integers(0, VOCAB, size=(6,))
    labels[[1, 4]] = -100
    labels[2] = VOCAB - 1  # a target in the last block's last row
    return {"x": rng.normal(size=(3, 8)).astype(np.float32), "w": rng.normal(size=(6, 8)).astype(np.float32),
            "v": rng.normal(size=(5, 8)).astype(np.float32), "c": rng.normal(size=(3, 6)).astype(np.float32),
            "c2": rng.normal(size=(3, 5)).astype(np.float32),
            "logits": (3 * rng.normal(size=(6, VOCAB))).astype(np.float32), "labels": labels}


def _fn_refs(inp) -> dict:
    """The Functions' cases in one process: (forward, gradient) of the full
    computation, the gradient as each rank's block sees it."""
    x, w, v, c, c2, logits = (torch.from_numpy(inp[k]) for k in ("x", "w", "v", "c", "c2", "logits"))
    xc = x.clone().requires_grad_()
    (xc @ w.T * c).sum().backward()
    xr = x.clone().requires_grad_()
    y = xr @ v.T
    (y * c2).sum().backward()
    lg = logits.clone().requires_grad_()
    loss = masked_cross_entropy(lg, torch.from_numpy(inp["labels"]))
    loss.backward()
    return {"copy": (x, xc.grad), "reduce": (y.detach(), xr.grad), "loss": (loss.detach(), lg.grad)}


def _cli_argv(world, out, per_device):  # noqa: F811
    return ["--model_name_or_path", str(world / "checkpoint"), "--train_frames_dir", str(world / "train_frames"),
            "--val_frames_dir", str(world / "train_frames"), "--output_dir", out,
            "--per_device_train_batch_size", str(per_device), *CLI_ARGS]


def _one_process_cli(world, out):  # noqa: F811
    """train_v2 in this process over the global batches the 2 data replicas
    load: each replica's stride (process_index r of 2) from its own fresh
    copy of the dataset, the two micro-batches' rows concatenated."""
    from eilev_tpu_torch.training import data_module

    inner = data_module.train_batch_iterator

    def strided(dataset, tokenizer, *, micro_batch_size, augment=True, process_index=0, process_count=1, **kw):
        assert (process_index, process_count) == (0, 1)
        if not augment:  # the eval batches: whole on every process
            yield from inner(dataset, tokenizer, micro_batch_size=micro_batch_size, augment=augment, **kw)
            return
        shards = [inner(copy.deepcopy(dataset), tokenizer, micro_batch_size=micro_batch_size // 2, augment=True,
                        process_index=r, process_count=2, **kw) for r in range(2)]
        for parts in zip(*shards):
            yield {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(data_module, "train_batch_iterator", strided)
        train_v2.main(_cli_argv(world, out, 2) + ["--device", "cpu"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, world):  # noqa: F811
    """Spawn the 4 ranks, compute the one-process and JAX references
    meanwhile; returns (cases, references, rank results, out_dir)."""
    out_dir = tmp_path_factory.mktemp("tp_train")
    jcfgs = {name: _cfg(jconfigs, name) for name in ("opt", "t5")}
    batches = {"opt": _opt_batch(jcfgs["opt"]), "t5": _t5_batch(jcfgs["t5"])}
    params = {name: _params(jcfgs[name], batches[name], seed) for name, seed in (("opt", 13), ("t5", 14))}
    cases = {name: (_cfg(tconfigs, name), params[name], batches[name]) for name in ("opt", "t5")}
    fn_inputs = _fn_inputs()
    ctx = worker.train_spawn(str(out_dir), cases, fn_inputs, OCFG, STEPS,
                             _cli_argv(world, str(out_dir / "cli_tp"), 1))
    refs = {"functions": _fn_refs(fn_inputs)}
    for name, (cfg, p, batch) in cases.items():
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        for drop in (False, True):
            _, state, metrics = worker.run_steps(cfg, p, tb, OCFG, STEPS, dropout=drop, dtype=torch.float64)
            refs[f"{name}_dropout_{drop}"] = (state.trainable, metrics)
    trainable, frozen = jpartition(params["opt"])
    jstate = JTrainState.create(jax.tree.map(jnp.asarray, trainable),
                                jmake_optimizer(JOptimizerConfig(**dataclasses.asdict(OCFG))))
    jstep = jax.jit(jmake_train_step(JVB(jcfgs["opt"]), accum_steps=2, dropout=False))
    jmetrics = []
    for _ in range(STEPS):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, frozen), jax.tree.map(jnp.asarray, batches["opt"]))
        jmetrics.append({k: float(v) for k, v in jm.items()})
    refs["jax"] = (flax_to_state_dict(jax.tree.map(np.asarray, jstate.trainable)), jmetrics)
    _one_process_cli(world, str(out_dir / "cli_one"))
    results = worker.join(ctx, str(out_dir))
    return cases, refs, results, out_dir


def _close_metrics(ours, ref):
    for a, b in zip(ours, ref, strict=True):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], rtol=TOL, err_msg=key)


def _close_leaves(ours: dict, ref: dict, rms=None, eps=None, lr_sum=0.0):
    """Every leaf within TOL; with ``rms`` (the reference's Adam RMS per
    element) an element below NOISE_EPS x ``eps`` within ``lr_sum``, the
    most Adam moves a weight by, and fewer than 2% of the elements so."""
    assert ours.keys() == ref.keys()
    n_noise = 0
    for k, v in ref.items():
        atol = torch.full(v.shape, TOL, dtype=torch.float64)
        if rms is not None:
            noise = rms[k] < NOISE_EPS * eps
            atol = torch.where(noise, lr_sum, atol)
            n_noise += int(noise.sum())
        diff = (ours[k].detach().double() - v.detach().double()).abs()
        assert bool((diff <= atol).all()), (k, float(diff.max()), int((diff > atol).sum()))
    assert n_noise < 0.02 * sum(v.numel() for v in ref.values()), n_noise


@pytest.mark.parametrize("case", ["copy", "reduce", "loss"])
def test_functions_match_one_process(ranks, case):
    _, refs, results, _ = ranks
    y_ref, g_ref = refs["functions"][case]
    for r in results:
        got = r["functions"][case]
        _, m = r["coords"]
        per = g_ref.shape[-1] // 2
        grad_ref = g_ref
        if case == "reduce":  # the gradient of this rank's input block
            grad_ref = g_ref[:, m * per:(m + 1) * per]
        if case == "loss":  # this rank's vocab block, the tail past the vocabulary zero
            block = -(-VOCAB // 2)
            grad_ref = torch.nn.functional.pad(g_ref, (0, 2 * block - VOCAB))[:, m * block:(m + 1) * block]
        torch.testing.assert_close(got["y"], y_ref, atol=FN_TOL, rtol=0)
        torch.testing.assert_close(got["grad"], grad_ref, atol=FN_TOL, rtol=0)


@pytest.mark.parametrize("name", ["opt", "t5"])
@pytest.mark.parametrize("drop", [False, True], ids=["dropout_off", "dropout_on"])
def test_tp_step_matches_one_process(ranks, name, drop):
    _, refs, results, _ = ranks
    trainable, metrics = refs[f"{name}_dropout_{drop}"]
    for r in results:  # every rank ends with the whole one-process step
        got = r[f"{name}_dropout_{drop}"]
        assert got["sharded"], "the Q-Former is not sharded at tp 2"
        assert got["metrics"][0]["grad_norm"] > OCFG.max_grad_norm  # the clip was active
        _close_metrics(got["metrics"], metrics)
        _close_leaves(got["trainable"], trainable)


def test_tp_step_matches_jax_train_step(ranks):
    _, refs, results, _ = ranks
    jtrainable, jmetrics = refs["jax"]
    got = results[0]["opt_dropout_False"]
    _close_metrics(got["metrics"], jmetrics)
    _close_leaves(got["trainable"], jtrainable)


def test_zero_beside_tp_bitwise(ranks):
    _, _, results, _ = ranks
    for r in results:
        plain, zero = r["opt_dropout_False"], r["zero"]
        assert zero["metrics"] == plain["metrics"]
        assert all(torch.equal(zero["trainable"][k], p) for k, p in plain["trainable"].items())
        # every local moment here has an even first dimension: each rank holds half its rows
        assert all(mine * 2 == whole for mine, whole in zero["rows"].values()), zero["rows"]


def test_replicated_leaves_identical_across_model_ranks(ranks):
    _, _, results, _ = ranks
    by_coords = {r["coords"]: r for r in results}
    for d in range(2):
        a, b = by_coords[(d, 0)], by_coords[(d, 1)]
        for key in ("opt_dropout_False", "opt_dropout_True", "t5_dropout_False", "t5_dropout_True"):
            rep_a, rep_b = a[key]["replicated"], b[key]["replicated"]
            assert rep_a.keys() == rep_b.keys() and "language_projection.weight" in rep_a
            assert all(torch.equal(t, rep_b[k]) for k, t in rep_a.items()), key


@pytest.mark.parametrize("onto", ["one_process", "mesh_2x2"])
def test_tp_checkpoint_reshards(ranks, onto):
    cases, _, results, out_dir = ranks
    if onto == "mesh_2x2":
        assert all(r["restored_equal"] for r in results)
        return
    cfg, params, _ = cases["opt"]
    fresh = TrainState.create(freeze_towers(worker.train_model(cfg, params))[0], make_optimizer(OCFG))
    state = restore_checkpoint(latest_checkpoint(str(out_dir / "tp_ckpt")), fresh)
    run = results[0]["zero"]
    assert state.step == STEPS
    assert all(torch.equal(state.trainable[k], p) for k, p in run["trainable"].items())
    for moment in ("mu", "nu"):
        for k, whole in run["whole_opt_state"][moment].items():
            assert whole.shape == state.trainable[k].shape
            assert torch.equal(state.opt_state[moment][k], whole), (moment, k)


def test_train_v2_model_parallel_cli_matches_one_process(ranks, world):  # noqa: F811
    _, _, _, out_dir = ranks
    ours, _ = auto.load_model(str(out_dir / "cli_tp" / "hf"), device="cpu")
    ref, _ = auto.load_model(str(out_dir / "cli_one" / "hf"), device="cpu")
    source, _ = auto.load_model(str(world / "checkpoint"), device="cpu")
    trained, frozen = partition_params(source.state_dict())
    ours, ref = ours.state_dict(), ref.state_dict()
    assert all(torch.equal(ours[k], v) for k, v in frozen.items())
    assert not all(torch.equal(ours[k], v) for k, v in trained.items())
    # the CLI's optimizer: eps 1e-8, lr 1e-3 decaying to 0 over its 2 steps;
    # the noise elements read off the one-process run's moments after step 2
    ocfg = OptimizerConfig(learning_rate=1e-3, warmup_steps=0, total_steps=2)
    saved = torch.load(os.path.join(latest_checkpoint(str(out_dir / "cli_one")), CHECKPOINT_FILE), weights_only=True)
    rms = worker.adam_rms(saved["opt_state"]["nu"], saved["opt_state"]["count"], ocfg.beta2)
    lr_sum = sum(float(make_schedule(ocfg)(c)) for c in range(2))
    _close_leaves({k: ours[k] for k in trained}, {k: ref[k] for k in trained}, rms, ocfg.eps, lr_sum)


def test_dropout_masks_do_not_depend_on_the_model_axis_and_data_groups():
    # data groups of a 2 x 2 mesh: the ranks of one model rank
    assert [data_group_ranks(m, 2, 2) for m in range(2)] == [[0, 2], [1, 3]]
    assert [model_group_ranks(d, 2) for d in range(2)] == [[0, 1], [2, 3]]
    assert [mesh_coords(r, 2, 2) for r in range(4)] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    x = torch.ones(3, 4, 6, 8)

    def masks(shard_axis, tp):
        """A model-sharded site, then a replicated one, from one seeded source."""
        rng = DropoutRng.seeded(3, "cpu")
        local = x if tp is None else x.narrow(shard_axis, tp.rank * x.shape[shard_axis] // 2,
                                              x.shape[shard_axis] // 2)
        return (dropout(local, 0.5, rng, None if tp is None else (shard_axis, tp)) != 0,
                dropout(x, 0.5, rng) != 0)

    for axis in (2, -1):  # the Q-Former's heads, T5's d_ff
        full, rep = masks(axis, None)
        parts = [masks(axis, TensorParallel(2, r)) for r in range(2)]
        assert torch.equal(torch.cat([p[0] for p in parts], dim=axis), full)
        assert all(torch.equal(p[1], rep) for p in parts)


def test_model_axis_with_an_unsharded_model_raises():
    cfg = _cfg(tconfigs, "opt")
    model = worker.train_model(cfg, _params(_cfg(jconfigs, "opt"), _opt_batch(_cfg(jconfigs, "opt")), 13))
    mesh = Mesh(1, 0, (torch.device("cpu"),), model_size=2, model_rank=0)
    with pytest.raises(ValueError, match="model axis of 2"):
        make_train_step(model, mesh=mesh)
