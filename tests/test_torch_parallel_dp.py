"""Data parallelism and ZeRO-2 on torch.distributed (eilev_tpu_torch/parallel/,
training/train_state.py): one ``torch.multiprocessing.spawn`` of 2 gloo ranks
on the CPU (tests/_torch_dp_worker.py), held against one process.

The global batch: 2 micro-batches (accumulation) of 4 rows, rank r holding
rows 2r and 2r + 1 of each, with UNEQUAL valid-label counts (rank 0's rows
are cut short by -100), so a mean of the ranks' means would differ from the
global masked mean. Two steps each (lr 1e-3, Adam eps 1e-6, clipping on):

- DP, dropout off and on, against the port's one-device step over the
  whole batch (the masks drawn as the global rows): loss, grad_norm and
  every trainable leaf within 1e-5;
- DP, dropout off, against JAX's ``make_train_step`` on the global batch,
  within 1e-5;
- ZeRO against replicated DP: the trainable leaves and the gathered
  optimizer state bit-identical; each rank held half of every moment's rows;
- the ZeRO checkpoint (written whole by rank 0) restored onto one device:
  the optimizer state and trainable leaves bit-identical to the run's;
- the DP eval loss is the global masked mean; ``gather_to_host`` stacks the
  ranks' rows; a micro-batch that does not divide the data size raises.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from eilev_tpu.training import OptimizerConfig as JOptimizerConfig
from eilev_tpu.training import TrainState as JTrainState
from eilev_tpu.training import make_optimizer as jmake_optimizer
from eilev_tpu.training import make_train_step as jmake_train_step
from eilev_tpu.training.train_state import partition_params as jpartition
from eilev_tpu_torch.models.convert import flax_to_state_dict
from eilev_tpu_torch.parallel import Mesh, shard_batch
from eilev_tpu_torch.training import OptimizerConfig, TrainState, eval_step, freeze_towers, make_optimizer
from eilev_tpu_torch.training.checkpoint import latest_checkpoint, restore_checkpoint

from . import _torch_dp_worker as worker
from ._torch_train import jax_setup, tiny_batch

TOL = 1e-5
STEPS = 2
OCFG = OptimizerConfig(learning_rate=1e-3, eps=1e-6, warmup_steps=0, total_steps=5)
DEADLINE_S = 240


def _global_batch(cfg):
    batch = tiny_batch(cfg, 2, 4, seed=7, padded=False)
    batch["labels"][:, 0, 7:] = -100  # rank 0's rows hold fewer valid labels
    batch["labels"][:, 1, 11:] = -100
    return batch


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the two ranks, compute the one-process references meanwhile,
    and return (setup, batch, rank results, references, out_dir)."""
    cfg, jmodel, params = jax_setup(seed=13)
    batch = _global_batch(cfg)
    out_dir = tmp_path_factory.mktemp("dp")
    ctx = mp.spawn(worker.rank_main, args=(str(out_dir / "rendezvous"), str(out_dir), params, batch, OCFG, STEPS),
                   nprocs=2, join=False)
    refs = {}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for dropout in (False, True):
        model, state, metrics = worker.run_steps(params, tb, OCFG, STEPS, dropout=dropout)
        refs[dropout] = (state, metrics)
        if not dropout:  # the weights the ranks evaluate with: the (ZeRO) run's, dropout off
            refs["eval"] = float(eval_step(model, {k: v[0] for k, v in tb.items()}))
    trainable, frozen = jpartition(params)
    jstate = JTrainState.create(jax.tree.map(jnp.asarray, trainable),
                                jmake_optimizer(JOptimizerConfig(**dataclasses.asdict(OCFG))))
    jstep = jax.jit(jmake_train_step(jmodel, accum_steps=2, dropout=False))
    jmetrics = []
    for _ in range(STEPS):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, frozen), jax.tree.map(jnp.asarray, batch))
        jmetrics.append({k: float(v) for k, v in jm.items()})
    refs["jax"] = (flax_to_state_dict(jax.tree.map(np.asarray, jstate.trainable)), jmetrics)
    start = time.monotonic()
    while not ctx.join(timeout=5):
        if time.monotonic() - start > DEADLINE_S:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo ranks did not finish in {DEADLINE_S} s")
    results = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return cfg, params, batch, results, refs, out_dir


def _close_metrics(ours, ref):
    for a, b in zip(ours, ref, strict=True):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], rtol=TOL, err_msg=key)


def _close_leaves(ours: dict, ref: dict):
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k].detach().numpy(), v.detach().numpy(), atol=TOL, rtol=0, err_msg=k)


def test_ranks_hold_unequal_label_counts(ranks):
    _, _, batch, results, _, _ = ranks
    counts = [r["counts"] for r in results]
    assert counts[0] != counts[1] and all(c > 0 for rc in counts for c in rc), counts
    assert sum(map(sum, counts)) == int((batch["labels"][:, :, 1:] != -100).sum())


@pytest.mark.parametrize("dropout", [False, True], ids=["dropout_off", "dropout_on"])
def test_dp_matches_one_device_over_the_global_batch(ranks, dropout):
    _, _, _, results, refs, _ = ranks
    state, metrics = refs[dropout]
    for r in results:  # every rank ends with the same replica
        got = r[f"dp_dropout_{dropout}"]
        _close_metrics(got["metrics"], metrics)
        _close_leaves(got["trainable"], state.trainable)


def test_dp_matches_jax_train_step(ranks):
    _, _, _, results, refs, _ = ranks
    jtrainable, jmetrics = refs["jax"]
    got = results[0]["dp_dropout_False"]
    _close_metrics(got["metrics"], jmetrics)
    _close_leaves(got["trainable"], jtrainable)


def test_zero_matches_replicated_bitwise(ranks):
    _, _, _, results, _, _ = ranks
    for r in results:
        rep, zero = r["dp_dropout_False"], r["zero"]
        assert zero["metrics"] == rep["metrics"]
        assert all(torch.equal(zero["trainable"][k], p) for k, p in rep["trainable"].items())
        full = r["zero_full_opt_state"]
        assert full["count"] == rep["opt_state"]["count"] == STEPS
        for moment in ("mu", "nu"):
            for k, whole in rep["opt_state"][moment].items():
                assert torch.equal(full[moment][k], whole), (moment, k)
                shard = zero["opt_state"][moment][k]
                assert shard.shape[0] * 2 == whole.shape[0], (moment, k)  # every leaf here has an even first dim
    # the two ranks' halves are the two halves of the whole
    for k, whole in results[0]["dp_dropout_False"]["opt_state"]["mu"].items():
        halves = [r["zero"]["opt_state"]["mu"][k] for r in results]
        assert torch.equal(torch.cat(halves), whole), k


def test_zero_checkpoint_restores_onto_one_device_bitwise(ranks):
    _, params, _, results, _, out_dir = ranks
    model = worker.port_model(params)
    fresh = TrainState.create(freeze_towers(model)[0], make_optimizer(OCFG))
    state = restore_checkpoint(latest_checkpoint(str(out_dir / "zero_ckpt")), fresh)
    run = results[0]
    assert state.step == STEPS
    assert all(torch.equal(state.trainable[k], p) for k, p in run["zero"]["trainable"].items())
    for moment in ("mu", "nu"):
        for k, whole in run["dp_dropout_False"]["opt_state"][moment].items():
            assert torch.equal(state.opt_state[moment][k], whole), (moment, k)


def test_dp_eval_and_gather(ranks):
    cfg, _, _, results, refs, _ = ranks
    for r in results:
        np.testing.assert_allclose(r["eval"], refs["eval"], rtol=TOL)
        np.testing.assert_array_equal(r["gathered"], np.repeat([0.0, 1.0], 2)[:, None] * np.ones((4, 3)))
    with pytest.raises(ValueError, match="does not divide the data axis 2"):
        shard_batch({"x": torch.zeros(2, 3)}, Mesh(2, 0, (torch.device("cpu"),)), axis=1)
