"""The port's Trainer and native checkpoints (eilev_tpu_torch/training/trainer.py,
checkpoint.py) at tiny_config on the CPU: the loss falls; checkpoints are
written and pruned to save_total_limit; a resumed run matches the
uninterrupted one bit for bit with dropout on; the async writer round-trips;
profile_steps writes a trace; the best eval snapshot is restored at the end.
(tests/training/test_trainer.py and test_checkpoint.py are the JAX
counterparts.)"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from eilev_tpu_torch.training import OptimizerConfig, TrainState, make_optimizer
from eilev_tpu_torch.training.checkpoint import (
    AsyncCheckpointWriter,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from eilev_tpu_torch.training.trainer import Trainer, TrainerConfig

from ._torch_train import jax_setup, port_model, tiny_batch

SEED = 42  # TrainerConfig.seed


@pytest.fixture(scope="module")
def setup():
    cfg, _, params = jax_setup(seed=9)
    return cfg, params


def _batches(cfg, distinct=2, accum=2, micro_b=1):
    """train_batches(seed): the stream from step (seed - SEED) on, batch i the
    (i % distinct)-th of a fixed set, so a resumed run sees what an
    uninterrupted one sees at the same step."""
    fixed = [tiny_batch(cfg, accum, micro_b, seed=100 + i) for i in range(distinct)]

    def gen(seed):
        step = seed - SEED
        while True:
            yield fixed[step % distinct]
            step += 1

    return gen


def _trainer(setup, tmp_path, logs=None, **kw):
    cfg, params = setup
    conf = dict(output_dir=str(tmp_path / "ckpt"), num_train_steps=6, gradient_accumulation_steps=2,
                optimizer=OptimizerConfig(learning_rate=5e-3, warmup_steps=0, total_steps=20),
                eval_steps=0, save_steps=0, log_steps=1, dropout=True, seed=SEED)
    conf.update(kw)
    logger = None if logs is None else (lambda step, m: logs.append((step, m)))
    return Trainer(port_model(params), TrainerConfig(**conf), _batches(cfg), logger=logger)


def _trainable(trainer):
    return {k: p.detach().clone() for k, p in trainer.state.trainable.items()}


def test_loss_falls(setup, tmp_path):
    cfg, params = setup
    logs = []
    conf = TrainerConfig(output_dir=str(tmp_path / "ckpt"), num_train_steps=10, gradient_accumulation_steps=1,
                         optimizer=OptimizerConfig(learning_rate=5e-3, warmup_steps=0, total_steps=10),
                         eval_steps=0, save_steps=0, log_steps=1, dropout=False)
    trainer = Trainer(port_model(params), conf, _batches(cfg, distinct=1, accum=1, micro_b=2),
                      logger=lambda step, m: logs.append(m))
    trainer.train()
    losses = [m["loss"] for m in logs]
    assert len(losses) == 10 and losses[-1] < losses[0] - 0.05, losses
    assert all(m["grad_norm"] > 0 and m["step_time_sec"] > 0 and m["videos_per_sec"] > 0 for m in logs)


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoints_written_and_pruned(setup, tmp_path, async_save):
    trainer = _trainer(setup, tmp_path, num_train_steps=7, save_steps=2, save_total_limit=2, async_save=async_save)
    trainer.train()
    ckpt = tmp_path / "ckpt"
    assert sorted(os.listdir(ckpt)) == ["6", "7"]  # saves at 2, 4, 6 and the final 7, pruned to 2
    assert latest_checkpoint(str(ckpt)) == str(ckpt / "7")


def test_resume_matches_uninterrupted_bit_for_bit(setup, tmp_path):
    """6 steps straight against 3 steps, a save, a new model and Trainer that
    resumes and trains to 6: dropout is seeded by the step and the data
    stream by the resumed step, so every bit agrees."""
    straight = _trainer(setup, tmp_path / "a")
    straight.train()
    first = _trainer(setup, tmp_path / "b", num_train_steps=3, save_steps=3)
    first.train()
    resumed = _trainer(setup, tmp_path / "b", resume_from_checkpoint=True)
    assert resumed.state.step == 3
    resumed.train()
    assert resumed.state.step == straight.state.step == 6
    a, b = _trainable(straight), _trainable(resumed)
    for name in a:
        assert torch.equal(a[name], b[name]), name
    for name in a:
        assert torch.equal(straight.state.opt_state["mu"][name], resumed.state.opt_state["mu"][name])
    assert not torch.equal(a["query_tokens"], _trainable(first)["query_tokens"])


def test_async_writer_round_trips(setup, tmp_path):
    _, params = setup
    model = port_model(params)
    tr = {k: p for k, p in model.named_parameters() if p.requires_grad}
    tx = make_optimizer(OptimizerConfig(ema_decay=0.9))
    state = TrainState(step=5, trainable=tr, opt_state=tx.init(tr), tx=tx)
    best = (1.25, {k: v.detach() + 1.0 for k, v in tr.items()})
    with AsyncCheckpointWriter() as writer:
        path = writer.save(str(tmp_path), state, keep=1, best=best)
        with torch.no_grad():  # the snapshot was taken: training may go on
            for p in tr.values():
                p.add_(3.0)
        writer.wait()
        state.step = 6
        writer.save(str(tmp_path), state, keep=1)
    assert sorted(os.listdir(tmp_path)) == ["6"] and path.endswith("5")
    fresh_model = port_model(params)
    fresh_tr = {k: p for k, p in fresh_model.named_parameters() if p.requires_grad}
    restored, got_best = restore_checkpoint(
        latest_checkpoint(str(tmp_path)), TrainState.create(fresh_tr, tx), with_best=True)
    assert restored.step == 6 and got_best is None
    for name, p in fresh_tr.items():
        assert torch.equal(p, tr[name]), name
        assert torch.equal(restored.opt_state["ema"][name], state.opt_state["ema"][name])
    save_checkpoint(str(tmp_path / "b"), dataclasses.replace(state, step=5), best=best)
    _, got_best = restore_checkpoint(str(tmp_path / "b" / "5"), TrainState.create(fresh_tr, tx), with_best=True)
    assert got_best[0] == 1.25
    assert all(torch.equal(got_best[1][k], best[1][k]) for k in tr)


def test_profile_steps_writes_a_trace(setup, tmp_path):
    trainer = _trainer(setup, tmp_path, num_train_steps=4, profile_steps=(1, 3))
    trainer.train()
    trace = tmp_path / "ckpt" / "trace" / "steps_1_3.json"
    assert trace.is_file() and trace.stat().st_size > 0


def test_best_eval_snapshot_restored_at_end(setup, tmp_path):
    """Scripted eval losses 3, 1, 2 at steps 2, 4, 6: the step-4 weights come
    back at the end and ride in the final checkpoint."""
    cfg, _ = setup
    logs = []
    trainer = _trainer(setup, tmp_path, logs=logs, eval_steps=2, log_steps=100)
    trainer.eval_batches = lambda: [{k: v[0] for k, v in tiny_batch(cfg, 1, 2, seed=9).items()}]
    assert np.isfinite(trainer.evaluate())
    scripted = iter([3.0, 1.0, 2.0])
    snapshots = {}

    def evaluate():
        snapshots[trainer.state.step] = _trainable(trainer)
        return next(scripted)

    trainer.evaluate = evaluate
    trainer.train()
    assert sorted(snapshots) == [2, 4, 6] and [m for _, m in logs] == [{"eval_loss": x} for x in (3.0, 1.0, 2.0)]
    assert trainer.best_eval_loss == 1.0
    for name, p in trainer.state.trainable.items():
        assert torch.equal(p, snapshots[4][name]), name
    _, best = restore_checkpoint(latest_checkpoint(str(tmp_path / "ckpt")), trainer.state, with_best=True)
    assert best[0] == 1.0 and all(torch.equal(best[1][k], snapshots[4][k]) for k in snapshots[4])


@pytest.mark.parametrize("mode", [dict(zero_shard_opt_state=True), dict(pipeline_parallel=2)])
def test_parallel_modes_are_not_ported(setup, tmp_path, mode):
    with pytest.raises(NotImplementedError):
        _trainer(setup, tmp_path, **mode)
