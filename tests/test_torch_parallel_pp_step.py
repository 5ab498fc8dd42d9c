"""Port vs JAX: the pipeline-parallel train step (eilev_tpu_torch/training/
pipeline_step.py) at tiny_config on the CPU, fp32, dropout off.

- ``make_pp_train_step`` (2 stages on the CPU, 2 GPipe micro-batches) over
  two optimizer steps against JAX's ``make_pp_train_step`` (a shard_map over
  2 forced host devices): loss, grad_norm and every trainable leaf within
  1e-5, with gradient accumulation 2;
- OPT and T5: the pipelined step and eval step against the port's plain
  ``make_train_step`` / ``eval_step`` on the same batch, within 1e-5 (the
  trunk only regroups the rows of the same products);
- ``pp_partition_frozen``'s rest and per-stage blocks are JAX's
  ``pp_partition_frozen`` trees, and ``pp_unpartition_frozen`` gives back
  every frozen parameter (the tensors themselves).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eilev_tpu import configs
from eilev_tpu.models import VideoBlipForConditionalGeneration as JVB
from eilev_tpu.parallel import pipeline as jpipe
from eilev_tpu.training import OptimizerConfig as JOptimizerConfig
from eilev_tpu.training import TrainState as JTrainState
from eilev_tpu.training import make_optimizer as jmake_optimizer
from eilev_tpu.training.pipeline_step import make_pp_train_step as jmake_pp_train_step
from eilev_tpu.training.pipeline_step import pp_partition_frozen as jpp_partition_frozen
from eilev_tpu.training.train_state import partition_params as jpartition
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.models import VideoBlipForConditionalGeneration, params_from_jax
from eilev_tpu_torch.models.convert import flax_to_state_dict
from eilev_tpu_torch.parallel import make_pipeline_mesh, shard_stacked
from eilev_tpu_torch.training import OptimizerConfig, TrainState, eval_step, freeze_towers, make_optimizer
from eilev_tpu_torch.training import make_train_step
from eilev_tpu_torch.training.pipeline_step import (make_pp_eval_step, make_pp_train_step, pp_partition_frozen,
                                                    pp_unpartition_frozen)

from ._torch_port import random_params
from ._torch_train import jax_setup, micro, port_model, tiny_batch, to_torch

TOL = 1e-5
STAGES = 2
OCFG = OptimizerConfig(learning_rate=1e-3, eps=1e-6, warmup_steps=0, total_steps=5)


@pytest.fixture(scope="module")
def setup():
    return jax_setup(seed=11)


def _pp(model, m: int, accum: int, **kw):
    mesh = make_pipeline_mesh(STAGES, devices=["cpu"] * STAGES)
    _, stacked = pp_partition_frozen(model, STAGES)
    stacked = {k: shard_stacked(v, mesh) for k, v in stacked.items()}
    step = make_pp_train_step(model, mesh, stacked, num_microbatches=m, accum_steps=accum, dropout=False, **kw)
    return step, make_pp_eval_step(model, mesh, stacked, num_microbatches=m)


def test_pp_train_step_matches_jax(setup):
    cfg, jmodel, params = setup
    accum = 2
    batch = tiny_batch(cfg, accum, 2, seed=6)
    trainable, frozen = jpartition(params)
    jmesh = jpipe.make_pipeline_mesh(STAGES)
    rest, jstacked = jpp_partition_frozen(jax.tree.map(jnp.asarray, frozen), cfg, STAGES)
    jfrozen = (rest, jpipe.shard_stacked(jstacked, jmesh))
    jstate = JTrainState.create(jax.tree.map(jnp.asarray, trainable),
                                jmake_optimizer(JOptimizerConfig(**dataclasses.asdict(OCFG))))
    jstep = jax.jit(jmake_pp_train_step(jmodel, jmesh, num_microbatches=2, accum_steps=accum, dropout=False))
    model = port_model(params)
    state = TrainState.create(freeze_towers(model)[0], make_optimizer(OCFG))
    step, _ = _pp(model, 2, accum)
    for count in range(2):
        jstate, jm = jstep(jstate, jfrozen, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, to_torch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=TOL)
        theirs = flax_to_state_dict(jax.tree.map(np.asarray, jstate.trainable))
        assert theirs.keys() == state.trainable.keys()
        for name, p in state.trainable.items():
            np.testing.assert_allclose(p.detach().numpy(), theirs[name].numpy(), atol=TOL, rtol=0, err_msg=name)
    assert state.step == 2


@pytest.fixture(scope="module")
def t5_setup():
    """(jax config, port config, numpy params) of the tiny VideoBLIP-T5."""
    jcfg, tcfg = configs.tiny_config(text_model="t5"), tconfigs.tiny_config(text_model="t5")
    b = micro(tiny_batch(jcfg, 1, 2))
    params = jax.tree.map(np.asarray, random_params(
        JVB(jcfg), 12, input_ids=jnp.asarray(b["input_ids"]), pixel_values=jnp.asarray(b["pixel_values"]),
        video_input_mask=jnp.asarray(b["video_input_mask"]), labels=jnp.asarray(b["input_ids"])))
    return jcfg, tcfg, params


def _models(text_model, setup, t5_setup, n: int):
    """(jax config, port config, numpy params, ``n`` port models on those weights, towers frozen)."""
    if text_model == "opt":
        jcfg, _, params = setup
        return jcfg, tconfigs.tiny_config(text_model="opt"), params, [port_model(params) for _ in range(n)]
    jcfg, tcfg, params = t5_setup
    models = [VideoBlipForConditionalGeneration(tcfg, device="cpu") for _ in range(n)]
    for model in models:
        model.load_state_dict(params_from_jax(params, tcfg), strict=True)
        freeze_towers(model)
    return jcfg, tcfg, params, models


@pytest.mark.parametrize("text_model", ["opt", "t5"])
def test_pp_step_matches_plain_step(setup, t5_setup, text_model):
    cfg, _, _, models = _models(text_model, setup, t5_setup, 2)
    batch = to_torch(tiny_batch(cfg, 2, 4, seed=8))
    plain_model, pp_model = models
    plain_state = TrainState.create(freeze_towers(plain_model)[0], make_optimizer(OCFG))
    pp_state = TrainState.create(freeze_towers(pp_model)[0], make_optimizer(OCFG))
    plain = make_train_step(plain_model, accum_steps=2, dropout=False)
    pp, pp_eval = _pp(pp_model, 4, 2)
    for _ in range(2):
        plain_state, pm = plain(plain_state, batch)
        pp_state, m = pp(pp_state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(pm["loss"]), rtol=TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(pm["grad_norm"]), rtol=TOL)
        for name, p in pp_state.trainable.items():
            np.testing.assert_allclose(p.detach().numpy(), plain_state.trainable[name].detach().numpy(),
                                       atol=TOL, rtol=0, err_msg=name)
    np.testing.assert_allclose(float(pp_eval(micro(batch))), float(eval_step(plain_model, micro(batch))), rtol=TOL)


@pytest.mark.parametrize("text_model", ["opt", "t5"])
def test_pp_partition_frozen_matches_jax(setup, t5_setup, text_model):
    jcfg, tcfg, params, (model,) = _models(text_model, setup, t5_setup, 1)
    _, jfrozen = jpartition(params)
    jrest, jstacked = jpp_partition_frozen(jfrozen, jcfg, STAGES)
    rest, stacked = pp_partition_frozen(model, STAGES)

    def equal(ours: dict, ref_tree) -> None:
        ref = flax_to_state_dict(ref_tree)
        assert sorted(ours) == sorted(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(ours[k].detach().numpy(), v.numpy(), err_msg=k)

    equal(rest, jrest)
    assert sorted(stacked) == sorted(jstacked)
    for key, tree in jstacked.items():
        drop = stacked[key].drop_key
        for s, block in enumerate(stacked[key].blocks):
            for j, layer in enumerate(block):
                equal({k: v for k, v in layer.state_dict().items() if drop is None or drop not in k},
                      jax.tree.map(lambda a: a[s, j], tree))
    frozen = {k: p for k, p in model.named_parameters() if not p.requires_grad}
    full = pp_unpartition_frozen(rest, stacked, tcfg)
    assert full.keys() == frozen.keys() and all(full[k] is p for k, p in frozen.items())
