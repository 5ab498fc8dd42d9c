"""Port vs JAX: the GPipe trunk (eilev_tpu_torch/parallel/pipeline.py), fp32
on the CPU.

- ``make_pipeline_trunk`` over the OPT, T5-encoder and T5-decoder layer
  applies equals JAX's ``make_pipeline_trunk`` (a shard_map over 2 or 4 of
  the 8 forced host devices) on the same weights, for S in {2, 4} and M in
  {1, 2, 4}, within 1e-5 (JAX's own pipeline test holds its trunk to its
  sequential stack at 2e-5);
- the port's per-stage blocks are JAX's stacked tree slice by slice, and
  ``unstack_layer_params`` gives the layers back in order (the frozen
  tree's partition: tests/test_torch_parallel_pp_step.py);
- the trunk's gradients (input and layer weights) equal the sequential
  stack's, which the port's model tests hold to JAX (1e-5);
- ``make_pipeline_mesh`` refuses more stages than devices unless given the
  device list.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu import configs
from eilev_tpu.models import opt as jopt
from eilev_tpu.models import t5 as jt5
from eilev_tpu.parallel import pipeline as jpipe
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.models import opt as topt
from eilev_tpu_torch.models import t5 as tt5
from eilev_tpu_torch.models.convert import flax_to_state_dict
from eilev_tpu_torch.parallel import pipeline as tpipe

from ._torch_port import load_port, random_params

TOL = 1e-5
LAYERS = 4
B, T, T_DEC = 4, 10, 6
CASES = [(s, m) for s in (2, 4) for m in (1, 2, 4)]
REL = "relative_attention_bias"


def _inputs(d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    lengths = np.asarray([7, 10, 9, 10])[:, None]
    mask = (np.arange(T)[None] < lengths).astype(np.int32)
    return x, mask


@pytest.fixture(scope="module")
def opt_pair():
    jcfg = dataclasses.replace(configs.tiny_config(text_model="opt", layers=LAYERS).text_config, dropout=0.0)
    tcfg = dataclasses.replace(tconfigs.tiny_config(text_model="opt", layers=LAYERS).text_config, dropout=0.0)
    x, mask = _inputs(jcfg.hidden_size)
    params = jax.tree.map(np.asarray, random_params(jopt.OPTForCausalLM(jcfg), 5, jnp.asarray(x),
                                                    attention_mask=jnp.asarray(mask)))
    return jcfg, params, load_port(topt.OPTForCausalLM(tcfg), params), x, mask


@pytest.fixture(scope="module")
def t5_pair():
    jcfg = dataclasses.replace(configs.tiny_config(text_model="t5", layers=LAYERS).text_config, dropout_rate=0.0)
    tcfg = dataclasses.replace(tconfigs.tiny_config(text_model="t5", layers=LAYERS).text_config, dropout_rate=0.0)
    x, mask = _inputs(jcfg.d_model)
    dec = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(B, T_DEC)).astype(np.int32)
    jmodel = jt5.T5ForConditionalGeneration(jcfg)
    params = jax.tree.map(np.asarray, random_params(jmodel, 6, x, mask, dec))
    return jcfg, jmodel, params, load_port(tt5.T5ForConditionalGeneration(tcfg), params), x, mask


def _jax_trunk(layer_apply, lm_params, stages, m, args, **kw):
    mesh = jpipe.make_pipeline_mesh(stages)
    stacked = jpipe.shard_stacked(
        jpipe.stack_layer_params(lm_params, LAYERS, stages, drop_key=kw.pop("drop_key", None)), mesh)
    trunk = jpipe.make_pipeline_trunk(layer_apply, mesh, num_microbatches=m, **kw)
    return np.asarray(jax.jit(trunk)(stacked, *args))


def _port_trunk(layer_apply, layers, stages, m, args, drop_key=None, **kw):
    mesh = tpipe.make_pipeline_mesh(stages, devices=["cpu"] * stages)
    stacked = tpipe.shard_stacked(tpipe.stack_layer_params(layers, stages, drop_key=drop_key), mesh)
    trunk = tpipe.make_pipeline_trunk(layer_apply, mesh, num_microbatches=m, **kw)
    with torch.no_grad():
        return trunk(stacked, *(torch.tensor(np.asarray(a)) for a in args)).numpy()


@pytest.mark.parametrize("stages,m", CASES)
def test_opt_trunk_matches_jax(opt_pair, stages, m):
    jcfg, params, model, x, mask = opt_pair
    ref = _jax_trunk(jpipe.opt_layer_apply(jcfg), params, stages, m, (x, mask))
    ours = _port_trunk(tpipe.opt_layer_apply(), model.layers, stages, m, (x, mask))
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("stages,m", CASES)
def test_t5_encoder_trunk_matches_jax(t5_pair, stages, m):
    jcfg, jmodel, params, model, x, mask = t5_pair
    bias = np.asarray(jmodel.apply({"params": params}, T, method=jt5.T5ForConditionalGeneration.encoder_rel_bias))
    np.testing.assert_allclose(model.encoder_rel_bias(T).detach().numpy(), bias, atol=0, rtol=0)
    ref = _jax_trunk(jpipe.t5_encoder_layer_apply(jcfg), params["encoder"], stages, m, (x, mask, bias),
                     drop_key=REL, const_extras=1)
    ours = _port_trunk(tpipe.t5_encoder_layer_apply(), model.encoder.layers, stages, m, (x, mask, bias),
                       drop_key=REL, const_extras=1)
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("stages,m", CASES)
def test_t5_decoder_trunk_matches_jax(t5_pair, stages, m):
    jcfg, jmodel, params, model, x, mask = t5_pair
    rng = np.random.default_rng(2)
    dec_x = rng.normal(size=(B, T_DEC, jcfg.d_model)).astype(np.float32)
    dec_mask = np.ones((B, T_DEC), np.int32)
    bias = np.asarray(jmodel.apply({"params": params}, T_DEC,
                                   method=jt5.T5ForConditionalGeneration.decoder_rel_bias))
    np.testing.assert_allclose(model.decoder_rel_bias(T_DEC).detach().numpy(), bias, atol=0, rtol=0)
    args = (dec_x, dec_mask, x, mask, bias)
    ref = _jax_trunk(jpipe.t5_decoder_layer_apply(jcfg), params["decoder"], stages, m, args, drop_key=REL,
                     batch_extras=2, const_extras=1)
    ours = _port_trunk(tpipe.t5_decoder_layer_apply(), model.decoder.layers, stages, m, args, drop_key=REL,
                       batch_extras=2, const_extras=1)
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=TOL)


def _layer_state(stacked, s: int, j: int) -> dict:
    """Layer j of block s's parameters without the dropped ones: the slice
    [s, j] of JAX's stacked tree."""
    drop = stacked.drop_key
    return {k: v for k, v in stacked.blocks[s][j].state_dict().items() if drop is None or drop not in k}


def _equal_sd(ours: dict, ref_tree) -> None:
    ref = flax_to_state_dict(ref_tree)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].detach().numpy(), v.numpy(), err_msg=k)


@pytest.mark.parametrize("stages", [2, 4])
def test_stack_and_unstack_match_jax_trees(opt_pair, t5_pair, stages):
    _, opt_params, opt_model, _, _ = opt_pair
    _, _, t5_params, t5_model, _, _ = t5_pair
    for layers, tree, drop in ((opt_model.layers, opt_params, None),
                               (t5_model.encoder.layers, t5_params["encoder"], REL),
                               (t5_model.decoder.layers, t5_params["decoder"], REL)):
        ref = jax.tree.map(np.asarray, jpipe.stack_layer_params(tree, LAYERS, stages, drop_key=drop))
        ours = tpipe.stack_layer_params(layers, stages, drop_key=drop)
        assert len(ours.blocks) == stages and all(len(b) == LAYERS // stages for b in ours.blocks)
        for s in range(stages):
            for j in range(LAYERS // stages):
                _equal_sd(_layer_state(ours, s, j), jax.tree.map(lambda a: a[s, j], ref))
        assert tpipe.unstack_layer_params(ours) == list(layers)
        back = jpipe.unstack_layer_params(ref, LAYERS)
        for i, layer in enumerate(tpipe.unstack_layer_params(ours)):
            _equal_sd({k: v for k, v in layer.state_dict().items() if drop is None or drop not in k},
                      back[f"layers_{i}"])
    with pytest.raises(ValueError, match="equal pipeline stages"):
        tpipe.stack_layer_params(opt_model.layers, 3)


def test_trunk_gradients_match_sequential(opt_pair, t5_pair):
    """d(sum of squares of the output) by the input and by every layer
    weight: the trunk (S = 2, M = 2 and S = 4, M = 4) against the same
    layers applied in order."""
    _, _, model, x, mask = opt_pair
    _, _, _, t5_model, _, _ = t5_pair
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    bias = t5_model.encoder_rel_bias(T).detach()
    kinds = ((tpipe.opt_layer_apply(), model.layers, (), {}, None),
             (tpipe.t5_encoder_layer_apply(), t5_model.encoder.layers, (bias,), {"const_extras": 1}, REL))
    for apply, layers, extras, kw, drop in kinds:
        weights = [p for layer in layers for p in layer.parameters() if p.dtype.is_floating_point]
        for p in weights:
            p.requires_grad_(True)
        try:
            def grads(run):
                xin = xt.clone().requires_grad_(True)
                out = run(xin)
                return torch.autograd.grad(out.square().sum(), [xin, *weights], allow_unused=True)

            def sequential(h):
                for layer in layers:
                    h = apply(layer, h, mt, *extras)
                return h

            ref = grads(sequential)
            for stages, m in ((2, 2), (4, 4)):
                mesh = tpipe.make_pipeline_mesh(stages, devices=["cpu"] * stages)
                stacked = tpipe.shard_stacked(tpipe.stack_layer_params(layers, stages, drop_key=drop), mesh)
                trunk = tpipe.make_pipeline_trunk(apply, mesh, num_microbatches=m, **kw)
                got = grads(lambda h: trunk(stacked, h, mt, *extras))
                for a, b in zip(got, ref):
                    if b is None:
                        assert a is None
                        continue
                    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=TOL)
        finally:
            for p in weights:
                p.requires_grad_(False)


def test_make_pipeline_mesh_refuses_more_stages_than_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = tpipe.make_pipeline_mesh(2)
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert mesh.shape == {"data": 1, "stage": 2}
    with pytest.raises(ValueError, match="need 4 visible CUDA devices"):
        tpipe.make_pipeline_mesh(4)
    monkeypatch.setenv("LOCAL_RANK", "1")  # the second data replica of a host takes cards 2 and 3
    with pytest.raises(ValueError, match="from cuda:2 need 4"):
        tpipe.make_pipeline_mesh(2)
    # an explicit list may repeat a device; it must be long enough
    mesh = tpipe.make_pipeline_mesh(4, devices=["cuda:0"] * 4)
    assert mesh.devices == (torch.device("cuda", 0),) * 4 and mesh.device == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="need 3 devices"):
        tpipe.make_pipeline_mesh(3, devices=["cpu", "cpu"])
    trunk = tpipe.make_pipeline_trunk(tpipe.opt_layer_apply(), tpipe.make_pipeline_mesh(2, devices=["cpu"] * 2),
                                      num_microbatches=4)
    with pytest.raises(ValueError, match="does not split into 4"):
        trunk(tpipe.StackedLayers([[], []]), torch.zeros(6, 3, 2), torch.ones(6, 3))
