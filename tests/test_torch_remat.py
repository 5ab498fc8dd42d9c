"""Per-layer remat of the frozen OPT trunk (``OPTConfig.remat``) in the port.

Remat must change only what backward keeps in memory, never the step's
numbers: with dropout on, in fp32, the loss and every trainable gradient are
bit-identical to the plain forward's, and so are the masters after a train
step with two micro-batches (the mask source is rewound for each recompute
and left where the plain forward leaves it). JAX's own bar is the same
(tests/training/test_remat.py); the plain forward is held to JAX in
tests/test_torch_train_step.py.
"""

import pytest
import torch

from eilev_tpu_torch.ops.dropout import DropoutRng
from eilev_tpu_torch.training import OptimizerConfig, TrainState, make_optimizer, make_train_step, partition_params

from ._torch_train import jax_setup, micro, port_model, tiny_batch, to_torch


@pytest.fixture(scope="module")
def params():
    return jax_setup(seed=8)[2]


def _loss_and_grads(model, batch, seed):
    trainable, _ = partition_params(dict(model.named_parameters()))
    model.train()
    rng = DropoutRng.seeded(seed, "cpu")
    loss = model(**batch, dropout_rng=rng)["loss"]
    grads = torch.autograd.grad(loss, list(trainable.values()))
    return loss.detach(), dict(zip(trainable, grads)), rng.get_state()


@pytest.mark.parametrize("seed", [0, 7])
def test_remat_loss_and_grads_bit_identical_with_dropout(params, seed):
    cfg = jax_setup(seed=8)[0]
    batch = to_torch(micro(tiny_batch(cfg, 1, 2, seed=3)))
    loss0, g0, end0 = _loss_and_grads(port_model(params), batch, seed)
    loss1, g1, end1 = _loss_and_grads(port_model(params, remat=True), batch, seed)
    assert torch.equal(loss0, loss1)
    assert g0.keys() == g1.keys()
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    # after backward's recomputes the generator stands where the plain run left it
    assert torch.equal(end0, end1)
    assert sum(float(g.square().sum()) for g in g0.values()) > 0
    # and dropout was live: another seed gives another loss
    assert not torch.equal(loss0, _loss_and_grads(port_model(params), batch, seed + 1)[0])


def test_remat_train_step_bit_identical(params):
    """Two micro-batches a step, two steps: the recompute of micro-batch 0's
    layers must not move the masks micro-batch 1 draws."""
    cfg = jax_setup(seed=8)[0]
    batch = to_torch(tiny_batch(cfg, 2, 1, seed=4))
    results = []
    for remat in (False, True):
        model = port_model(params, remat=remat)
        tr, _ = partition_params(dict(model.named_parameters()))
        state = TrainState.create(tr, make_optimizer(OptimizerConfig(learning_rate=1e-3, warmup_steps=0)))
        step = make_train_step(model, accum_steps=2, dropout=True)
        metrics = []
        for _ in range(2):
            state, m = step(state, batch)
            metrics.append((m["loss"], m["grad_norm"]))
        results.append((state, metrics))
    (s0, m0), (s1, m1) = results
    for (l0, n0), (l1, n1) in zip(m0, m1):
        assert torch.equal(l0, l1) and torch.equal(n0, n1)
    for name, p in s0.trainable.items():
        assert torch.equal(p, s1.trainable[name]), name


def test_remat_state_dict_names_unchanged(params):
    plain, remat = port_model(params), port_model(params, remat=True)
    assert list(plain.state_dict()) == list(remat.state_dict())
    for name, t in plain.state_dict().items():
        assert torch.equal(t, remat.state_dict()[name])


def test_remat_without_grad_is_the_plain_forward(params):
    cfg = jax_setup(seed=8)[0]
    batch = to_torch(micro(tiny_batch(cfg, 1, 2, seed=5)))
    with torch.no_grad():
        a = port_model(params).eval()(**batch)["logits"]
        b = port_model(params, remat=True).eval()(**batch)["logits"]
    assert torch.equal(a, b)
