"""Port vs JAX: the v2 training forward, dropout, the optimizer and the train
step at tiny_config (OPT), fp32 unless stated.

The same numpy weights and batches go through eilev_tpu (``model.apply``,
``jax.value_and_grad``, ``training.make_train_step``) and
eilev_tpu_torch (``forward``, autograd, ``training.make_train_step``). With
dropout on, ``flax.linen.intercept_methods`` feeds JAX's ``nn.Dropout`` calls
the masks the port's mask source drew, in call order. Bars: loss 1e-5,
gradients 1e-4, the trainable masters after three optimizer steps and
grad_norm 1e-5, the bf16 loss 2e-2.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu.models import VideoBlipForConditionalGeneration as JVB
from eilev_tpu.training import OptimizerConfig as JOptimizerConfig
from eilev_tpu.training import TrainState as JTrainState
from eilev_tpu.training import ema_params as jema_params
from eilev_tpu.training import make_optimizer as jmake_optimizer
from eilev_tpu.training import make_train_step as jmake_train_step
from eilev_tpu.training import merge_params as jmerge
from eilev_tpu.training import partition_params as jpartition
from eilev_tpu_torch.models.convert import flax_to_state_dict
from eilev_tpu_torch.training import (
    OptimizerConfig,
    TrainState,
    ema_params,
    eval_step,
    freeze_towers,
    make_optimizer,
    make_train_step,
    merge_params,
    partition_params,
)
from eilev_tpu_torch.training.train_state import make_schedule

from ._torch_train import jax_setup, micro, port_model, tiny_batch, to_torch

SITES = 16  # tiny_config: 1 + 2 x 5 Q-Former sites, 1 + 2 x 2 OPT sites
# The step comparisons' optimizer. An attention key bias has a gradient of
# exactly 0 in exact arithmetic (it shifts a whole score row), so each
# package hands Adam its own rounding noise there (~1e-9), and at the default
# eps (1e-8) Adam scales that noise to ~lr/10 a step, differently in each.
# At eps 1e-6 the noise moves a key bias by ~lr/1000; every other gradient is
# above 3e-3 and sees no difference. The recipe's default eps is held too:
# there an element whose gradient stays within NOISE_EPS x eps (its Adam RMS,
# sqrt of the bias-corrected second moment) takes a step that the rounding
# noise sets, and is held apart (the key biases and ~1% of the rest).
OCFG = dict(learning_rate=1e-3, eps=1e-6)
NOISE_EPS = 10


@pytest.fixture(scope="module")
def setup():
    return jax_setup()


class RecordingMasks:
    """The port's mask source for the parity runs: numpy keep-masks, recorded
    in call order so that JAX's dropout calls can be fed the same ones."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.masks = []

    def keep(self, shape, rate, device):
        m = self.rng.random(shape) < 1.0 - rate
        self.masks.append((m, rate))
        return torch.from_numpy(m).to(device)

    def get_state(self):
        return len(self.masks)

    def set_state(self, state):
        raise AssertionError("no remat in the parity runs")


def _jax_loss_and_grads(cfg, model, params, batch, masks=None):
    """JAX's loss and trainable grads on one micro batch; with ``masks``, every
    nn.Dropout call takes the next recorded mask (flax's law)."""
    trainable, frozen = jpartition(params)
    b = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(tr):
        return model.apply(
            {"params": jmerge(tr, frozen)}, input_ids=b["input_ids"], attention_mask=b["attention_mask"],
            pixel_values=b["pixel_values"], video_input_mask=b["video_input_mask"], labels=b["labels"],
            deterministic=masks is None,
        )["loss"]

    if masks is None:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(trainable)
        return float(loss), grads, 0
    feed = iter(masks)
    calls = []

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
            x = args[0]
            mask, rate = next(feed)
            assert mask.shape == x.shape, (mask.shape, x.shape)
            assert rate == context.module.rate
            calls.append(x.shape)
            keep_prob = 1.0 - context.module.rate
            return jax.lax.select(jnp.asarray(mask), x / keep_prob, jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(interceptor):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(trainable)
    return float(loss), grads, len(calls)


def _port_loss_and_grads(model, batch, rng=None):
    trainable, _ = partition_params(dict(model.named_parameters()))
    model.train(rng is not None)
    loss = model(**to_torch(batch), dropout_rng=rng)["loss"]
    grads = torch.autograd.grad(loss, list(trainable.values()))
    return float(loss.detach()), dict(zip(trainable, grads))


def _assert_grads_close(ours, jax_grads, tol=1e-4):
    theirs = flax_to_state_dict(jax.tree.map(np.asarray, jax_grads))
    assert set(ours) == set(theirs)
    for name, g in ours.items():
        np.testing.assert_allclose(g.numpy(), theirs[name].numpy(), rtol=tol, atol=tol, err_msg=name)
    assert sum(float(g.square().sum()) for g in ours.values()) > 0


def test_forward_loss_and_grads_match_jax(setup):
    cfg, jmodel, params = setup
    batch = micro(tiny_batch(cfg, 1, 2, seed=1))
    jloss, jgrads, _ = _jax_loss_and_grads(cfg, jmodel, params, batch)
    model = port_model(params)
    loss, grads = _port_loss_and_grads(model, batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _assert_grads_close(grads, jgrads)
    out = model(**to_torch(batch))
    assert out["logits"].shape == (2, 16, cfg.text_config.vocab_size)


def test_dropout_masks_match_jax_at_every_site(setup):
    cfg, jmodel, params = setup
    batch = micro(tiny_batch(cfg, 1, 2, seed=2))
    masks = RecordingMasks(5)
    model = port_model(params)
    loss, grads = _port_loss_and_grads(model, batch, masks)
    assert len(masks.masks) == SITES
    jloss, jgrads, calls = _jax_loss_and_grads(cfg, jmodel, params, batch, masks.masks)
    assert calls == SITES
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _assert_grads_close(grads, jgrads)
    # the masks change the loss: dropout is live at these sites
    model.eval()
    with torch.no_grad():
        assert abs(float(model(**to_torch(batch))["loss"]) - loss) > 1e-4


def test_training_mode_without_a_mask_source_raises(setup):
    cfg, _, params = setup
    model = port_model(params).train()
    with pytest.raises(ValueError, match="dropout_rng"):
        model(**to_torch(micro(tiny_batch(cfg, 1, 1))))


@pytest.mark.parametrize("eps", [1e-6, 1e-8], ids=["eps1e-6", "default_eps"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(setup, accum, eps):
    """Three optimizer steps (warmup 1, so the first has lr 0; clipping and
    weight decay on): the masters and grad_norm within 1e-5 of JAX's. At the
    default eps, an element whose Adam RMS has stayed below NOISE_EPS x eps
    (a gradient of rounding noise) is held within the sum of the steps' lrs,
    the most Adam moves a weight by, and such elements stay under 2%."""
    cfg, jmodel, params = setup
    ocfg = OptimizerConfig(**dict(OCFG, eps=eps, warmup_steps=1, total_steps=5))
    assert eps == 1e-6 or eps == OptimizerConfig().eps
    batch = tiny_batch(cfg, accum, 2 // accum, seed=4)
    trainable, frozen = jpartition(params)
    jocfg = JOptimizerConfig(**dataclasses.asdict(ocfg))
    jstate = JTrainState.create(jax.tree.map(jnp.asarray, trainable), jmake_optimizer(jocfg))
    jstep = jax.jit(jmake_train_step(jmodel, accum_steps=accum, dropout=False))
    model = port_model(params)
    tr, _ = partition_params(dict(model.named_parameters()))
    state = TrainState.create(tr, make_optimizer(ocfg))
    step = make_train_step(model, accum_steps=accum, dropout=False)
    sched, lr_sum = make_schedule(ocfg), 0.0
    rms = {k: torch.full_like(p, float("inf")) for k, p in tr.items()}
    for count in range(3):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, frozen), jax.tree.map(jnp.asarray, batch))
        state, m = step(state, to_torch(batch))
        lr_sum += float(sched(count))
        bc2 = 1.0 - ocfg.beta2 ** (count + 1)
        rms = {k: torch.minimum(r, (state.opt_state["nu"][k] / bc2).sqrt()) for k, r in rms.items()}
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        theirs = flax_to_state_dict(jax.tree.map(np.asarray, jstate.trainable))
        for name, p in state.trainable.items():
            noise = rms[name] < NOISE_EPS * eps if eps != 1e-6 else torch.zeros_like(p, dtype=torch.bool)
            atol = torch.where(noise, lr_sum, 1e-5).numpy()
            diff = (p.detach() - theirs[name]).abs().numpy()
            assert (diff <= atol).all(), (name, count, float(diff.max()), int((diff > atol).sum()))
    n_noise = sum(int((r < NOISE_EPS * eps).sum()) for r in rms.values()) if eps != 1e-6 else 0
    assert n_noise < 0.02 * sum(p.numel() for p in tr.values()), n_noise
    assert state.step == 3 and float(jm["grad_norm"]) > 1.0  # the clip was active


@pytest.mark.parametrize(
    "ocfg",
    [dict(learning_rate=1e-3, warmup_steps=3, total_steps=10),
     dict(learning_rate=2e-4, warmup_steps=0, total_steps=6),
     dict(learning_rate=5e-4, schedule="constant", weight_decay=0.1)],
)
def test_lr_sequence_matches_optax(ocfg):
    """With zero gradients an AdamW update is -lr(count) * weight_decay * p:
    the port's updates equal the JAX optimizer's at every count, across the
    warmup, the decay and past total_steps."""
    params = {"w": np.linspace(-1.0, 1.0, 8, dtype=np.float32)}
    jtx = jmake_optimizer(JOptimizerConfig(**ocfg))
    tx = make_optimizer(OptimizerConfig(**ocfg))
    jstate, state = jtx.init(jax.tree.map(jnp.asarray, params)), tx.init(to_torch(params))
    sched = make_schedule(OptimizerConfig(**ocfg))
    zero = {"w": np.zeros(8, np.float32)}
    for count in range(13):
        jup, jstate = jtx.update(jax.tree.map(jnp.asarray, zero), jstate, jax.tree.map(jnp.asarray, params))
        up, state = tx.update(to_torch(zero), state, to_torch(params))
        np.testing.assert_allclose(up["w"].numpy(), np.asarray(jup["w"]), rtol=1e-6, atol=0, err_msg=str(count))
        np.testing.assert_allclose(-np.asarray(jup["w"]) / (OptimizerConfig(**ocfg).weight_decay * params["w"]),
                                   sched(count), rtol=1e-5)
    assert sched(0) == (0.0 if ocfg.get("warmup_steps") else np.float32(ocfg["learning_rate"]))


def test_ema_matches_jax_and_frozen_weights_stay(setup):
    cfg, jmodel, params = setup
    ocfg = dict(OCFG, warmup_steps=0, total_steps=10, ema_decay=0.8)
    batch = tiny_batch(cfg, 1, 2, seed=6)
    trainable, frozen = jpartition(params)
    jstate = JTrainState.create(jax.tree.map(jnp.asarray, trainable), jmake_optimizer(JOptimizerConfig(**ocfg)))
    jstep = jax.jit(jmake_train_step(jmodel, accum_steps=1, dropout=False))
    model = port_model(params)
    tr, fr = freeze_towers(model)
    frozen_before = {k: v.detach().clone() for k, v in fr.items()}
    state = TrainState.create(tr, make_optimizer(OptimizerConfig(**ocfg)))
    for name, e in ema_params(state).items():
        assert torch.equal(e, tr[name]) and e.data_ptr() != tr[name].data_ptr()
    step = make_train_step(model, accum_steps=1, dropout=True)
    plain_step = make_train_step(model, accum_steps=1, dropout=False)
    for _ in range(3):
        jstate, _ = jstep(jstate, jax.tree.map(jnp.asarray, frozen), jax.tree.map(jnp.asarray, batch))
        state, _ = plain_step(state, to_torch(batch))
    theirs = flax_to_state_dict(jax.tree.map(np.asarray, jema_params(jstate)))
    for name, e in ema_params(state).items():
        np.testing.assert_allclose(e.numpy(), theirs[name].numpy(), rtol=0, atol=1e-5, err_msg=name)
    state, m = step(state, to_torch(batch))  # a dropout step too
    assert np.isfinite(float(m["loss"]))
    for name, p in model.named_parameters():
        if name in frozen_before:
            assert not p.requires_grad and torch.equal(p, frozen_before[name]), name
        else:
            assert p.requires_grad
    assert {k.split(".")[0] for k in tr} == {"query_tokens", "qformer", "language_projection"}
    assert {k.split(".")[0] for k in fr} == {"vision_model", "language_model"}
    assert np.isfinite(float(eval_step(model, to_torch(micro(batch)))))


def test_ema_needs_the_option(setup):
    _, _, params = setup
    tr, _ = freeze_towers(port_model(params))
    with pytest.raises(ValueError, match="ema_decay"):
        ema_params(TrainState.create(tr, make_optimizer(OptimizerConfig())))


def test_bf16_loss_matches_jax_bf16(setup):
    """bf16 compute with fp32 trainable masters in both packages (JAX's
    frozen params cast to bf16, as the training bench keeps them)."""
    cfg, _, params = setup
    jmodel = JVB(cfg, dtype=jnp.bfloat16)
    trainable, frozen = jpartition(params)
    bf16_params = jmerge(trainable, jax.tree.map(lambda x: np.asarray(x).astype(jnp.bfloat16), frozen))
    batch = micro(tiny_batch(cfg, 1, 2, seed=7))
    jloss, jgrads, _ = _jax_loss_and_grads(cfg, jmodel, bf16_params, batch)
    model = port_model(bf16_params, dtype=torch.bfloat16, trainable_dtype=torch.float32)
    assert model.qformer.layernorm.weight.dtype == torch.float32
    assert model.language_model.embed_tokens.weight.dtype == torch.bfloat16
    loss, grads = _port_loss_and_grads(model, batch)
    np.testing.assert_allclose(loss, jloss, rtol=2e-2)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads.values())
    theirs = flax_to_state_dict(jax.tree.map(np.asarray, jgrads))
    a = torch.cat([g.flatten() for g in grads.values()])
    b = torch.cat([theirs[k].float().flatten() for k in grads])
    assert float(torch.nn.functional.cosine_similarity(a, b, dim=0)) > 0.99


def test_partition_merge_round_trip(setup):
    _, _, params = setup
    model = port_model(params)
    named = dict(model.named_parameters())
    tr, fr = partition_params(named)
    assert merge_params(tr, fr).keys() == named.keys() and not set(tr) & set(fr)
