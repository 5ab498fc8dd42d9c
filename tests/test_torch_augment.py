"""The port's training augmentations (eilev_tpu_torch/ops/preprocess.py)
against eilev_tpu.ops.preprocess.

Each JAX random op is split in the port into a draw and a deterministic
apply. These tests replay the JAX function's own key splits (its draws) into
the port's apply and hold the outputs to JAX's on the same uint8 clips:
atol 1e-3 on the 0-255 scale for the ops that resample or reduce, exact for
flip, crop, posterize and solarize.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu.ops import preprocess as jp
from eilev_tpu_torch.ops import preprocess as tp

TOL = 1e-3  # on the 0-255 scale
EXACT_OPS = {"_op_identity", "_op_solarize", "_op_posterize"}
OP_NAMES = [f.__name__ for f in tp._RAND_AUG_OPS]


def _clip(seed, shape=(3, 4, 24, 32)):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _jax_layers(key, num_layers=2, prob=0.5):
    """JAX rand_augment's draws, by its own key splits."""
    layers = []
    for _ in range(num_layers):
        key, k_op, k_apply, k_param = jax.random.split(key, 4)
        op = int(jax.random.randint(k_op, (), 0, len(jp._RAND_AUG_OPS)))
        applies = bool(jax.random.bernoulli(k_apply, prob))
        layers.append((op, applies, _jax_sign(k_param)))
    return tuple(layers)


def _jax_sign(key):
    return 1.0 if bool(jax.random.bernoulli(key, 0.5)) else -1.0


def _jax_crop_draws(key, scale=(0.5, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """JAX random_resized_crop's draws, by its own key splits."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    area = jax.random.uniform(k1, (10,), minval=scale[0], maxval=scale[1])
    log_ratio = jax.random.uniform(k2, (10,), minval=jnp.log(ratio[0]), maxval=jnp.log(ratio[1]))
    return tuple(np.array(d) for d in (area, log_ratio, jax.random.uniform(k3), jax.random.uniform(k4)))


def _close(ours, theirs, exact=False, tol=TOL):
    ours, theirs = ours.detach().numpy(), np.asarray(theirs)
    assert ours.shape == theirs.shape
    if exact:
        np.testing.assert_array_equal(ours, theirs)
    else:
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=tol)


@pytest.mark.parametrize("magnitude", [5.0, 9.0])
@pytest.mark.parametrize("name", OP_NAMES)
def test_rand_augment_op_matches_jax(name, magnitude):
    idx = OP_NAMES.index(name)
    video = _clip(idx).astype(np.float32)
    for seed in (0, 1):  # both signs of the signed ops
        key = jax.random.PRNGKey(seed)
        theirs = jp._RAND_AUG_OPS[idx](jnp.asarray(video), jnp.float32(magnitude), key)
        ours = tp._RAND_AUG_OPS[idx](torch.from_numpy(video), magnitude, _jax_sign(key))
        _close(ours, theirs, exact=name in EXACT_OPS)


def test_equalize_matches_jax_on_a_flat_frame():
    """A frame of one value has step 0: equalize leaves it as it is."""
    video = _clip(3).astype(np.float32)
    video[1, 2] = 77.0
    theirs = jp._op_equalize(jnp.asarray(video), jnp.float32(5.0))
    _close(tp._op_equalize(torch.from_numpy(video), 5.0, 1.0), theirs)


@pytest.mark.parametrize("seed", range(6))
def test_rand_augment_matches_jax_on_replayed_draws(seed):
    video = _clip(10 + seed)
    key = jax.random.PRNGKey(seed)
    theirs = jp.rand_augment(key, jnp.asarray(video), magnitude=5.0)
    ours = tp.apply_rand_augment(torch.from_numpy(video), _jax_layers(key), magnitude=5.0)
    _close(ours, theirs)


@pytest.mark.parametrize(
    "shape,out",
    [((3, 2, 24, 32), (16, 16)),  # downscale
     ((3, 2, 12, 10), (20, 24)),  # upscale
     ((3, 2, 8, 64), (16, 16))],  # no candidate fits: the center-crop fallback
)
@pytest.mark.parametrize("seed", range(3))
def test_random_resized_crop_matches_jax_on_replayed_draws(shape, out, seed):
    video = _clip(seed, shape).astype(np.float32)
    key = jax.random.PRNGKey(100 + seed)
    theirs = jp.random_resized_crop(key, jnp.asarray(video), *out)
    box = tp.crop_box(shape[-2], shape[-1], _jax_crop_draws(key))
    _close(tp.resized_crop(torch.from_numpy(video), box, *out), theirs)


@pytest.mark.parametrize("seed", range(4))
def test_train_transform_matches_jax_on_replayed_draws(seed):
    video = _clip(20 + seed, (3, 6, 24, 32))
    key = jax.random.PRNGKey(seed)
    theirs = jp.train_transform(key, jnp.asarray(video), num_frames=4, height=16, width=16)
    k_aug, k_crop, k_flip = jax.random.split(key, 3)
    draws = tp.TrainDraws(_jax_layers(k_aug), _jax_crop_draws(k_crop), bool(jax.random.bernoulli(k_flip, 0.5)))
    ours = tp.apply_train_transform(torch.from_numpy(video), draws, num_frames=4, height=16, width=16)
    # back to the 0-255 scale: x * std * 255 per channel
    to255 = 255.0 * np.asarray(tp.CLIP_STD, np.float32).reshape(3, 1, 1, 1)
    _close(ours * torch.from_numpy(to255), np.asarray(theirs) * to255)


@pytest.mark.parametrize("seed", range(4))
def test_random_horizontal_flip_matches_jax(seed):
    video = _clip(seed).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    theirs = jp.random_horizontal_flip(key, jnp.asarray(video))
    ours = tp.horizontal_flip(torch.from_numpy(video), bool(jax.random.bernoulli(key, 0.5)))
    _close(ours, theirs, exact=True)


@pytest.mark.parametrize("sizes", [(8, 12), (30, 40)])  # down, up
def test_short_side_scale_matches_jax(sizes):
    video = _clip(5, (3, 2, 20, 26)).astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        theirs = jp.random_short_side_scale(key, jnp.asarray(video), *sizes)
        size = int(jax.random.randint(key, (), sizes[0], sizes[1] + 1))
        _close(tp.short_side_scale(torch.from_numpy(video), size), theirs)


def test_random_crop_matches_jax():
    video = _clip(6, (3, 2, 20, 26))
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        theirs = jp.random_crop(key, jnp.asarray(video), 12, 16)
        k1, k2 = jax.random.split(key)
        top = int(jax.random.randint(k1, (), 0, 20 - 12 + 1))
        left = int(jax.random.randint(k2, (), 0, 26 - 16 + 1))
        _close(tp.crop(torch.from_numpy(video), top, left, 12, 16), theirs, exact=True)


def test_same_seed_same_output():
    video = torch.from_numpy(_clip(7, (3, 6, 24, 32)))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return torch.stack([tp.train_transform(g, video, num_frames=4, height=16, width=16) for _ in range(3)])

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.isfinite(a).all() and a.shape == (3, 3, 4, 16, 16)
    for fn in (lambda g: tp.random_short_side_scale(g, video, 10, 14),
               lambda g: tp.random_crop(g, video, 12, 16),
               lambda g: tp.rand_augment(g, video),
               lambda g: tp.random_resized_crop(g, video.float(), 16, 16),
               lambda g: tp.random_horizontal_flip(g, video)):
        assert torch.equal(fn(torch.Generator().manual_seed(5)), fn(torch.Generator().manual_seed(5)))
