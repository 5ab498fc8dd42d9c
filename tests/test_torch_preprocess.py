"""Port vs JAX: the eval preprocessing path (ops/preprocess.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu.ops import preprocess as jpp
from eilev_tpu_torch.ops import preprocess as tpp


@pytest.mark.parametrize("t,n", [(10, 4), (8, 8), (7, 3), (16, 8), (5, 1)])
def test_uniform_temporal_subsample_indices(t, n):
    v = np.arange(t, dtype=np.uint8).reshape(1, t, 1, 1)
    ref = np.asarray(jpp.uniform_temporal_subsample(jnp.asarray(v), n))
    ours = tpp.uniform_temporal_subsample(torch.from_numpy(v), n).numpy()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize(
    "shape,num_frames,size",
    [
        ((2, 3, 4, 16, 16), 2, (16, 16)),  # no resize
        ((2, 3, 5, 20, 24), 3, (16, 16)),  # antialiased downscale
        ((1, 3, 2, 12, 10), None, (16, 14)),  # upscale
    ],
)
def test_process_videos_matches_jax(shape, num_frames, size):
    frames = np.random.default_rng(0).integers(0, 256, size=shape, dtype=np.uint8)
    ref = np.asarray(
        jpp.process_videos(jnp.asarray(frames), num_frames=num_frames, height=size[0], width=size[1])
    )
    ours = tpp.process_videos(
        torch.from_numpy(frames), num_frames=num_frames, height=size[0], width=size[1]
    )
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=0)


def test_process_videos_bf16_output():
    frames = np.random.default_rng(1).integers(0, 256, size=(1, 3, 2, 8, 8), dtype=np.uint8)
    out = tpp.process_videos(torch.from_numpy(frames), height=8, width=8, dtype=torch.bfloat16)
    ref = jpp.process_videos(jnp.asarray(frames), height=8, width=8, dtype=jnp.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))
