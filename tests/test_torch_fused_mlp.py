"""Port vs JAX: the plain twin of kernel K6 (ops/fused_mlp.py).

``ln_mlp_reference`` is held against both JAX forms of ``ln_mlp`` (the Pallas
kernel in interpret mode and its XLA fallback) and against the flax
LayerNorm -> Dense -> gelu -> Dense module, on the inputs of
tests/models/test_fused_mlp.py, made with numpy. Tolerances: fp32 atol = rtol
= 2e-5 (the JAX test's bar; the Pallas body's erf is a polynomial good to
1.5e-7), bf16 atol = rtol = 2e-2 (one bf16 ulp of the rounded h or activation
moves an output by under 1%).
"""

import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu.ops import fused_mlp as jfm
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.models.vision import VisionEncoderLayer
from eilev_tpu_torch.ops import fused_mlp as tfm

from ._torch_port import to_np

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(atol=2e-5, rtol=2e-5) if dtype == "fp32" else dict(atol=2e-2, rtol=2e-2)


def _inputs(dtype, B=4, S=16, D=32, F=64, seed=0):
    """tests/models/test_fused_mlp.py's inputs, for both packages."""
    rng = np.random.default_rng(seed)
    arrays = [
        rng.normal(size=(B, S, D)),
        rng.normal(size=(D,)),
        rng.normal(size=(D,)) * 0.1,
        rng.normal(size=(D, F)) * 0.1,
        rng.normal(size=(F,)) * 0.1,
        rng.normal(size=(F, D)) * 0.1,
        rng.normal(size=(D,)) * 0.1,
    ]
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a.astype(np.float32)).to(td) for a in arrays])


@pytest.mark.parametrize("form", ["interpret", "xla"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("batch", [4, 3])
def test_k6_plain_matches_jax(batch, dtype, form):
    jargs, targs = _inputs(dtype, B=batch)
    if form == "interpret":
        ref = jfm.ln_mlp(*jargs, eps=1e-6, interpret=True)
    else:
        ref = jfm._xla_fallback(*jargs, eps=1e-6)
    ours = tfm.ln_mlp_reference(*targs, eps=1e-6)
    assert ours.dtype == targs[0].dtype and tuple(ours.shape) == tuple(targs[0].shape)
    np.testing.assert_allclose(to_np(ours), to_np(ref), **_tol(dtype))


def test_k6_plain_matches_flax_module():
    jargs, targs = _inputs("fp32")
    x, ln_s, ln_b, w1, b1, w2, b2 = jargs
    d, f = w1.shape

    class M(nn.Module):
        @nn.compact
        def __call__(self, x):
            h = nn.LayerNorm(use_fast_variance=False, epsilon=1e-6)(x)
            h = nn.Dense(f, name="fc1")(h)
            h = nn.gelu(h, approximate=False)
            return nn.Dense(d, name="fc2")(h)

    params = {
        "LayerNorm_0": {"scale": ln_s, "bias": ln_b},
        "fc1": {"kernel": w1, "bias": b1},
        "fc2": {"kernel": w2, "bias": b2},
    }
    ref = M().apply({"params": params}, x)
    np.testing.assert_allclose(to_np(tfm.ln_mlp_reference(*targs)), to_np(ref), **_tol("fp32"))


def test_vit_layer_weights_map_onto_k6():
    """A port ViT layer's LayerNorm and MLP weights, mapped into the twin as
    (ln scale, ln bias, fc1.weight.T, fc1.bias, fc2.weight.T, fc2.bias), give
    the layer's own MLP branch: the weight layout the card run uses."""
    cfg = tconfigs.tiny_config().vision_config
    torch.manual_seed(0)
    layer = VisionEncoderLayer(cfg).eval()
    with torch.no_grad():
        for param in layer.parameters():
            param.normal_(0.0, 0.2)
    x = torch.from_numpy(
        np.random.default_rng(1).normal(size=(3, cfg.seq_len, cfg.hidden_size)).astype(np.float32))
    ln, mlp = layer.layer_norm2, layer.mlp
    with torch.no_grad():
        want = mlp(ln(x))
        got = tfm.ln_mlp(x, ln.weight, ln.bias, mlp.fc1.weight.T, mlp.fc1.bias, mlp.fc2.weight.T,
                         mlp.fc2.bias, eps=ln.eps)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-5, rtol=0)


def test_k6_wrapper_runs_the_twin_on_cpu():
    _, targs = _inputs("bf16")
    before = tfm.ln_mlp.launches
    out = tfm.ln_mlp(*targs)
    assert tfm.ln_mlp.launches == before
    assert torch.equal(out, tfm.ln_mlp_reference(*targs))


def test_k6_cuda_check_takes_bf16_or_fp32():
    """What the CUDA wrapper accepts, read on CPU tensors (no launch): x and
    both weights all bf16 (16-byte rows: D, F multiples of 8) or all fp32
    (any D, F); fp16 or mixed dtypes raise."""
    def args(d, f, dtype):
        return (torch.zeros(2, 3, d, dtype=dtype), torch.ones(d), torch.zeros(d), torch.zeros(d, f, dtype=dtype),
                torch.zeros(f), torch.zeros(f, d, dtype=dtype), torch.zeros(d))
    tfm._check(*args(32, 64, torch.bfloat16))
    tfm._check(*args(36, 60, torch.float32))
    with pytest.raises(ValueError, match="% 8"):
        tfm._check(*args(36, 64, torch.bfloat16))
    with pytest.raises(TypeError, match="all bf16 or all fp32"):
        tfm._check(*args(32, 64, torch.float16))
    mixed = list(args(32, 64, torch.float32))
    mixed[3] = mixed[3].bfloat16()
    with pytest.raises(TypeError, match="all bf16 or all fp32"):
        tfm._check(*mixed)


def test_k6_cuda_check_rows_limit():
    """The rows limit of the CUDA kernels (persistent grids: only the int32
    row indices and TMA coordinates bound M), read on meta tensors."""
    def args(rows):
        return (torch.empty(1, rows, 8, device="meta"), torch.empty(8, device="meta"), torch.empty(8, device="meta"),
                torch.empty(8, 16, device="meta"), torch.empty(16, device="meta"), torch.empty(16, 8, device="meta"),
                torch.empty(8, device="meta"))
    assert tfm._MAX_ROWS == 2**31 - 512
    tfm._check(*args(tfm._MAX_ROWS))
    with pytest.raises(ValueError, match="at most"):
        tfm._check(*args(tfm._MAX_ROWS + 1))
