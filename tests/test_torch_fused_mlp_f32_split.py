"""The numerics of K6's fp32 body, held on the CPU.

``csrc/fused_mlp.cu`` runs both products of its fp32 body (fc1 and fc2) on
the tensor cores as 3xTF32: every operand x is split into hi = tf32_rna(x)
and lo = tf32_rna(x - hi) (``cvt.rna.tf32.f32``), and a b = lo_a hi_b + hi_a
lo_b + hi_a hi_b with fp32 sums in k steps of 8 (one mma.sync m16n8k8 each);
lo lo is dropped. This file emulates those products in torch (the rounding
by bit arithmetic on the fp32 pattern, ``tests/_torch_port.tf32_rna``)
through the K6 chain: LayerNorm in fp32, fc1 + b1 and exact-erf gelu, fc2 +
b2. It holds the result to the plain twin ``ln_mlp_reference`` evaluated in
fp64, at the bar the card holds the kernel to (atol = rtol = 1e-4,
``F32_TOL`` of ``chip_smoke.py``). A single TF32 product (hi x hi) must miss
the same bar, so the test tells the two designs apart.

The products run at their real depths, K = 1408 (fc1) and 6144 (fc2), the
ViT MLP's; M is cut to 64 rows. Inputs come from numpy with a seed at the
unit-scale activations of ``chip_smoke.py``'s K6 phase: x N(0, 1),
LayerNorm scale 1 + N(0, 0.1), weights N(0, 1 / fan_in), biases N(0, 0.1).
"""

import numpy as np
import pytest
import torch

from eilev_tpu_torch.ops import fused_mlp as tfm

from ._torch_port import tf32_product

TOL = 1e-4
ROWS, D, F = 64, 1408, 6144
EPS = 1e-6


def _inputs(seed: int = 12) -> list[torch.Tensor]:
    rng = np.random.default_rng(seed)

    def rand(*shape, std=1.0, mean=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * std + mean).astype(np.float32))

    return [rand(ROWS, D), rand(D, std=0.1, mean=1.0), rand(D, std=0.1), rand(D, F, std=D**-0.5),
            rand(F, std=0.1), rand(F, D, std=F**-0.5), rand(D, std=0.1)]


def emulated_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, *, passes: int) -> torch.Tensor:
    """The fp32 body's arithmetic: LayerNorm in fp32 (two passes, as the
    kernel's one-warp-a-row launch), then both products as 3xTF32 (passes
    3) or one TF32 product (passes 1), bias and erf gelu in fp32."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    h = (x - mu) * torch.rsqrt(var + EPS) * ln_scale + ln_bias
    act = torch.nn.functional.gelu(tf32_product(h, w1, passes) + b1)
    return tf32_product(act, w2, passes) + b2


@pytest.fixture(scope="module")
def case():
    args = _inputs()
    ref64 = tfm.ln_mlp_reference(*(a.double() for a in [args[0][None], *args[1:]]), eps=EPS)[0]
    twin = tfm.ln_mlp_reference(args[0][None], *args[1:], eps=EPS)[0]
    return args, ref64, twin


def test_twin_runs_in_fp64_for_fp64_inputs(case):
    """The yardstick: fp64 inputs keep fp64 through the twin, and its fp32
    evaluation sits within fp32's own rounding of it (far under the bar)."""
    _, ref64, twin = case
    assert ref64.dtype == torch.float64 and twin.dtype == torch.float32
    assert (twin.double() - ref64).abs().max().item() < TOL / 10


def test_3xtf32_products_hold_the_fp32_bar(case):
    """3xTF32 through LayerNorm -> fc1 -> gelu -> fc2 stays within 1e-4 of
    the fp64 twin, and within a tenth of that (7.3e-6 at these inputs,
    against the plain fp32 twin's 1.5e-6: its running fp32 sum takes three
    roundings a k step of 8, over 6,144 terms)."""
    args, ref64, _ = case
    out = emulated_ln_mlp(*args, passes=3)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.double(), ref64, atol=TOL, rtol=TOL)
    assert (out.double() - ref64).abs().max().item() < TOL / 10


def test_one_tf32_product_misses_the_bar(case):
    """One TF32 product a k step, even rounded to nearest, misses the same
    bar (1.5e-3 at these inputs, ~15x): the test tells 3xTF32 from
    single-pass TF32."""
    args, ref64, _ = case
    out = emulated_ln_mlp(*args, passes=1)
    assert not torch.allclose(out.double(), ref64, atol=TOL, rtol=TOL)
    assert (out.double() - ref64).abs().max().item() > 3 * TOL
