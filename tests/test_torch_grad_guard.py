"""No kernel wrapper has a backward, as no Pallas kernel has one in JAX: each
of K1-K6 raises RuntimeError, naming its plain twin, when grad mode is on and
an input requires grad. The guard fires before the device is looked at, so
the call fails the same way on the CPU (where the wrapper would run its
differentiable twin) and on the card: a meta tensor stands in for the card
here. Under torch.no_grad each wrapper runs; its twin stays differentiable."""

import pytest
import torch

from eilev_tpu_torch.ops import decode_attention as da
from eilev_tpu_torch.ops import flash_attention as fl
from eilev_tpu_torch.ops import fused_attention as fa
from eilev_tpu_torch.ops import fused_mlp as fm

NH, HD, S = 2, 8, 9


def _case(kernel, dev):
    """(wrapper, twin, the inputs that may require grad, call(fn, inputs))."""
    randn = lambda *shape: torch.randn(*shape, device=dev)  # noqa: E731
    mask = torch.ones(2, S, dtype=torch.int32, device=dev)
    if kernel == "K1":
        return fa.packed_qkv_attention, fa.packed_qkv_attention_reference, [randn(2, S, 3 * NH * HD)], \
            lambda fn, t: fn(t[0], NH, HD, scale=HD**-0.5)
    if kernel == "K2":
        return fa.packed_qkv_causal_attention, fa.packed_qkv_causal_attention_reference, \
            [randn(2, S, 3 * NH * HD)], lambda fn, t: fn(t[0], NH, HD, mask, scale=HD**-0.5)
    if kernel == "K3/K4":
        return da.decode_attention_stacked, da.decode_attention_stacked_reference, \
            [randn(2, NH * HD), randn(3, 2, S, NH * HD), randn(3, 2, S, NH * HD)], \
            lambda fn, t: fn(*t, mask, 1, num_heads=NH, head_dim=HD)
    if kernel == "K5":
        return fl.flash_attention, fl.flash_attention_reference, [randn(2, S, NH, HD) for _ in range(3)], \
            lambda fn, t: fn(*t, causal=True)
    d, f = 8, 16
    return fm.ln_mlp, fm.ln_mlp_reference, \
        [randn(2, 3, d), torch.ones(d, device=dev), randn(d), randn(d, f), randn(f), randn(f, d), randn(d)], \
        lambda fn, t: fn(*t)


KERNELS = ["K1", "K2", "K3/K4", "K5", "K6"]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_wrapper_refuses_an_input_that_requires_grad(kernel, device):
    wrapper, twin, inputs, call = _case(kernel, device)
    for i in range(len(inputs)):  # any one input requiring grad is enough
        args = [t.clone().requires_grad_(j == i) for j, t in enumerate(inputs)]
        with pytest.raises(RuntimeError, match=twin.__name__):
            call(wrapper, args)
    if device == "cpu":
        with torch.no_grad():
            out = call(wrapper, [t.clone().requires_grad_() for t in inputs])
        assert torch.equal(out, call(twin, inputs))


@pytest.mark.parametrize("kernel", KERNELS)
def test_twins_stay_differentiable(kernel):
    _, twin, inputs, call = _case(kernel, "cpu")
    x = inputs[0].clone().requires_grad_()
    call(twin, [x, *inputs[1:]]).square().sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0
