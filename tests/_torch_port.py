"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

The JAX package is the reference: a flax module is initialised for its
parameter shapes, every leaf is refilled from a numpy generator, and the same
numpy tree is carried into the port with ``flax_to_state_dict``.
"""

import jax
import numpy as np
import torch

from eilev_tpu_torch.models.convert import flax_to_state_dict


def random_params(flax_module, seed, *init_args, std=0.2, **init_kwargs):
    """Flax params of ``flax_module`` with every leaf drawn from numpy: LayerNorm
    scales 1 + N(0, 0.1), everything else N(0, std)."""
    shapes = jax.eval_shape(
        lambda: flax_module.init(jax.random.PRNGKey(0), *init_args, **init_kwargs)
    )["params"]
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, leaf in flat:
        name = getattr(path[-1], "key", None)
        noise = rng.normal(size=leaf.shape).astype(np.float32)
        leaves.append(1.0 + 0.1 * noise if name == "scale" else std * noise)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def load_port(module, params):
    """Load a numpy flax tree into a port module (strict), freeze it and put
    it in eval mode: with no parameter requiring grad, an inference call
    reaches the kernel wrappers, which have no backward, without a graph."""
    module.load_state_dict(flax_to_state_dict(params), strict=True)
    return module.requires_grad_(False).eval()


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> tf32 (10 explicit mantissa bits), to nearest, ties away from
    zero (``cvt.rna.tf32.f32``): add half of the dropped 13 bits to the
    magnitude and clear them (the sign bit is apart; a carry into the
    exponent rounds up a binade)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo, each a tf32 rounded to nearest: the 3xTF32 operands."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def tf32_product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a (..., m, k) @ b (..., k, n) in fp32 as the tensor cores compute it:
    k steps of 8, each adding (passes 3) lo_a hi_b, hi_a lo_b, then hi_a hi_b
    to an fp32 accumulator, or (passes 1) hi_a hi_b only. Each product of two
    tf32 values is exact in fp32."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    c = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        if passes == 3:
            c = c + a_lo[..., ks] @ b_hi[..., ks, :]
            c = c + a_hi[..., ks] @ b_lo[..., ks, :]
        c = c + a_hi[..., ks] @ b_hi[..., ks, :]
    return c
