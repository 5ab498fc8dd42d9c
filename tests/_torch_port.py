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
