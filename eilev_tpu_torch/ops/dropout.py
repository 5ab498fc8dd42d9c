"""Dropout with flax's law and an explicit mask source.

flax's ``nn.Dropout``: ``keep = bernoulli(1 - rate)`` and ``out = where(keep,
x / (1 - rate), 0)``, the division in x's dtype. ``F.dropout`` draws from
PyTorch's global generator, which neither a seeded training step nor a
recomputed (remat) layer can replay, so the port draws its masks from a mask
source passed down the forward, as JAX passes ``rngs={"dropout": key}``:

- :class:`DropoutRng` draws from an explicit ``torch.Generator`` on the
  activations' device;
- anything with the same three methods (``keep``, ``get_state``,
  ``set_state``) serves, e.g. a test's list of fixed masks.

A :class:`Dropout` module applies its rate when it is in training mode
(``module.train()``, PyTorch's idiom for JAX's ``deterministic=False``) and a
mask source is given; in ``eval()`` mode, or with no source, it is the
identity.
"""

from __future__ import annotations

from typing import Optional, Protocol

import torch
from torch import nn


class MaskSource(Protocol):
    def keep(self, shape: tuple, rate: float, device: torch.device) -> torch.Tensor:
        """A bool keep-mask of ``shape``: True with probability 1 - rate."""

    def get_state(self): ...

    def set_state(self, state) -> None: ...


class DropoutRng:
    """Masks from one ``torch.Generator``: ``keep = uniform < 1 - rate``.

    ``get_state``/``set_state`` save and restore the generator's position, so
    a recomputed layer (``models/opt.py``, remat) draws the masks it drew the
    first time.

    Data parallelism: rank ``rank`` of ``world`` processes, each holding an
    equal block of the global batch's rows in rank order, draws the
    uniforms of the GLOBAL rows (``world`` times the leading axis it is
    asked for, from a generator seeded alike on every rank) and keeps its
    own block, as JAX draws one mask over the global batch: the ranks
    together take the masks one device takes over the concatenated batch.
    Every dropout site of the port's models has the batch (or, in the
    Q-Former, the videos) as its leading axis.

    Tensor parallelism: a site whose activation is sharded on the model
    axis asks for the unsharded shape and keeps its rank's block
    (:func:`dropout`'s ``shard``), so every rank of a model group draws
    the same uniforms in the same order, whatever the model axis, and
    every replicated site the same mask."""

    def __init__(self, generator: torch.Generator, rank: int = 0, world: int = 1):
        self.generator = generator
        self.rank, self.world = rank, world

    @classmethod
    def seeded(cls, seed: int, device, rank: int = 0, world: int = 1) -> "DropoutRng":
        return cls(torch.Generator(device=device).manual_seed(seed), rank, world)

    def keep(self, shape: tuple, rate: float, device: torch.device) -> torch.Tensor:
        rows = shape[0]
        u = torch.rand((rows * self.world, *shape[1:]), generator=self.generator, device=device)
        return u.narrow(0, self.rank * rows, rows) < 1.0 - rate

    def get_state(self) -> torch.Tensor:
        return self.generator.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.generator.set_state(state)


def dropout(x: torch.Tensor, rate: float, rng: Optional[MaskSource], shard=None) -> torch.Tensor:
    """flax's dropout law with masks from ``rng``; the identity when ``rng`` is
    None or ``rate`` is 0. ``shard`` = (axis, tp) marks ``x`` as this rank's
    block along ``axis`` of an activation sharded over the model group of
    ``tp`` (a ``parallel.tensor.TensorParallel``, or None): the mask is
    drawn at the unsharded shape and the rank's block of it kept, so it
    is the unsharded model's mask."""
    if rng is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    axis, tp = shard if shard is not None else (0, None)
    if tp is None or tp.size == 1:
        keep = rng.keep(tuple(x.shape), rate, x.device)
    else:
        axis %= x.ndim
        n = x.shape[axis]
        full = (*x.shape[:axis], n * tp.size, *x.shape[axis + 1:])
        keep = rng.keep(full, rate, x.device).narrow(axis, tp.rank * n, n)
    # x / keep_prob with keep_prob in x's dtype, as JAX's weak-typed division
    scaled = x / torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, scaled, torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: active in training mode with a mask source."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, rng: Optional[MaskSource] = None, shard=None) -> torch.Tensor:
        return dropout(x, self.rate, rng if self.training else None, shard)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
