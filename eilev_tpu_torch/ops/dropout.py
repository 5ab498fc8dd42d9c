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
    first time."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    @classmethod
    def seeded(cls, seed: int, device) -> "DropoutRng":
        return cls(torch.Generator(device=device).manual_seed(seed))

    def keep(self, shape: tuple, rate: float, device: torch.device) -> torch.Tensor:
        u = torch.rand(shape, generator=self.generator, device=device)
        return u < 1.0 - rate

    def get_state(self) -> torch.Tensor:
        return self.generator.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.generator.set_state(state)


def dropout(x: torch.Tensor, rate: float, rng: Optional[MaskSource]) -> torch.Tensor:
    """flax's dropout law with masks from ``rng``; the identity when ``rng`` is
    None or ``rate`` is 0."""
    if rng is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = rng.keep(tuple(x.shape), rate, x.device)
    # x / keep_prob with keep_prob in x's dtype, as JAX's weak-typed division
    scaled = x / torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, scaled, torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: active in training mode with a mask source."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, rng: Optional[MaskSource] = None) -> torch.Tensor:
        return dropout(x, self.rate, rng if self.training else None)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
