"""Exact-erf gelu (counterpart of ``eilev_tpu/ops/gelu.py``).

HF's ``ACT2FN["gelu"]``, the activation of Blip2's vision tower and Q-Former.
The JAX package's opt-in tanh serving mode is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf gelu."""
    return F.gelu(x, approximate="none")
