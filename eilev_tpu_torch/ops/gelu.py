"""Gelu and its serving switch (counterpart of ``eilev_tpu/ops/gelu.py``).

The default is HF's exact-erf ``ACT2FN["gelu"]``, the activation of Blip2's
vision tower. The opt-in "fast" serving mode is the tanh approximation; like
the int8 modes (``ops/quantization.py``) it is never a default. As in the JAX
package the switch is process-wide: :func:`gelu` reads it at each call, so
set it before a run, and set it back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_IMPL = "exact"


def set_gelu_impl(impl: str) -> None:
    """'exact' (default, HF parity) | 'fast' (tanh, serving mode)."""
    global _IMPL
    if impl not in ("exact", "fast"):
        raise ValueError(f"gelu impl must be 'exact' or 'fast', got {impl!r}")
    _IMPL = impl


def get_gelu_impl() -> str:
    return _IMPL


def gelu_fast(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximation gelu."""
    return F.gelu(x, approximate="tanh")


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf gelu, or the fast serving variant when opted in."""
    if _IMPL == "fast":
        return gelu_fast(x)
    return F.gelu(x, approximate="none")
