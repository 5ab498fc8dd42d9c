"""Layers that compute in their input's dtype, whatever their parameters' dtype.

flax separates a module's compute ``dtype`` from its parameters' dtype: the
training recipe keeps the trainable subtree (query tokens, Q-Former, language
projection) in fp32 master weights inside a bf16 model, and each layer casts
its parameters to bf16 at use. These are that behaviour for ``nn.Linear`` and
``nn.LayerNorm``; gradients flow back through the casts to the fp32
parameters. With parameters of the input's dtype each is exactly its
``torch.nn`` parent.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class MixedLinear(nn.Linear):
    """flax ``Dense(dtype=...)``: weight and bias cast to the input's dtype,
    then the product in that dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class MixedLayerNorm(nn.LayerNorm):
    """flax ``LayerNorm(dtype=...)`` over parameters of another dtype:
    statistics and the affine in fp32, the output in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dtype == x.dtype:
            return super().forward(x)
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps)
        return y.to(x.dtype)
