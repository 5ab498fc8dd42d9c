"""Flax parameter tree -> the port's ``state_dict`` (counterpart of
``eilev_tpu/models/convert.py``).

The port's modules carry the flax module names, so the mapping is by rule:

- ``layers_<i>`` -> ``layers.<i>`` (an ``nn.ModuleList``);
- Dense ``kernel`` (in, out) -> ``weight`` (out, in);
- LayerNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``;
- an int8 layer's dict (one that holds ``w8``, from ``quantize_lm_params`` and
  its siblings) -> ``Int8Dense``/``Int8W8A8Dense``: ``w8`` (in, out) is
  transposed and its ``scale`` keeps its name;
- every other leaf (biases, ``patch_kernel``, ``query_tokens``, ...) keeps its
  name and layout.

The input is the flax ``params`` tree as nested dicts of numpy arrays, which is
what ``jax.tree.map(np.asarray, params)`` gives; no jax is needed here. Loading
an HF checkpoint directly is not ported yet.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from ..configs import OPTConfig, VideoBlipConfig

_LAYER = re.compile(r"^layers_(\d+)$")
_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def flax_to_state_dict(tree: Mapping[str, Any], prefix: str = "") -> dict[str, torch.Tensor]:
    """Map any flax sub-tree onto the matching port module's ``state_dict``."""
    out: dict[str, torch.Tensor] = {}
    int8_layer = "w8" in tree
    for name, value in tree.items():
        if isinstance(value, Mapping):
            m = _LAYER.match(name)
            part = f"layers.{m.group(1)}" if m else name
            out.update(flax_to_state_dict(value, f"{prefix}{part}."))
            continue
        arr = np.asarray(value)
        if name in ("kernel", "w8"):
            arr = arr.T
        if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: numpy has no torch bridge for it
            tensor = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            tensor = torch.from_numpy(np.array(arr))  # own, writable copy
        # an int8 layer's per-channel scale is not a LayerNorm scale
        key = name if int8_layer else _LEAF.get(name, name)
        out[prefix + key] = tensor.contiguous()
    return out


def params_from_jax(params: Mapping[str, Any], config: VideoBlipConfig) -> dict[str, torch.Tensor]:
    """The flax ``VideoBlipForConditionalGeneration`` params -> the port's state dict."""
    if not isinstance(config.text_config, OPTConfig):
        raise NotImplementedError("only the OPT language model is ported")
    return flax_to_state_dict(params)
