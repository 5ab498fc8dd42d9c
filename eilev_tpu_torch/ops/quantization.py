"""int8 serving modes of the matmuls (counterpart of ``eilev_tpu/ops/quantization.py``).

- :class:`Int8Dense`: int8 weights with per-output-channel fp32 scales
  against model-dtype activations (weight-only), for the LM's projection and
  FFN matmuls. With ``w8a8_min_rows`` (the ``w8a8_prefill`` mode) a call with
  at least that many rows, the LM prefill, also quantizes its activations
  per row and runs int8 x int8 -> int32.
- :class:`Int8W8A8Dense`: always int8 x int8 -> int32, for the vision tower
  and the Q-Former.

Neither is bit-parity with bf16; both are opt-in serving modes. The rounding
points are the JAX modules': the fp32 (or int32) accumulator is scaled in
fp32, *then* cast to the model dtype, *then* the bias is added in the model
dtype.

These are matrix products that the JAX package leaves to XLA, outside any
Pallas kernel, so they are plain PyTorch here: ``torch._int_mm`` for int8 x
int8, and for weight-only an fp32-accumulating product of exact products
(``torch.mm(..., out_dtype=torch.float32)`` on bf16 operands on the card,
where int8 -> bf16 is exact; fp32 operands on the CPU).

Under tensor parallelism (``parallel/tensor.py``) a column-parallel or
packed layer holds whole output columns, so its per-channel scales are the
unsharded ones and it needs no collective. A row-parallel layer (built with
``tp``, or quantized from a ``RowParallelLinear``) holds a slice of the
input dimension: its weight scale is the all_reduce MAX of the local
per-channel absmax over the model group, W8A8's per-row activation absmax is
the all_reduce MAX of the local one, the int8 x int8 partial product is
summed in int32 (a float sum would round: K x 127^2 passes 2^24), and the
whole bias is added once after the sum, so each rank's ``w8``/``scale`` is
its slice of the unsharded quantization and a W8A8 product equals the
unsharded accumulator bit for bit. The weight-only product's fp32 partial
sums are summed in fp32, as ``RowParallelLinear`` sums its products. A MAX
has no gradient; these are serving modes.

Layouts: the port keeps ``w8`` as (out, in), like ``nn.Linear.weight``;
``models/convert.py`` transposes the flax (in, out) ``w8``. The tree
functions :func:`quantize_lm_params`, :func:`quantize_vision_params` and
:func:`quantize_qformer_params` work on flax-layout trees of numpy arrays, as
``params_from_jax`` takes them. :func:`quantize_model_` quantizes a port
model in place from its own weights.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

# flax/port module names whose matmul gets quantized, per decoder family
OPT_QUANT_NAMES = frozenset({"qkv_proj", "out_proj", "fc1", "fc2"})
LLAMA_QUANT_NAMES = frozenset({"qkv_proj", "o_proj", "gate_proj", "up_proj", "down_proj"})
QUANT_NAMES = OPT_QUANT_NAMES | LLAMA_QUANT_NAMES
# the vision tower: the patch embedding, layer norms and biases stay in model dtype
VISION_QUANT_NAMES = frozenset({"qkv", "projection", "fc1", "fc2"})
# the Q-Former: q/k/v, the attention output dense and the FFN pair; "output"
# also names wrapper modules, which carry no matmul of their own
QFORMER_QUANT_NAMES = frozenset({"query", "key", "value", "dense", "intermediate", "output"})

#: Row threshold of the w8a8_prefill dispatch: decode steps run batch-sized
#: rows, the prefill batch x prompt rows.
W8A8_PREFILL_MIN_ROWS = 64


def quantize_int8(w: torch.Tensor, tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of an (in, out) kernel.

    Returns (w8 int8 (in, out), scale float32 (out,)) with w ~ w8 * scale.
    Under ``tp`` ``w`` is this rank's slice of the input rows (a row-parallel
    kernel) and the absmax is the MAX over the model group: the scale of the
    whole column, and this rank's rows of the whole kernel's ``w8``.
    """
    wf = w.float()
    absmax = wf.abs().amax(dim=0)
    if tp is not None:
        absmax = tp.all_reduce(absmax, dist.ReduceOp.MAX)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    w8 = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return w8, scale


def quantize_act_rows(x: torch.Tensor, tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row dynamic int8 quantization of activations.

    x (..., K) -> (x8 int8 (..., K), scale float32 (..., 1)) with x ~ x8 * scale.
    Under ``tp`` (a row-parallel layer's) ``x`` is this rank's slice of K and
    the row absmax is the MAX over the model group, the unsharded row's.
    """
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    if tp is not None:
        absmax = tp.all_reduce(absmax.detach(), dist.ReduceOp.MAX)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    x8 = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return x8, scale


def _weight_only_f32(x2d: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """x2d (M, K) @ w8 (N, K)^T with exact products accumulated in fp32."""
    if x2d.is_cuda and x2d.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(x2d, w8.t().to(x2d.dtype), out_dtype=torch.float32)
    return x2d.float() @ w8.t().float()


def _w8a8_f32(x2d: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Per-row int8 activations x int8 weights -> int32, dequantized to fp32
    (before the per-channel weight scale)."""
    x8, xs = quantize_act_rows(x2d)
    return torch._int_mm(x8, w8.t()).float() * xs


class _Int8Linear(nn.Module):
    """Shared state of the int8 layers: ``w8`` (out, in) int8 and ``scale``
    (out,) fp32 as buffers, an optional ``bias`` parameter. Constructed like
    ``nn.Linear``; ``dtype`` is the bias's. The output is in the input's
    dtype (the compute dtype), the bias cast to it. With ``tp`` (a
    ``parallel.tensor.TensorParallel``) the layer is row-parallel:
    ``in_features`` is this rank's slice of the input."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 tp=None, device=None, dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.tp = tp
        self.out_dtype = dtype if dtype is not None else torch.get_default_dtype()
        self.register_buffer("w8", torch.zeros(out_features, in_features, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(out_features, dtype=torch.float32, device=device))
        self.bias = (
            nn.Parameter(torch.zeros(out_features, dtype=self.out_dtype, device=device))
            if bias else None
        )

    @classmethod
    def from_linear(cls, linear: nn.Linear) -> "_Int8Linear":
        """Quantize ``linear``'s own weight; its bias is shared, not copied.
        A ``RowParallelLinear`` (one with a ``tp``) gives the row-parallel
        form, its scales from the whole columns (a collective over the model
        group: every rank quantizes its layers in the same order)."""
        w, tp = linear.weight, getattr(linear, "tp", None)
        mod = cls(linear.in_features, linear.out_features, bias=False, tp=tp, device=w.device, dtype=w.dtype)
        with torch.no_grad():
            w8, scale = quantize_int8(w.t(), tp)
            mod.w8.copy_(w8.t())
            mod.scale.copy_(scale)
        mod.bias = linear.bias
        return mod

    def _weight_only(self, x2d: torch.Tensor) -> torch.Tensor:
        """The weight-only product in fp32; a row-parallel layer's partial
        products summed over the model group in fp32."""
        y32 = _weight_only_f32(x2d, self.w8)
        return y32 if self.tp is None else self.tp.all_reduce(y32)

    def _w8a8(self, x2d: torch.Tensor) -> torch.Tensor:
        """The W8A8 product, dequantized to fp32 before the weight scale; a
        row-parallel layer quantizes its rows by their unsharded absmax and
        sums the partial int32 products over the model group first."""
        if self.tp is None:
            return _w8a8_f32(x2d, self.w8)
        x8, xs = quantize_act_rows(x2d, self.tp)
        return self.tp.all_reduce(torch._int_mm(x8, self.w8.t())).float() * xs

    def _finish(self, y32: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        # the output in the input's (the compute) dtype, which is the model
        # dtype unless the float weights were loaded wider than the compute
        y = (y32 * self.scale).to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y.reshape(*x.shape[:-1], self.out_features)

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, bias={self.bias is not None}"


class Int8Dense(_Int8Linear):
    """Drop-in ``nn.Linear`` with int8 weights; weight-only below
    ``w8a8_min_rows`` rows (or always, at 0), W8A8 at or above it."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 w8a8_min_rows: int = 0, tp=None, device=None, dtype=None):
        super().__init__(in_features, out_features, bias, tp=tp, device=device, dtype=dtype)
        self.w8a8_min_rows = w8a8_min_rows

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x2d = x.reshape(-1, x.shape[-1])
        if self.w8a8_min_rows and x2d.shape[0] >= self.w8a8_min_rows:
            return self._finish(self._w8a8(x2d), x)
        return self._finish(self._weight_only(x2d), x)


class Int8W8A8Dense(_Int8Linear):
    """Drop-in ``nn.Linear``: per-row int8 activations x int8 weights -> int32,
    dequantized by (row scale x per-channel weight scale)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._finish(self._w8a8(x.reshape(-1, x.shape[-1])), x)


def dense_cls(config) -> type:
    """``nn.Linear``, or :class:`Int8Dense` when the config opts into quantized
    matmuls (with the W8A8 large-M dispatch when ``w8a8_prefill`` is also set)."""
    if not getattr(config, "quantize_matmuls", False):
        return nn.Linear
    if getattr(config, "w8a8_prefill", False):
        return functools.partial(Int8Dense, w8a8_min_rows=W8A8_PREFILL_MIN_ROWS)
    return Int8Dense


def vision_dense_cls(config) -> type:
    """``nn.Linear``, or :class:`Int8W8A8Dense` when the config opts in."""
    return Int8W8A8Dense if getattr(config, "quantize_matmuls", False) else nn.Linear


# ---------------------------------------------------------------------------
# flax-layout trees of numpy arrays
# ---------------------------------------------------------------------------


def quantize_lm_params(params: Mapping[str, Any], names: Optional[frozenset] = None) -> dict:
    """Every dict node named in ``names`` (default: both decoder families'
    projections) that carries a "kernel" leaf becomes {w8, scale[, bias]};
    everything else passes through. Leaves come back as numpy arrays."""
    if names is None:
        names = QUANT_NAMES

    def walk(node):
        if not isinstance(node, Mapping):
            return node
        out = {}
        for key, val in node.items():
            if key in names and isinstance(val, Mapping) and "kernel" in val:
                kernel = torch.from_numpy(np.asarray(val["kernel"], dtype=np.float32))
                w8, scale = quantize_int8(kernel)
                out[key] = {"w8": w8.numpy(), "scale": scale.numpy()}
                if "bias" in val:
                    out[key]["bias"] = val["bias"]
            else:
                out[key] = walk(val)
        return out

    return walk(params)


def quantize_vision_params(params: Mapping[str, Any]) -> dict:
    """The vision subtree for ``quantize_matmuls`` (qkv/projection/fc1/fc2)."""
    return quantize_lm_params(params, names=VISION_QUANT_NAMES)


def quantize_qformer_params(params: Mapping[str, Any]) -> dict:
    """The Q-Former SUBTREE for ``quantize_matmuls``; its generic BERT names
    would collide elsewhere, so never walk the whole model with them."""
    return quantize_lm_params(params, names=QFORMER_QUANT_NAMES)


# ---------------------------------------------------------------------------
# a port model, in place
# ---------------------------------------------------------------------------


def quantize_linears_(module: nn.Module, names: frozenset, cls=Int8Dense) -> int:
    """Replace, in place, every ``nn.Linear`` (or subclass, such as the
    Q-Former's ``MixedLinear``) under ``module`` whose attribute name is in
    ``names`` by ``cls`` quantized from its own weight; a row-parallel one
    (``parallel.tensor.RowParallelLinear``) by ``cls``'s row-parallel form.
    Returns the number replaced; layers already int8 stay as they are."""
    count = 0
    for parent in list(module.modules()):
        for name, child in list(parent.named_children()):
            if name in names and isinstance(child, nn.Linear):
                setattr(parent, name, cls.from_linear(child))
                count += 1
    return count


def quantize_model_(
    model: nn.Module,
    *,
    int8_lm: bool = False,
    int8_kv: bool = False,
    int8_vision: bool = False,
    int8_qformer: bool = False,
    w8a8_prefill: bool = False,
) -> nn.Module:
    """Put a port ``VideoBlipForConditionalGeneration`` (or the text-only
    ``generation/text_lm._TextOnlyModule``, OPT or LLaMA) into the serving
    modes of ``eilev_tpu.models.auto.load_model``, in place, from its own
    weights. The LM's matmuls are those ``quantize_lm_params`` quantizes by
    default (both decoder families' names).

    The chosen matmuls become int8 layers (their float weights are freed), and
    every submodule's config is replaced by the flagged one, so that
    ``init_cache`` gives an int8 KV cache under ``int8_kv``. On a
    tensor-parallel model each rank quantizes its own slices, the
    row-parallel layers' scales over the model group (every rank of the
    group calls this together), which gives each rank its slice of what
    quantizing the whole model gives.
    """
    if w8a8_prefill and not int8_lm:
        raise ValueError("w8a8_prefill requires int8_lm (shared int8 weights)")
    old = model.config
    text, vision, qformer = old.text_config, old.vision_config, old.qformer_config
    if int8_lm or int8_kv:
        flags = {"quantize_matmuls": text.quantize_matmuls or int8_lm,
                 "int8_kv_cache": text.int8_kv_cache or int8_kv}
        if w8a8_prefill:  # an OPT-only mode: LlamaConfig has no such field
            flags["w8a8_prefill"] = True
        text = dataclasses.replace(text, **flags)
    if int8_vision:
        vision = dataclasses.replace(vision, quantize_matmuls=True)
    if int8_qformer:
        qformer = dataclasses.replace(qformer, quantize_matmuls=True)
    new = dataclasses.replace(old, text_config=text, vision_config=vision, qformer_config=qformer)
    if int8_lm:
        quantize_linears_(model.language_model, QUANT_NAMES, Int8Dense)
    if w8a8_prefill:
        for mod in model.language_model.modules():
            if isinstance(mod, Int8Dense):
                mod.w8a8_min_rows = W8A8_PREFILL_MIN_ROWS
    if int8_vision:
        quantize_linears_(model.vision_model, VISION_QUANT_NAMES, Int8W8A8Dense)
    if int8_qformer:
        quantize_linears_(model.qformer, QFORMER_QUANT_NAMES, Int8W8A8Dense)
    swap = {id(old): new, id(old.text_config): text, id(old.vision_config): vision,
            id(old.qformer_config): qformer}
    for mod in model.modules():
        cfg = getattr(mod, "config", None)
        if cfg is not None and id(cfg) in swap:
            mod.config = swap[id(cfg)]
    return model
