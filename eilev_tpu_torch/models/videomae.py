"""VideoMAE video classifier: the original EILeV's supervised baseline
(counterpart of ``eilev_tpu/models/videomae.py``).

Parity target: ``transformers.VideoMAEForVideoClassification`` as the
original's baselines/videomae/videomae_train.py (fine-tuned verb / noun
classifiers) and videomae_predict.py use it.

Structure: tubelet (2x16x16) patch embedding -> FIXED sinusoid position table ->
pre-LN ViT blocks whose q/v projections carry separate bias vectors with a zero
key bias (BEiT-style) -> mean pooling -> fc_norm -> linear classifier.

Input convention: (B, C, T, H, W), like the rest of the port (HF VideoMAE
takes (B, T, C, H, W)). The module names are the flax module's, so
``models/convert.flax_to_state_dict`` maps a flax tree onto it and
``state_dict_to_flax`` back. ``dtype`` is the compute dtype, as flax's: the
parameters stay fp32 and every layer casts them to it at use
(``models/mixed_precision.py``). The attention goes through
``ops/attention.dot_product_attention``, so under ``flash`` it runs kernel K5
(bidirectional, no mask, no bias, head dim 64) and under ``auto`` it stays
plain at 1,568 tokens, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .mixed_precision import MixedLayerNorm, MixedLinear


@dataclass(frozen=True)
class VideoMAEConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    num_frames: int = 16
    tubelet_size: int = 2
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12
    qkv_bias: bool = True
    use_mean_pooling: bool = True
    num_labels: int = 2

    @property
    def num_patches(self) -> int:
        return (
            (self.image_size // self.patch_size) ** 2 * (self.num_frames // self.tubelet_size)
        )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def sinusoid_position_table(n_position: int, d_hid: int) -> np.ndarray:
    """HF's get_sinusoid_encoding_table (fixed, not learned)."""
    pos = np.arange(n_position)[:, None]
    dim = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


class VideoMAEAttention(nn.Module):
    def __init__(self, config: VideoMAEConfig, *, device=None):
        super().__init__()
        self.config = config
        d = config.hidden_size
        # BEiT-style: no-bias projections + separate q/v bias params, zero k bias
        self.query = MixedLinear(d, d, bias=False, device=device)
        self.key = MixedLinear(d, d, bias=False, device=device)
        self.value = MixedLinear(d, d, bias=False, device=device)
        if config.qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(d, device=device))
            self.v_bias = nn.Parameter(torch.zeros(d, device=device))
        self.output = MixedLinear(d, d, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, s, d = x.shape
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        q, k, v = self.query(x), self.key(x), self.value(x)
        if cfg.qkv_bias:
            q = q + self.q_bias.to(x.dtype)
            v = v + self.v_bias.to(x.dtype)
        # each (B, S, D) projection is its own contiguous tensor, so the
        # (B, S, H, hd) views have packed (heads, hd) rows, as K5 reads them
        out = dot_product_attention(
            q.reshape(b, s, nh, hd), k.reshape(b, s, nh, hd), v.reshape(b, s, nh, hd), scale=hd**-0.5,
        ).reshape(b, s, d)
        return self.output(out)


class VideoMAELayer(nn.Module):
    def __init__(self, config: VideoMAEConfig, *, device=None):
        super().__init__()
        d, eps = config.hidden_size, config.layer_norm_eps
        self.layernorm_before = MixedLayerNorm(d, eps=eps, device=device)
        self.attention = VideoMAEAttention(config, device=device)
        self.layernorm_after = MixedLayerNorm(d, eps=eps, device=device)
        self.intermediate = MixedLinear(d, config.intermediate_size, device=device)
        self.output = MixedLinear(config.intermediate_size, d, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.layernorm_before(x))
        h = self.output(F.gelu(self.intermediate(self.layernorm_after(x))))
        return x + h


class VideoMAEForVideoClassification(nn.Module):
    """The classifier. It builds on the card unless the caller passes
    ``device="cpu"``; its parameters are fp32, ``dtype`` is the compute dtype."""

    def __init__(self, config: VideoMAEConfig, *, device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        c, ts, p, d = config.num_channels, config.tubelet_size, config.patch_size, config.hidden_size
        # tubelet conv == unfold (ts, p, p) bricks + one matmul; HF kernel
        # layout (D, C, ts, p, p), feature order here (c, dt, dh, dw)
        self.patch_kernel = nn.Parameter(torch.empty(c * ts * p * p, d, device=device))
        self.patch_bias = nn.Parameter(torch.zeros(d, device=device))
        self.layers = nn.ModuleList(VideoMAELayer(config, device=device) for _ in range(config.num_hidden_layers))
        if config.use_mean_pooling:
            self.fc_norm = MixedLayerNorm(d, eps=1e-5, device=device)
        else:
            self.layernorm = MixedLayerNorm(d, eps=config.layer_norm_eps, device=device)
        self.classifier = MixedLinear(d, config.num_labels, device=device)
        self._positions: dict = {}  # (device, dtype) -> the fixed table, made once
        if self.patch_kernel.device.type != "meta":
            self.init_weights_(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> "VideoMAEForVideoClassification":
        """The flax module's initializers, drawn on the CPU from ``generator``:
        Dense kernels lecun_normal (a normal truncated at 2 sigma, variance
        1 / fan_in), ``patch_kernel`` N(0, 0.02), LayerNorm scales 1, every
        bias 0."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                fan_in = mod.weight.shape[1]
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978  # flax's truncation correction
                w = torch.empty(mod.weight.shape)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
                mod.weight.copy_(w)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
        for name, param in self.named_parameters():
            if name.endswith("bias"):
                param.zero_()
        self.patch_kernel.copy_(torch.randn(self.patch_kernel.shape, generator=generator) * 0.02)
        return self

    def position_table(self, n: int, like: torch.Tensor) -> torch.Tensor:
        key = (like.device, like.dtype)
        if key not in self._positions:
            table = sinusoid_position_table(self.config.num_patches, self.config.hidden_size)
            self._positions[key] = torch.from_numpy(table).to(like.device, like.dtype)
        return self._positions[key][:n]

    def forward(self, pixel_values: torch.Tensor, labels: Optional[torch.Tensor] = None) -> dict:
        """pixel_values: (B, C, T, H, W) -> {'logits', 'loss'?}."""
        cfg = self.config
        b, c, t, h, w = pixel_values.shape
        p, ts = cfg.patch_size, cfg.tubelet_size
        gt, gh, gw = t // ts, h // p, w // p
        x = pixel_values.reshape(b, c, gt, ts, gh, p, gw, p)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, gt * gh * gw, c * ts * p * p)
        dt = self.dtype
        x = x.to(dt) @ self.patch_kernel.to(dt) + self.patch_bias.to(dt)
        x = x + self.position_table(x.shape[1], x)[None]

        for layer in self.layers:
            x = layer(x)

        if cfg.use_mean_pooling:
            pooled = self.fc_norm(x.mean(dim=1))
        else:
            pooled = self.layernorm(x)[:, 0]
        logits = self.classifier(pooled)
        out = {"logits": logits}
        if labels is not None:
            logp = torch.log_softmax(logits.float(), dim=-1)
            out["loss"] = -logp.gather(-1, labels.long()[:, None]).mean()
        return out


def convert_videomae(state_dict: Mapping[str, torch.Tensor], config: VideoMAEConfig) -> dict[str, torch.Tensor]:
    """HF VideoMAEForVideoClassification state dict -> the port's state dict
    in fp32 (HF's Linear weights are (out, in), as the port's; the patch conv
    (D, C, ts, p, p) becomes (C*ts*p*p, D))."""

    def t(key: str) -> torch.Tensor:
        return state_dict[key].float()

    out: dict[str, torch.Tensor] = {}

    def copy(ours: str, theirs: str, bias: bool = True) -> None:
        out[f"{ours}.weight"] = t(f"{theirs}.weight")
        if bias and f"{theirs}.bias" in state_dict:
            out[f"{ours}.bias"] = t(f"{theirs}.bias")

    proj = t("videomae.embeddings.patch_embeddings.projection.weight")
    out["patch_kernel"] = proj.permute(1, 2, 3, 4, 0).reshape(-1, proj.shape[0]).contiguous()
    out["patch_bias"] = t("videomae.embeddings.patch_embeddings.projection.bias")
    copy("classifier", "classifier")
    if config.use_mean_pooling:
        copy("fc_norm", "fc_norm")
    else:
        copy("layernorm", "videomae.layernorm")
    for i in range(config.num_hidden_layers):
        base, ours = f"videomae.encoder.layer.{i}", f"layers.{i}"
        copy(f"{ours}.layernorm_before", f"{base}.layernorm_before")
        copy(f"{ours}.layernorm_after", f"{base}.layernorm_after")
        for name in ("query", "key", "value"):
            copy(f"{ours}.attention.{name}", f"{base}.attention.attention.{name}", bias=False)
        copy(f"{ours}.attention.output", f"{base}.attention.output.dense")
        copy(f"{ours}.intermediate", f"{base}.intermediate.dense")
        copy(f"{ours}.output", f"{base}.output.dense")
        if config.qkv_bias:
            out[f"{ours}.attention.q_bias"] = t(f"{base}.attention.attention.q_bias")
            out[f"{ours}.attention.v_bias"] = t(f"{base}.attention.attention.v_bias")
    return out
