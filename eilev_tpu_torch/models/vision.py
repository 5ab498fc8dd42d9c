"""EVA-CLIP style vision transformer (counterpart of ``eilev_tpu/models/vision.py``).

Parity target: ``transformers.Blip2VisionModel`` as wrapped by EILeV's
``VideoBlipVisionModel``. The video forward flattens (V, C, T, H, W) into one
batch of V*T frames, runs the frame ViT, and reshapes back. The patch embed is
an unfold followed by one matmul with ``patch_kernel`` (3*p*p, D), the same
math as the stride-p conv. Submodule and parameter names follow the flax
module, so ``models/convert.py`` maps one tree onto the other by rule. With
``config.quantize_matmuls`` (serving mode) qkv/projection/fc1/fc2 are W8A8
int8 layers (``ops/quantization.py``); the MLP's gelu follows the serving
switch of ``ops/gelu.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs import VisionConfig
from ..ops.attention import packed_qkv_self_attention
from ..ops.gelu import gelu
from ..ops.quantization import vision_dense_cls


class VisionEmbeddings(nn.Module):
    def __init__(self, config: VisionConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        p, d = config.patch_size, config.hidden_size
        kw = {"device": device, "dtype": dtype}
        self.patch_kernel = nn.Parameter(torch.empty(3 * p * p, d, **kw))
        self.patch_bias = nn.Parameter(torch.zeros(d, **kw))
        self.class_embedding = nn.Parameter(torch.empty(d, **kw))
        self.position_embedding = nn.Parameter(torch.empty(config.seq_len, d, **kw))
        for param in (self.patch_kernel, self.class_embedding, self.position_embedding):
            nn.init.normal_(param, std=0.02)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values: (B, 3, H, W) -> (B, 1 + num_patches, hidden)."""
        p = self.config.patch_size
        d = self.config.hidden_size
        b, c, h, w = pixel_values.shape
        gh, gw = h // p, w // p
        x = pixel_values.reshape(b, c, gh, p, gw, p)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, c * p * p)
        patches = x.to(self.patch_kernel.dtype) @ self.patch_kernel + self.patch_bias
        cls = self.class_embedding.expand(b, 1, d)
        embeddings = torch.cat([cls, patches], dim=1)
        return embeddings + self.position_embedding[None, : embeddings.shape[1]]


class VisionAttention(nn.Module):
    def __init__(self, config: VisionConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        d = config.hidden_size
        kw = {"device": device, "dtype": dtype}
        dense = vision_dense_cls(config)
        # packed [q | k | v] projection; its bias is (q_bias, 0, v_bias) in HF
        self.qkv = dense(d, 3 * d, bias=config.qkv_bias, **kw)
        self.projection = dense(d, d, **kw)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        hd = cfg.head_dim
        qkv = self.qkv(hidden_states)
        out = packed_qkv_self_attention(qkv, cfg.num_attention_heads, hd, scale=hd**-0.5)
        return self.projection(out)


class VisionMLP(nn.Module):
    def __init__(self, config: VisionConfig, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        dense = vision_dense_cls(config)
        self.fc1 = dense(config.hidden_size, config.intermediate_size, **kw)
        self.fc2 = dense(config.intermediate_size, config.hidden_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class VisionEncoderLayer(nn.Module):
    def __init__(self, config: VisionConfig, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        d, eps = config.hidden_size, config.layer_norm_eps
        self.layer_norm1 = nn.LayerNorm(d, eps=eps, **kw)
        self.self_attn = VisionAttention(config, **kw)
        self.layer_norm2 = nn.LayerNorm(d, eps=eps, **kw)
        self.mlp = VisionMLP(config, **kw)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        x = self.self_attn(self.layer_norm1(hidden_states)) + hidden_states
        return self.mlp(self.layer_norm2(x)) + x


class VisionModel(nn.Module):
    """Single-frame ViT. Returns (last_hidden_state, pooler_output)."""

    def __init__(self, config: VisionConfig, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.embeddings = VisionEmbeddings(config, **kw)
        self.layers = nn.ModuleList(
            VisionEncoderLayer(config, **kw) for _ in range(config.num_hidden_layers)
        )
        self.post_layernorm = nn.LayerNorm(
            config.hidden_size, eps=config.layer_norm_eps, **kw
        )

    def forward(self, pixel_values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.embeddings(pixel_values)
        for layer in self.layers:
            x = layer(x)
        last_hidden_state = self.post_layernorm(x)
        # HF quirk: the pooler applies post_layernorm a second time to the CLS slot
        pooler_output = self.post_layernorm(last_hidden_state[:, 0, :])
        return last_hidden_state, pooler_output


class VideoVisionModel(nn.Module):
    """(V, C, T, H, W) -> last_hidden_state (V, T*S, D), pooler_output (V, T, D)."""

    def __init__(self, config: VisionConfig, *, device=None, dtype=None):
        super().__init__()
        self.vision = VisionModel(config, device=device, dtype=dtype)

    def forward(self, pixel_values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        v, c, t, h, w = pixel_values.shape
        flat = pixel_values.transpose(1, 2).reshape(v * t, c, h, w)
        last_hidden, pooled = self.vision(flat)
        s, d = last_hidden.shape[1], last_hidden.shape[2]
        return last_hidden.reshape(v, t * s, d), pooled.reshape(v, t, d)
