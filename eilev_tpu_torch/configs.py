"""Model configurations for the PyTorch port (a copy of ``eilev_tpu/configs.py``).

These mirror the *semantics* of the HuggingFace ``Blip2Config`` family that the
EILeV models are built from (``eilev/model/v2.py:107-130`` upstream). They are
plain frozen dataclasses; the port keeps them byte-for-byte compatible with the
JAX package's configs so one config drives both. Kept as a copy rather than an
import because importing anything from ``eilev_tpu`` pulls in jax.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class VisionConfig:
    """EVA-CLIP style ViT used as the (frozen) video frame encoder.

    Parity target: ``transformers.Blip2VisionModel``.
    """

    hidden_size: int = 1408
    intermediate_size: int = 6144
    num_hidden_layers: int = 39
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = True
    # "gelu" == exact (erf) gelu in HF's ACT2FN.
    hidden_act: str = "gelu"
    # Opt-in W8A8 serving mode: int8 weights x dynamically-quantized int8
    # activations on the v5e int8 MXU path (394 TOPS, 2x bf16) for the
    # qkv/projection/fc1/fc2 GEMMs. NOT bit-parity — see ops/quantization.py.
    quantize_matmuls: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class QFormerConfig:
    """BERT-style querying transformer with periodic cross-attention.

    Parity target: ``transformers.Blip2QFormerModel`` (query-token-only path,
    which is the only path EILeV exercises - reference ``v2.py:187-196``).
    """

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    cross_attention_frequency: int = 2
    encoder_hidden_size: int = 1408
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    # OPT-IN W8A8 serving mode on the int8 MXU path (like the vision tower's
    # flag): the Q-Former runs prefill-shaped GEMMs only, so every matmul
    # takes the int8 x int8 path. Serving-mode only, NOT bit-parity.
    quantize_matmuls: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class OPTConfig:
    """OPT decoder-only LM. Parity target: ``transformers.OPTForCausalLM``."""

    vocab_size: int = 50272
    hidden_size: int = 2560
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    ffn_dim: int = 10240
    max_position_embeddings: int = 2048
    word_embed_proj_dim: int = 2560
    do_layer_norm_before: bool = True
    activation_function: str = "relu"
    layer_norm_eps: float = 1e-5
    dropout: float = 0.1  # HF OPT default; active during reference training
    # token ids (facebook/opt-*)
    bos_token_id: int = 2
    eos_token_id: int = 2
    pad_token_id: int = 1
    # OPT-IN int8 weight-only serving path (ops/quantization.py); off by
    # default because the north star demands bf16-parity greedy output
    quantize_matmuls: bool = False
    # OPT-IN int8 KV cache (ops/decode_attention.py): halves the decode-step
    # cache stream via a Pallas kernel that dequantizes in VMEM. Serving-mode
    # only, like quantize_matmuls.
    int8_kv_cache: bool = False
    # OPT-IN (with quantize_matmuls): large-M matmuls (the PREFILL) run W8A8
    # on the int8 MXU (2x bf16 peak); the decode step keeps weight-only int8.
    # Static shape dispatch in ops/quantization.py:Int8Dense.
    w8a8_prefill: bool = False
    # OPT-IN per-layer rematerialization of the no-cache (training) forward:
    # store only layer-boundary activations and recompute layer internals in
    # the backward pass. Gradients flow THROUGH the frozen LM to the scattered
    # video features (train_state.py), so without remat every layer's
    # attention/MLP intermediates are saved for backward — the memory wall
    # that pins the reference to per-device micro-batch 1
    # (upstream README.md:152-153). Generation paths (cache != None)
    # are unaffected.
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class LlamaConfig:
    """LLaMA-family decoder-only LM (RoPE + RMSNorm + SwiGLU).

    Parity target: ``transformers.LlamaForCausalLM``. Role: the reference's
    sentence-ification utilities run Llama-2-chat
    (upstream scripts/ego4d/generate_std_sent.py:24-45,
    scripts/epic-kitchens/transform_to_full_sent.py:16-36, and the two
    baselines' *_generate_full_sent.py); this config drives the same recipes
    from local checkpoints through :class:`generation.text_lm.TextLM`.
    """

    vocab_size: int = 32000
    hidden_size: int = 4096
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32  # < heads = grouped-query attention
    intermediate_size: int = 11008
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dropout: float = 0.0
    # token ids (meta-llama/Llama-2-*)
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: int = 0
    # OPT-IN int8 weight-only serving path (ops/quantization.py)
    quantize_matmuls: bool = False
    # OPT-IN int8 KV cache via the Pallas VMEM-dequant decode kernel
    # (ops/decode_attention.py, GQA-aware); serving mode like quantize_matmuls
    int8_kv_cache: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class T5Config:
    """T5 encoder-decoder LM. Parity target: ``transformers.T5ForConditionalGeneration``
    (flan-t5 flavor: gated-gelu FFN, untied LM head)."""

    vocab_size: int = 32128
    d_model: int = 2048
    d_kv: int = 64
    d_ff: int = 5120
    num_layers: int = 24
    num_decoder_layers: int = 24
    num_heads: int = 32
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    dropout_rate: float = 0.1  # HF T5 default; active during reference training
    # "gated-gelu" -> gelu_new (tanh approximation) on the gate branch.
    is_gated_act: bool = True
    dense_act_fn: str = "gelu_new"
    tie_word_embeddings: bool = False
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0
    # OPT-IN per-layer remat of the no-cache (training) forward; see
    # OPTConfig.remat. Covers both the encoder and the decoder trunks.
    remat: bool = False

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv


@dataclass(frozen=True)
class VideoBlipConfig:
    """Top-level config composing the three towers.

    Parity target: ``Blip2Config`` as used by
    ``VideoBlipForConditionalGeneration`` (reference ``eilev/model/v2.py:106-130``).
    ``text_config`` is either an :class:`OPTConfig` (decoder-only) or a
    :class:`T5Config` (seq2seq).
    """

    vision_config: VisionConfig = VisionConfig()
    qformer_config: QFormerConfig = QFormerConfig()
    text_config: Any = OPTConfig()
    num_query_tokens: int = 32

    @property
    def use_decoder_only_language_model(self) -> bool:
        return not isinstance(self.text_config, T5Config)

    @property
    def text_hidden_size(self) -> int:
        if isinstance(self.text_config, OPTConfig):
            return self.text_config.word_embed_proj_dim
        if isinstance(self.text_config, LlamaConfig):
            return self.text_config.hidden_size
        return self.text_config.d_model


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------


def blip2_opt_2_7b() -> VideoBlipConfig:
    """eilev-blip2-opt-2.7b / kpyu/video-blip-opt-2.7b-ego4d geometry."""
    return VideoBlipConfig(
        vision_config=VisionConfig(),
        qformer_config=QFormerConfig(),
        text_config=OPTConfig(),
        num_query_tokens=32,
    )


def blip2_flan_t5_xl() -> VideoBlipConfig:
    """eilev-blip2-flan-t5-xl / kpyu/video-blip-flan-t5-xl-ego4d geometry."""
    return VideoBlipConfig(
        vision_config=VisionConfig(),
        qformer_config=QFormerConfig(),
        text_config=T5Config(),
        num_query_tokens=32,
    )


def tiny_config(
    *,
    text_model: str = "opt",
    hidden: int = 16,
    heads: int = 2,
    layers: int = 2,
    image_size: int = 16,
    patch_size: int = 8,
    vocab_size: int = 64,
    num_query_tokens: int = 4,
) -> VideoBlipConfig:
    """Tiny random-weight geometry for unit tests, mirroring the reference test
    strategy (reference ``tests/model/test_model_v2.py:95-147``)."""
    if text_model == "opt":
        text: Any = OPTConfig(
            vocab_size=vocab_size,
            hidden_size=hidden,
            num_hidden_layers=layers,
            num_attention_heads=heads,
            ffn_dim=hidden * 2,
            max_position_embeddings=128,
            word_embed_proj_dim=hidden,
        )
    elif text_model == "t5":
        text = T5Config(
            vocab_size=vocab_size,
            d_model=hidden,
            d_kv=hidden // heads,
            d_ff=hidden * 2,
            num_layers=layers,
            num_decoder_layers=layers,
            num_heads=heads,
        )
    else:
        raise ValueError(text_model)
    return VideoBlipConfig(
        vision_config=VisionConfig(
            hidden_size=hidden,
            intermediate_size=hidden * 2,
            num_hidden_layers=layers,
            num_attention_heads=heads,
            image_size=image_size,
            patch_size=patch_size,
        ),
        qformer_config=QFormerConfig(
            hidden_size=hidden,
            num_hidden_layers=layers,
            num_attention_heads=heads,
            intermediate_size=hidden * 2,
            cross_attention_frequency=1,
            encoder_hidden_size=hidden,
        ),
        text_config=text,
        num_query_tokens=num_query_tokens,
    )


def replace(cfg, **kwargs):
    """dataclasses.replace that works through our frozen configs."""
    return dataclasses.replace(cfg, **kwargs)
