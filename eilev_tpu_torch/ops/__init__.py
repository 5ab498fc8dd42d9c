from .attention import (
    dot_product_attention,
    get_default_attention_impl,
    make_causal_bias,
    mask_to_bias,
    packed_qkv_self_attention,
    plain_attention,
    set_default_attention_impl,
)
from .fused_attention import packed_qkv_attention, packed_qkv_causal_attention

__all__ = [
    "dot_product_attention",
    "get_default_attention_impl",
    "make_causal_bias",
    "mask_to_bias",
    "packed_qkv_attention",
    "packed_qkv_causal_attention",
    "packed_qkv_self_attention",
    "plain_attention",
    "set_default_attention_impl",
]
