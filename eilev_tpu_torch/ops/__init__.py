from .attention import make_causal_bias, mask_to_bias, packed_qkv_self_attention, plain_attention
from .fused_attention import packed_qkv_attention, packed_qkv_causal_attention

__all__ = [
    "packed_qkv_self_attention",
    "make_causal_bias",
    "mask_to_bias",
    "packed_qkv_attention",
    "packed_qkv_causal_attention",
    "plain_attention",
]
