from .convert import params_from_jax
from .llama import LlamaForCausalLM, llama_position_ids
from .opt import OPTForCausalLM, init_cache, opt_position_ids
from .qformer import QFormerModel
from .video_blip import VideoBlipForConditionalGeneration, scatter_video_features
from .vision import VideoVisionModel, VisionModel

__all__ = [
    "LlamaForCausalLM",
    "OPTForCausalLM",
    "QFormerModel",
    "VideoBlipForConditionalGeneration",
    "VideoVisionModel",
    "VisionModel",
    "init_cache",
    "llama_position_ids",
    "opt_position_ids",
    "params_from_jax",
    "scatter_video_features",
]
