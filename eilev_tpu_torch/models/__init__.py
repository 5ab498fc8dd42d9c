from .convert import params_from_jax
from .opt import OPTForCausalLM, init_cache, opt_position_ids
from .qformer import QFormerModel
from .video_blip import VideoBlipForConditionalGeneration, scatter_video_features
from .vision import VideoVisionModel, VisionModel

__all__ = [
    "OPTForCausalLM",
    "QFormerModel",
    "VideoBlipForConditionalGeneration",
    "VideoVisionModel",
    "VisionModel",
    "init_cache",
    "opt_position_ids",
    "params_from_jax",
    "scatter_video_features",
]
