from .config import GenerationConfig, generation_config_from_json
from .decoding import generate
from .text_lm import TextLM

__all__ = ["GenerationConfig", "TextLM", "generation_config_from_json", "generate"]
