from .classify import classify
from .config import GenerationConfig, generation_config_from_json
from .decoding import generate
from .text_lm import TextLM

__all__ = ["GenerationConfig", "TextLM", "classify", "generation_config_from_json", "generate"]
