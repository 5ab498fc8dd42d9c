from .config import GenerationConfig, generation_config_from_json
from .decoding import generate

__all__ = ["GenerationConfig", "generation_config_from_json", "generate"]
