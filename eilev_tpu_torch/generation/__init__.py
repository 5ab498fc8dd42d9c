from .classify import classify
from .config import GenerationConfig, generation_config_from_json
from .decoding import generate, generate_stream
from .speculative import (
    build_lookup_corpus,
    make_self_draft,
    prompt_lookup_greedy_decode,
    prompt_lookup_sample_decode,
    speculative_greedy_decode,
)
from .text_lm import TextLM

__all__ = [
    "GenerationConfig",
    "TextLM",
    "build_lookup_corpus",
    "classify",
    "generate",
    "generate_stream",
    "generation_config_from_json",
    "make_self_draft",
    "prompt_lookup_greedy_decode",
    "prompt_lookup_sample_decode",
    "speculative_greedy_decode",
]
