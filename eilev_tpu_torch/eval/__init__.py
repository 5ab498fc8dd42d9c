from .icl import (
    IclEvalResult,
    IclEvaluator,
    add_and_filter_verb_noun,
    load_narrated_action_verb_noun,
    load_prompt_map,
)
from .metrics import (
    MulticlassF1,
    bleu,
    generation_metric_suite,
    rouge_l,
)

__all__ = [
    "IclEvalResult",
    "IclEvaluator",
    "MulticlassF1",
    "add_and_filter_verb_noun",
    "bleu",
    "generation_metric_suite",
    "load_narrated_action_verb_noun",
    "load_prompt_map",
    "rouge_l",
]
