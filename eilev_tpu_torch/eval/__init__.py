from .encoder import (
    CrossEncoderModel,
    EncoderConfig,
    SentenceEncoder,
    TextEncoder,
    bertscore_native,
    convert_encoder,
    encoder_config_from_hf,
)
from .icl import (
    IclEvalResult,
    IclEvaluator,
    add_and_filter_verb_noun,
    load_narrated_action_verb_noun,
    load_prompt_map,
)
from .metrics import (
    MulticlassF1,
    bert_score_f1,
    bleu,
    generation_metric_suite,
    raise_unless_local,
    rouge_l,
    sts_biencoder_cosine,
    sts_crossencoder,
)

__all__ = [
    "CrossEncoderModel",
    "EncoderConfig",
    "IclEvalResult",
    "IclEvaluator",
    "MulticlassF1",
    "SentenceEncoder",
    "TextEncoder",
    "add_and_filter_verb_noun",
    "bert_score_f1",
    "bertscore_native",
    "bleu",
    "convert_encoder",
    "encoder_config_from_hf",
    "generation_metric_suite",
    "load_narrated_action_verb_noun",
    "load_prompt_map",
    "raise_unless_local",
    "rouge_l",
    "sts_biencoder_cosine",
    "sts_crossencoder",
]
