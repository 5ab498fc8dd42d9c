"""Port vs JAX: the two-stage ICL evaluator and its metrics.

The world of ``tests/eval/test_icl_evaluator.py`` (tiny_config with a
384-token vocabulary, 4 train and 3 eval datapoints of one 2-frame video
each, two verbs and two nouns, one shot), with the word-level
``tests/data/mock_tokenizer.MockTokenizer`` (one instance a side: it numbers
words in the order it first sees them) and ``random.Random(42)`` on both
sides. The port's ``IclEvaluator`` must give the JAX evaluator's predictions
and F1s exactly, with and without the video-feature cache; the noun stage
must then be all hits.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eilev_tpu import configs
from eilev_tpu.eval import IclEvaluator as JIclEvaluator
from eilev_tpu.eval import metrics as jmetrics
from eilev_tpu.models import VideoBlipForConditionalGeneration as JVB
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.eval import IclEvaluator, load_prompt_map
from eilev_tpu_torch.eval import metrics as tmetrics
from eilev_tpu_torch.models import VideoBlipForConditionalGeneration, params_from_jax

from ._torch_port import random_params
from .data.mock_tokenizer import MockTokenizer

VOCAB = 384
EVAL_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts", "ego4d",
                         "eval-data")


@pytest.fixture(scope="module")
def world():
    cfg = configs.tiny_config(text_model="opt", vocab_size=VOCAB)
    img = cfg.vision_config.image_size
    rng = np.random.default_rng(0)
    verbs = ["take", "cut"]
    nouns = ["knife", "onion"]

    def make_dp(i):
        return {
            "frame_path": f"vid{i}|0",
            "narration_text": f"#C C does {verbs[i % 2]} {nouns[i // 2 % 2]}",
            "structured_verb": verbs[i % 2],
            "structured_noun": nouns[i // 2 % 2],
            "video": rng.integers(0, 255, (3, 2, img, img)).astype(np.uint8),
        }

    train = [make_dp(i) for i in range(4)]
    eval_ds = [make_dp(10 + i) for i in range(3)]
    ids = jnp.asarray([[2] + [1] * cfg.num_query_tokens + [4, 5]])
    vim = jnp.zeros_like(ids).at[:, 1 : 1 + cfg.num_query_tokens].set(1)
    jmodel = JVB(cfg, dtype=jnp.float32)
    # weights under which the verb predictions differ between datapoints, so
    # that the predictions compared depend on each datapoint's scores
    params = random_params(
        jmodel, 33, input_ids=ids, pixel_values=jnp.zeros((1, 3, 2, img, img)), video_input_mask=vim
    )
    params = jax.tree.map(np.asarray, params)
    tcfg = tconfigs.tiny_config(text_model="opt", vocab_size=VOCAB)
    model = VideoBlipForConditionalGeneration(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, tcfg), strict=True)
    kw = dict(
        verb_prompts={"takes": "take", "cuts": "cut"},
        noun_prompts={"a knife": "knife", "an onion": "onion"},
        verbs=verbs,
        nouns=nouns,
        num_shot=1,
    )
    return jmodel, {"params": params}, model.eval(), train, eval_ds, kw


def _evaluate_both(world, **opts):
    jmodel, variables, model, train, eval_ds, kw = world
    ref = JIclEvaluator(
        jmodel, variables, MockTokenizer(), rng=random.Random(42), dtype=jnp.float32, **kw, **opts
    ).evaluate(eval_ds, train, batch_size=2)
    ev = IclEvaluator(model, MockTokenizer(), rng=random.Random(42), device="cpu", **kw, **opts)
    return ref, ev, ev.evaluate(eval_ds, train, batch_size=2)


@pytest.mark.parametrize("vision_cache", [None, 64])
def test_evaluator_matches_jax(world, vision_cache):
    ref, ev, ours = _evaluate_both(world, vision_cache=vision_cache)
    assert ours.verb_predictions == ref.verb_predictions
    assert ours.noun_predictions == ref.noun_predictions
    assert (ours.verb_f1, ours.noun_f1) == (ref.verb_f1, ref.noun_f1)
    assert len(ours.verb_predictions) == len(ours.noun_predictions) == 3
    assert len({p["prediction"] for p in ours.verb_predictions}) == 2
    if vision_cache:
        cache = ev._feature_cache
        # each batch's noun stage finds every video its verb stage encoded
        assert cache.misses <= 7 and cache.hits >= cache.misses
        assert len(cache) == cache.misses and all(key in cache for key in ("vid10|0", "vid11|0", "vid12|0"))
        assert cache.hit_rate == cache.hits / (cache.hits + cache.misses)


def test_lazy_frame_loader_matches_jax(world):
    """Metadata-only datasets + frame_loader: the JAX evaluator's predictions,
    and one load per distinct video."""
    jmodel, variables, model, train, eval_ds, kw = world
    frames = {dp["frame_path"]: dp["video"] for dp in train + eval_ds}
    meta_train = [{k: v for k, v in dp.items() if k != "video"} for dp in train]
    meta_eval = [{k: v for k, v in dp.items() if k != "video"} for dp in eval_ds]
    ref = JIclEvaluator(
        jmodel, variables, MockTokenizer(), rng=random.Random(42), dtype=jnp.float32,
        vision_cache=64, frame_loader=frames.__getitem__, **kw,
    ).evaluate(meta_eval, meta_train, batch_size=2)
    loads = []

    def loader(key):
        loads.append(key)
        return frames[key]

    ev = IclEvaluator(model, MockTokenizer(), rng=random.Random(42), device="cpu", vision_cache=64,
                      frame_loader=loader, **kw)
    ours = ev.evaluate(meta_eval, meta_train, batch_size=2)
    assert ours.verb_predictions == ref.verb_predictions
    assert ours.noun_predictions == ref.noun_predictions
    assert (ours.verb_f1, ours.noun_f1) == (ref.verb_f1, ref.noun_f1)
    assert len(loads) == len(set(loads)) == ev._feature_cache.misses


def test_frame_loader_requires_cache(world):
    _, _, model, _, _, kw = world
    with pytest.raises(ValueError, match="frame_loader requires vision_cache"):
        IclEvaluator(model, MockTokenizer(), frame_loader=lambda k: None, device="cpu", **kw)


def test_vendored_class_prompt_maps():
    """The vendored prompt->class CSVs: 187 verb prompts and 788 noun prompts
    (4 duplicate noun prompts collapse), as the JAX loader reads them."""
    from eilev_tpu.eval import load_prompt_map as jload

    for name, column, n in (("structured_verb_prompt.csv", "structured_verb", 187),
                            ("structured_noun_prompt.csv", "structured_noun", 788)):
        path = os.path.join(EVAL_DATA, name)
        ours = load_prompt_map(path, column)
        assert len(ours) == n
        assert ours == jload(path, column) and list(ours) == list(jload(path, column))


def test_multiclass_f1_matches_jax():
    rng = np.random.default_rng(5)
    preds, targets = rng.integers(0, 7, 40), rng.integers(0, 7, 40)
    ours, ref = tmetrics.MulticlassF1(9), jmetrics.MulticlassF1(9)
    for p, t in zip(preds, targets):
        ours([int(p)], [int(t)])
        ref([int(p)], [int(t)])
    ours.update([1, 2], [2, 2])
    ref.update([1, 2], [2, 2])
    assert ours.compute() == ref.compute() and 0 < ours.compute() < 1


PREDICTIONS = [
    "The camera wearer cuts the onion on the board.",
    "The camera wearer picks up a knife",
    "the man walks",
    "",
]
REFERENCES = [
    "The camera wearer cuts an onion on the chopping board.",
    ["The camera wearer picks up the knife.", "The camera wearer takes a knife"],
    "The camera wearer opens the drawer.",
    "The camera wearer washes a plate.",
]


def test_bleu_and_rouge_l_match_jax():
    assert tmetrics.bleu(PREDICTIONS, REFERENCES) == jmetrics.bleu(PREDICTIONS, REFERENCES) > 0
    assert tmetrics.bleu(PREDICTIONS[:2], REFERENCES[:2], max_order=2) == jmetrics.bleu(
        PREDICTIONS[:2], REFERENCES[:2], max_order=2)
    refs = [r if isinstance(r, str) else r[0] for r in REFERENCES]
    assert tmetrics.rouge_l(PREDICTIONS, refs) == jmetrics.rouge_l(PREDICTIONS, refs) > 0
    assert tmetrics.generation_metric_suite(PREDICTIONS, refs) == jmetrics.generation_metric_suite(
        PREDICTIONS, refs)


def test_encoder_metrics_are_not_ported():
    """The encoder metrics are ported (tests/test_torch_encoder.py holds them
    to JAX's); without a local checkpoint each refuses as JAX's does."""
    for fn, jfn in ((tmetrics.bert_score_f1, jmetrics.bert_score_f1),
                    (tmetrics.sts_biencoder_cosine, jmetrics.sts_biencoder_cosine),
                    (tmetrics.sts_crossencoder, jmetrics.sts_crossencoder)):
        for f in (fn, jfn):
            with pytest.raises(RuntimeError, match="local pretrained checkpoint"):
                f(["a"], ["a"], "unused")
