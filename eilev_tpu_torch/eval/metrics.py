"""Text-generation quality metrics (counterpart of ``eilev_tpu/eval/metrics.py``).

Parity target: the original EILeV's scripts/general/generation_eval.py:14-101,
which scores generated narrations against ground truth with BLEU, ROUGE-L,
BERTScore (rescaled), and two sentence-similarity models. BLEU, ROUGE-L and
the macro multiclass F1 of the verb/noun ICL eval (torchmetrics
MulticlassF1Score default semantics, reference scripts/general/icl_eval.py:
174,205) are copies of the JAX package's, exact and deterministic. The
model-based metrics (BERTScore, STS bi-/cross-encoder) run the encoders of
``eval/encoder.py`` from local checkpoints on ``device`` (the card by
default), and raise a clear error without one (no Hub egress).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# multiclass macro F1
# ---------------------------------------------------------------------------


class MulticlassF1:
    """Macro-averaged multiclass F1 over streaming (pred, target) pairs -
    matching ``torchmetrics.MulticlassF1Score(num_classes)`` defaults (macro
    average over classes that appear in preds or targets; torchmetrics counts
    all classes but absent classes contribute 0 to both num and denom)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.tp = np.zeros(num_classes, np.int64)
        self.fp = np.zeros(num_classes, np.int64)
        self.fn = np.zeros(num_classes, np.int64)

    def update(self, preds: Sequence[int], targets: Sequence[int]) -> None:
        for p, t in zip(preds, targets):
            if p == t:
                self.tp[p] += 1
            else:
                self.fp[p] += 1
                self.fn[t] += 1

    def __call__(self, preds, targets):
        self.update(np.atleast_1d(preds), np.atleast_1d(targets))

    def compute(self) -> float:
        # torchmetrics 0.11 (the reference's pin) macro semantics: average over
        # ALL num_classes, with 0/0 -> 0 for classes absent from preds+targets.
        denom = 2 * self.tp + self.fp + self.fn
        f1 = np.where(denom > 0, 2 * self.tp / np.maximum(denom, 1), 0.0)
        return float(f1.mean())


# ---------------------------------------------------------------------------
# BLEU (Papineni et al. 2002, corpus-level, uniform 4-gram weights)
# ---------------------------------------------------------------------------


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def bleu(
    predictions: Sequence[str],
    references: Sequence[Sequence[str] | str],
    max_order: int = 4,
) -> float:
    """Corpus BLEU with whitespace tokenization (the semantics of HF
    ``evaluate.load('bleu')`` used by the reference's metric suite)."""
    matches = np.zeros(max_order, np.int64)
    possible = np.zeros(max_order, np.int64)
    pred_len = 0
    ref_len = 0
    for pred, refs in zip(predictions, references):
        if isinstance(refs, str):
            refs = [refs]
        p_tok = pred.split()
        r_toks = [r.split() for r in refs]
        pred_len += len(p_tok)
        ref_len += min((abs(len(r) - len(p_tok)), len(r)) for r in r_toks)[1]
        for n in range(1, max_order + 1):
            p_ng = _ngrams(p_tok, n)
            max_ref: Counter = Counter()
            for r in r_toks:
                for ng, c in _ngrams(r, n).items():
                    max_ref[ng] = max(max_ref[ng], c)
            overlap = sum(min(c, max_ref[ng]) for ng, c in p_ng.items())
            matches[n - 1] += overlap
            possible[n - 1] += max(len(p_tok) - n + 1, 0)
    if possible[0] == 0 or matches[0] == 0:
        return 0.0
    log_precisions = []
    for n in range(max_order):
        if possible[n] == 0 or matches[n] == 0:
            return 0.0  # standard BLEU: zero if any n-gram precision is zero
        log_precisions.append(math.log(matches[n] / possible[n]))
    geo_mean = math.exp(sum(log_precisions) / max_order)
    bp = 1.0 if pred_len > ref_len else math.exp(1 - ref_len / max(pred_len, 1))
    return geo_mean * bp


# ---------------------------------------------------------------------------
# ROUGE-L (LCS-based F-measure, rouge_score semantics)
# ---------------------------------------------------------------------------


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    dp = np.zeros((len(a) + 1, len(b) + 1), np.int32)
    for i, x in enumerate(a, 1):
        for j, y in enumerate(b, 1):
            dp[i, j] = dp[i - 1, j - 1] + 1 if x == y else max(dp[i - 1, j], dp[i, j - 1])
    return int(dp[-1, -1])


def _rouge_tokenize(text: str) -> list[str]:
    """rouge_score default tokenizer: lowercase, alphanumerics only."""
    import re

    return re.findall(r"[a-z0-9]+", text.lower())


def rouge_l(predictions: Sequence[str], references: Sequence[str]) -> float:
    """Mean per-sentence ROUGE-L F1 (HF ``evaluate.load('rouge')['rougeL']``)."""
    scores = []
    for pred, ref in zip(predictions, references):
        p = _rouge_tokenize(pred)
        r = _rouge_tokenize(ref)
        lcs = _lcs_len(p, r)
        if lcs == 0:
            scores.append(0.0)
            continue
        prec = lcs / len(p)
        rec = lcs / len(r)
        scores.append(2 * prec * rec / (prec + rec))
    return float(np.mean(scores)) if scores else 0.0


# ---------------------------------------------------------------------------
# model-based metrics (gated on local checkpoints)
# ---------------------------------------------------------------------------


def bert_score_f1(
    predictions: Sequence[str],
    references: Sequence[str],
    model_path: Optional[str] = None,
    *,
    num_layers: Optional[int] = None,
    baseline: Optional[float] = None,
    device="cuda",
) -> float:
    """BERTScore F1 (reference generation_eval.py:58-72) from a LOCAL
    BERT/RoBERTa/MPNet checkpoint (eval/encoder.py) on ``device``.
    ``num_layers`` defaults to bert_score's per-model table (roberta-large ->
    17) when the geometry is recognized, else the last layer. ``baseline``
    applies rescale_with_baseline given the model's published baseline value."""
    raise_unless_local("BERTScore", model_path)
    from .encoder import SentenceEncoder

    enc = SentenceEncoder(model_path, device=device)
    return _bert_score_f1(enc, predictions, references, num_layers=num_layers, baseline=baseline)


def _bert_score_f1(enc, predictions: Sequence[str], references: Sequence[str], *,
                   num_layers: Optional[int] = None, baseline: Optional[float] = None) -> float:
    """:func:`bert_score_f1` over a loaded ``SentenceEncoder``."""
    from .encoder import bertscore_native

    if num_layers is None:
        cfg = enc.config
        if cfg.model_type == "roberta" and cfg.num_hidden_layers == 24:
            num_layers = 17  # roberta-large, the torchmetrics default model
    f1 = bertscore_native(predictions, references, enc, num_layers=num_layers, baseline=baseline)
    return float(f1.mean())


def sts_biencoder_cosine(
    predictions: Sequence[str],
    references: Sequence[str],
    model_path: Optional[str] = None,
    *,
    device="cuda",
) -> float:
    """Mean pairwise cosine under a mean-pooled sentence encoder: the
    all-mpnet-base-v2 pipeline of the reference (generation_eval.py:14-33),
    from a local checkpoint (eval/encoder.py) on ``device``."""
    raise_unless_local("STS bi-encoder", model_path)
    from .encoder import SentenceEncoder

    return _sts_biencoder_cosine(SentenceEncoder(model_path, device=device), predictions, references)


def _sts_biencoder_cosine(enc, predictions: Sequence[str], references: Sequence[str]) -> float:
    """:func:`sts_biencoder_cosine` over a loaded ``SentenceEncoder``."""
    a = enc.encode(list(predictions))
    b = enc.encode(list(references))
    return float(np.mean(np.sum(a * b, axis=-1)))


def sts_crossencoder(
    predictions: Sequence[str],
    references: Sequence[str],
    model_path: Optional[str] = None,
    *,
    device="cuda",
) -> float:
    """Cross-encoder STS score (stsb-roberta-large in the reference,
    generation_eval.py:37-49) from a local checkpoint on ``device``."""
    raise_unless_local("STS cross-encoder", model_path)
    from .encoder import SentenceEncoder

    return _sts_crossencoder(SentenceEncoder(model_path, cross_encoder=True, device=device), predictions, references)


def _sts_crossencoder(enc, predictions: Sequence[str], references: Sequence[str]) -> float:
    """:func:`sts_crossencoder` over a loaded cross-encoder ``SentenceEncoder``."""
    return float(np.mean(enc.predict_pairs(list(zip(predictions, references)))))


def raise_unless_local(name: str, model_path: Optional[str]) -> None:
    import os

    if model_path is None or not os.path.exists(model_path):
        raise RuntimeError(
            f"{name} needs a local pretrained checkpoint (no Hub egress in this "
            f"environment). Pass model_path=<local dir>; got {model_path!r}. "
            "BLEU and ROUGE-L run without downloads."
        )


def generation_metric_suite(
    predictions: Sequence[str],
    references: Sequence[str],
    *,
    bert_score_model: Optional[str] = None,
    sts_biencoder_model: Optional[str] = None,
    sts_crossencoder_model: Optional[str] = None,
    device="cuda",
) -> dict[str, float]:
    """The generation_eval.py metric set; model-based entries appear only when
    their local checkpoints are provided, and run on ``device``."""
    out = {
        "bleu": bleu(predictions, references),
        "rougeL": rouge_l(predictions, references),
    }
    if bert_score_model:
        out["bertscore_f1"] = bert_score_f1(predictions, references, bert_score_model, device=device)
    if sts_biencoder_model:
        out["sts_biencoder"] = sts_biencoder_cosine(predictions, references, sts_biencoder_model, device=device)
    if sts_crossencoder_model:
        out["sts_crossencoder"] = sts_crossencoder(predictions, references, sts_crossencoder_model, device=device)
    return out
