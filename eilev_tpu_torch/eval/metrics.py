"""Text-generation quality metrics (counterpart of ``eilev_tpu/eval/metrics.py``).

Parity target: the original EILeV's scripts/general/generation_eval.py:14-101,
which scores generated narrations against ground truth with BLEU, ROUGE-L,
BERTScore (rescaled), and two sentence-similarity models. BLEU, ROUGE-L and
the macro multiclass F1 of the verb/noun ICL eval (torchmetrics
MulticlassF1Score default semantics, reference scripts/general/icl_eval.py:
174,205) are copies of the JAX package's, exact and deterministic. The
model-based metrics (BERTScore, STS bi-/cross-encoder) need the sentence
encoder of ``eilev_tpu/eval/encoder.py``, which is not ported yet: they raise
``NotImplementedError``.
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
# model-based metrics (need eval/encoder.py, not ported yet)
# ---------------------------------------------------------------------------


def _encoder_not_ported(name: str):
    raise NotImplementedError(
        f"{name} needs the sentence encoder (eval/encoder.py), which is not ported "
        "yet; BLEU and ROUGE-L are"
    )


def bert_score_f1(
    predictions: Sequence[str],
    references: Sequence[str],
    model_path: Optional[str] = None,
    *,
    num_layers: Optional[int] = None,
    baseline: Optional[float] = None,
) -> float:
    """BERTScore F1 (reference generation_eval.py:58-72); not ported yet."""
    _encoder_not_ported("BERTScore")


def sts_biencoder_cosine(
    predictions: Sequence[str],
    references: Sequence[str],
    model_path: Optional[str] = None,
) -> float:
    """Mean pairwise cosine under a mean-pooled sentence encoder (reference
    generation_eval.py:14-33); not ported yet."""
    _encoder_not_ported("STS bi-encoder")


def sts_crossencoder(
    predictions: Sequence[str],
    references: Sequence[str],
    model_path: Optional[str] = None,
) -> float:
    """Cross-encoder STS score (reference generation_eval.py:37-49); not
    ported yet."""
    _encoder_not_ported("STS cross-encoder")


def generation_metric_suite(
    predictions: Sequence[str],
    references: Sequence[str],
    *,
    bert_score_model: Optional[str] = None,
    sts_biencoder_model: Optional[str] = None,
    sts_crossencoder_model: Optional[str] = None,
) -> dict[str, float]:
    """The generation_eval.py metric set; a model-based entry is computed only
    when its checkpoint is named, and raises ``NotImplementedError`` until the
    encoder is ported."""
    out = {
        "bleu": bleu(predictions, references),
        "rougeL": rouge_l(predictions, references),
    }
    if bert_score_model:
        out["bertscore_f1"] = bert_score_f1(predictions, references, bert_score_model)
    if sts_biencoder_model:
        out["sts_biencoder"] = sts_biencoder_cosine(predictions, references, sts_biencoder_model)
    if sts_crossencoder_model:
        out["sts_crossencoder"] = sts_crossencoder(predictions, references, sts_crossencoder_model)
    return out
