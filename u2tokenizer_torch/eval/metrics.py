"""NLG metrics: BLEU, ROUGE-1/2/L, METEOR, BERTScore, exact match
(counterpart of ``u2tokenizer_tpu/eval/metrics.py``).

The reference's evalscipt/ourmodel_amos.py:86-133 scores generated reports
with nltk's BLEU-1, rouge's ROUGE-1/2/L, METEOR and BERTScore. The port
computes what the JAX package computes on a host without ``nltk`` and
``bert_score``, and never imports either:

  * ``bleu``: sentence BLEU-n with uniform weights, the JAX package's
    ``_bleu_fallback`` (1e-9 added to each n-gram overlap; nltk's method-1
    smoothing is not taken, so a hypothesis with no overlap scores ~1e-9
    where nltk gives 0);
  * ``meteor``: METEOR's exact-match core (alpha 0.9), without nltk's
    stem and synonym stages or its fragmentation penalty;
  * ``bert_score_f1``: BERTScore's greedy matching over hashed character
    3-gram embeddings (md5), not a contextual model.
"""

from __future__ import annotations

import hashlib
import math
from collections import Counter
from typing import Dict, List, Sequence

import numpy as np


def _tokenize(text: str) -> List[str]:
    return text.lower().split()


def bleu(reference: str, hypothesis: str, max_n: int = 1) -> float:
    """Sentence BLEU-n with uniform weights (``_bleu_fallback``)."""
    return _bleu_fallback(reference, hypothesis, max_n)


def _bleu_fallback(reference: str, hypothesis: str, max_n: int) -> float:
    ref, hyp = _tokenize(reference), _tokenize(hypothesis)
    if not hyp:
        return 0.0
    log_p = 0.0
    for n in range(1, max_n + 1):
        ref_ngrams = _ngram_counts(ref, n)
        hyp_ngrams = _ngram_counts(hyp, n)
        overlap = sum((hyp_ngrams & ref_ngrams).values())
        total = max(sum(hyp_ngrams.values()), 1)
        p = (overlap + 1e-9) / total
        log_p += math.log(p) / max_n
    bp = 1.0 if len(hyp) > len(ref) else math.exp(1 - len(ref) / max(len(hyp), 1))
    return float(bp * math.exp(log_p))


def _ngram_counts(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def rouge_n(reference: str, hypothesis: str, n: int = 1) -> Dict[str, float]:
    ref = _ngram_counts(_tokenize(reference), n)
    hyp = _ngram_counts(_tokenize(hypothesis), n)
    overlap = sum((ref & hyp).values())
    p = overlap / max(sum(hyp.values()), 1)
    r = overlap / max(sum(ref.values()), 1)
    f = 2 * p * r / max(p + r, 1e-9)
    return {"precision": p, "recall": r, "f": f}


def _lcs_len(a: List[str], b: List[str]) -> int:
    dp = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        prev = 0
        for j in range(1, len(b) + 1):
            cur = dp[j]
            dp[j] = prev + 1 if a[i - 1] == b[j - 1] else max(dp[j], dp[j - 1])
            prev = cur
    return dp[len(b)]


def rouge_l(reference: str, hypothesis: str) -> Dict[str, float]:
    ref, hyp = _tokenize(reference), _tokenize(hypothesis)
    lcs = _lcs_len(ref, hyp)
    p = lcs / max(len(hyp), 1)
    r = lcs / max(len(ref), 1)
    f = 2 * p * r / max(p + r, 1e-9)
    return {"precision": p, "recall": r, "f": f}


def meteor(reference: str, hypothesis: str) -> float:
    """METEOR's exact-match harmonic mean (alpha 0.9): each hypothesis word
    matches a reference word not matched yet."""
    ref, hyp = _tokenize(reference), _tokenize(hypothesis)
    ref_counts = Counter(ref)
    matches = 0
    for w in hyp:
        if ref_counts[w] > 0:
            matches += 1
            ref_counts[w] -= 1
    if matches == 0:
        return 0.0
    p = matches / len(hyp)
    r = matches / len(ref)
    return float(p * r / (0.9 * p + 0.1 * r))


def bert_score_f1(references: Sequence[str], hypotheses: Sequence[str],
                  allow_fallback: bool = True):
    """BERTScore-F1 a pair (evalscipt/ourmodel_amos.py:86-133 protocol)
    over hashed n-gram embeddings (``bert_score_fallback_f1``); None when
    ``allow_fallback`` is False, as the JAX package returns without the
    ``bert_score`` package."""
    if not allow_fallback:
        return None
    return [bert_score_fallback_f1(r, h)
            for r, h in zip(references, hypotheses)]


def _hashed_token_embedding(token: str, dim: int = 128):
    """Deterministic unit vector for a token from hashed char 3-grams."""
    vec = np.zeros(dim, np.float32)
    padded = f"##{token}##"
    for i in range(len(padded) - 2):
        gram = padded[i:i + 3]
        h = int.from_bytes(
            hashlib.md5(gram.encode()).digest()[:8], "little")
        vec[h % dim] += 1.0 if (h >> 32) % 2 == 0 else -1.0
    n = float(np.linalg.norm(vec))
    return vec / n if n > 0 else vec


def bert_score_fallback_f1(reference: str, hypothesis: str) -> float:
    """Greedy-matching BERTScore-F1 over hashed n-gram embeddings."""
    ref, hyp = _tokenize(reference), _tokenize(hypothesis)
    if not ref or not hyp:
        return 0.0
    re = np.stack([_hashed_token_embedding(t) for t in ref])
    he = np.stack([_hashed_token_embedding(t) for t in hyp])
    sim = he @ re.T  # (len(hyp), len(ref)) cosine similarities
    precision = float(sim.max(axis=1).mean())
    recall = float(sim.max(axis=0).mean())
    if precision + recall <= 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def exact_match_accuracy(answers: Sequence[str],
                         predictions: Sequence[str]) -> float:
    """VQA choice accuracy (eval/vqa.py:120-139 semantics: match on the
    first letter/normalized string)."""
    correct = 0
    for a, p in zip(answers, predictions):
        a = a.strip().lower()
        p = p.strip().lower()
        if a and p and (a == p or a[0] == p[0]):
            correct += 1
    return correct / max(len(answers), 1)


def score_report(reference: str, hypothesis: str) -> Dict[str, float]:
    """All CPU metrics for one (reference, prediction) pair."""
    return {
        "bleu1": bleu(reference, hypothesis, 1),
        "rouge1_f": rouge_n(reference, hypothesis, 1)["f"],
        "rouge2_f": rouge_n(reference, hypothesis, 2)["f"],
        "rougeL_f": rouge_l(reference, hypothesis)["f"],
        "meteor": meteor(reference, hypothesis),
    }
