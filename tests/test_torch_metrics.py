"""The port's NLG metrics (``u2tokenizer_torch/eval/metrics.py``) against
the JAX package's on a host without ``nltk`` and ``bert_score``.

The JAX package takes nltk's BLEU and METEOR and the ``bert_score``
package where they import; the port never does. So the reference here is
the JAX function with both packages blocked in ``sys.modules``: its own
fallbacks, the functions the port copies. Every metric is held on the same
pairs (empty texts, no overlap, repeats, punctuation, case, CJK, 300-word
reports), exactly: both sides run the same Python arithmetic in the same
order, and the hashed embeddings the same numpy float32 products.
"""

import sys

import numpy as np
import pytest

from u2tokenizer_torch.eval import metrics as t_metrics
from u2tokenizer_tpu.eval import metrics as j_metrics

pytestmark = pytest.mark.fast

BLOCKED = ("nltk", "nltk.translate", "nltk.translate.bleu_score",
           "nltk.translate.meteor_score", "bert_score")


@pytest.fixture(autouse=True)
def no_nltk_or_bert_score(monkeypatch):
    for name in BLOCKED:
        monkeypatch.setitem(sys.modules, name, None)


def _report(seed: int, words: int = 300) -> str:
    vocab = ("the lungs are clear without focal consolidation there is no "
             "pleural effusion or pneumothorax heart size normal mild "
             "degenerative change of thoracic spine small hypodense lesion "
             "in segment liver kidneys enhance symmetrically . , ;").split()
    rs = np.random.default_rng(seed)
    return " ".join(vocab[i] for i in rs.integers(0, len(vocab), words))


LONG = _report(0)
PAIRS = {
    "identical": ("the lungs are clear", "the lungs are clear"),
    "empty_hypothesis": ("the lungs are clear", ""),
    "empty_reference": ("", "the lungs are clear"),
    "both_empty": ("", ""),
    "no_overlap": ("a b c", "d e"),
    "repeats": ("the the the cat", "the the the the the"),
    "punctuation_case": ("No pleural effusion.", "no pleural effusion ."),
    "punctuation": ("Heart: normal; lungs: clear!", "heart normal lungs clear"),
    "whitespace": ("  clear\tlungs \n", "clear lungs"),
    "reordered": ("clear lungs normal heart", "normal heart clear lungs"),
    "numbers": ("lesion 3.2 cm in segment 4", "lesion 3.2 cm in segment 7"),
    "one_word": ("mass", "mass"),
    "cjk": ("肺 清晰 心脏 正常", "肺 正常"),
    "short_hypothesis": (LONG, "the lungs are clear"),
    "long_hypothesis": ("the lungs are clear", LONG),
    "300_words_perturbed": (LONG, _report(0, 290) + " lesion liver"),
    "300_words_other": (LONG, _report(1)),
}
IDS = list(PAIRS)

METRICS = {
    "tokenize": lambda m, r, h: m._tokenize(r) + ["|"] + m._tokenize(h),
    "bleu1": lambda m, r, h: m.bleu(r, h, 1),
    "bleu2": lambda m, r, h: m.bleu(r, h, 2),
    "bleu4": lambda m, r, h: m.bleu(r, h, 4),
    "bleu_fallback3": lambda m, r, h: m._bleu_fallback(r, h, 3),
    "rouge1": lambda m, r, h: m.rouge_n(r, h, 1),
    "rouge2": lambda m, r, h: m.rouge_n(r, h, 2),
    "lcs_len": lambda m, r, h: m._lcs_len(m._tokenize(r), m._tokenize(h)),
    "rougeL": lambda m, r, h: m.rouge_l(r, h),
    "meteor": lambda m, r, h: m.meteor(r, h),
    "bert_score_fallback": lambda m, r, h: m.bert_score_fallback_f1(r, h),
    "score_report": lambda m, r, h: m.score_report(r, h),
}


@pytest.mark.parametrize("pair", IDS)
@pytest.mark.parametrize("metric", list(METRICS))
def test_metric_matches_jax(metric, pair):
    ref, hyp = PAIRS[pair]
    got = METRICS[metric](t_metrics, ref, hyp)
    want = METRICS[metric](j_metrics, ref, hyp)
    assert got == want


def test_bleu_has_no_smoothing():
    """Known difference 12: without nltk the JAX package's BLEU adds 1e-9
    to the overlap, and so does the port's, where nltk's method-1
    smoothing would give 0.0."""
    assert t_metrics.bleu("a b c", "d e") == pytest.approx(
        1e-9 / 2 * np.exp(1 - 3 / 2), rel=1e-12)


@pytest.mark.parametrize("allow_fallback", [True, False])
def test_bert_score_f1_matches_jax(allow_fallback):
    refs = [PAIRS[p][0] for p in IDS]
    hyps = [PAIRS[p][1] for p in IDS]
    got = t_metrics.bert_score_f1(refs, hyps, allow_fallback=allow_fallback)
    want = j_metrics.bert_score_f1(refs, hyps, allow_fallback=allow_fallback)
    assert got == want
    assert (got is None) == (not allow_fallback)


@pytest.mark.parametrize("token", ["lungs", "", "a", "pneumothorax", "3.2",
                                   "肺", "effusion."])
def test_hashed_token_embedding_matches_jax(token):
    got = t_metrics._hashed_token_embedding(token)
    want = j_metrics._hashed_token_embedding(token)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("answers,predictions", [
    (["A", "B", "C"], ["a", "b) lungs", "D"]),
    (["", "A"], ["A", ""]),
    ([" yes ", "No"], ["yes", "no."]),
    ([], []),
    (["choice A"], ["c"]),
])
def test_exact_match_accuracy_matches_jax(answers, predictions):
    assert (t_metrics.exact_match_accuracy(answers, predictions)
            == j_metrics.exact_match_accuracy(answers, predictions))
