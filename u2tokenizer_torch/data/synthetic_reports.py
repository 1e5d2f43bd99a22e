"""Synthetic AMOS-style radiology reports for content-realistic benchmarks
(a copy of ``u2tokenizer_tpu/data/synthetic_reports.py``, with the
drafting replays on the port's ``ngram_draft``).

Random-weight greedy decoding collapses into short token cycles that flatter
n-gram speculative acceptance (r2 VERDICT weak #2). Real CT findings reports
are template-heavy but case-varied: formulaic normal statements shared across
cases, pathological findings varying in organ/laterality/severity. This
module generates reports with that statistical structure (original template
bank written in the register of AMOS-MM findings — not copied from the
reference's data), and a deterministic word-level tokenizer so the benchmark
can script token streams through the real decode path
(models.speculative.make_spec_generate_fn(forced_content=True)).

Word-level ids approximate BPE for this vocabulary: the templates' words are
common English/radiology terms that BPE encodes as single tokens, so n-gram
repetition statistics carry over.
"""

from __future__ import annotations

import random
from typing import List, Optional

import numpy as np

_NORMALS = [
    "The {organ} is normal in size and shape with homogeneous density.",
    "No abnormal density is seen in the {organ}.",
    "The {organ} shows no focal lesion.",
    "No enlarged lymph nodes are seen in the {region}.",
    "The {organ} is unremarkable.",
    "There is no free fluid in the {region}.",
    "No significant abnormality is detected in the {organ}.",
]

_FINDINGS = [
    "A {size} {density} lesion is seen in the {part} of the {organ}.",
    "Scattered {density} foci are seen in the {part} of the {organ}.",
    "The {organ} is {severity} enlarged.",
    "A small amount of fluid is seen in the {region}.",
    "Multiple {severity} enlarged lymph nodes are seen in the {region}.",
    "There is {severity} wall thickening of the {organ}.",
    "A {size} cystic lesion is noted in the {part} of the {organ}.",
    "Calcification is seen in the {part} of the {organ}.",
]

_OPENINGS = [
    "Both sides of the thorax are symmetrical.",
    "The scan covers the {region} without motion artifact.",
    "The examined {region} is adequately visualized.",
]

_CLOSINGS = [
    "No other abnormality is seen.",
    "The remaining structures are unremarkable.",
    "Follow-up is recommended as clinically indicated.",
]

_ORGANS = ["liver", "spleen", "pancreas", "left kidney", "right kidney",
           "gallbladder", "stomach", "bladder", "prostate", "uterus",
           "esophagus", "duodenum", "left adrenal gland",
           "right adrenal gland", "left lung", "right lung", "heart"]
_REGIONS = ["abdomen", "pelvis", "chest", "mediastinum", "retroperitoneum",
            "pelvic cavity", "abdominal cavity"]
_PARTS = ["upper pole", "lower pole", "body", "head", "tail", "left lobe",
          "right lobe", "lower lobe", "upper lobe", "fundus", "antrum"]
_SIZES = ["small", "tiny", "large", "1.2 cm", "2.3 cm", "0.8 cm", "3.1 cm"]
_DENSITIES = ["low-density", "high-density", "mixed-density", "patchy",
              "point-like", "nodular"]
_SEVERITIES = ["mildly", "moderately", "markedly", "slightly"]


def synthesize_report(rng: random.Random, n_sentences: int = 12) -> str:
    """One findings report: opening + mixed normal/abnormal statements +
    closing; ~70% normal sentences (the template-heavy serving content)."""
    def fill(t):
        return t.format(
            organ=rng.choice(_ORGANS), region=rng.choice(_REGIONS),
            part=rng.choice(_PARTS), size=rng.choice(_SIZES),
            density=rng.choice(_DENSITIES), severity=rng.choice(_SEVERITIES))

    sentences = [fill(rng.choice(_OPENINGS))]
    for _ in range(n_sentences - 2):
        bank = _NORMALS if rng.random() < 0.7 else _FINDINGS
        sentences.append(fill(rng.choice(bank)))
    sentences.append(fill(rng.choice(_CLOSINGS)))
    return " ".join(sentences)


def words_to_ids(text: str, vocab_size: int,
                 reserve_low: int = 16) -> np.ndarray:
    """Deterministic word -> id hash into [reserve_low, vocab_size)."""
    import hashlib

    ids = []
    for word in text.split():
        digest = hashlib.md5(word.encode()).digest()
        val = int.from_bytes(digest[:4], "little")
        ids.append(reserve_low + val % (vocab_size - reserve_low))
    return np.asarray(ids, np.int32)


def report_token_scripts(batch: int, length: int, vocab_size: int,
                         seed: int = 0,
                         corpus_size: Optional[int] = None) -> np.ndarray:
    """(B, length) int32 scripts of synthetic-report tokens, one report
    stream per row (reports concatenated until ``length``). Used by the
    bench's content-controlled speculative measurement and by the
    pred_then_green content protocol."""
    rng = random.Random(seed)
    out = np.zeros((batch, length), np.int32)
    for b in range(batch):
        toks: List[int] = []
        while len(toks) < length:
            toks.extend(words_to_ids(synthesize_report(rng),
                                     vocab_size).tolist())
        out[b] = np.asarray(toks[:length], np.int32)
    return out


def forced_content_replay(script: np.ndarray, prompt: np.ndarray,
                          prompt_len: np.ndarray,
                          block_len: int = 8) -> np.ndarray:
    """Verify steps a row of a greedy forced-content decode whose emitted
    tokens are ``script`` (B, max_new), replayed on the host with the
    loop's own drafter (``models.speculative.ngram_draft`` on CPU tensors)
    over the history layout the loop keeps: prompt (B, S) ids under
    ``prompt_len``, -1 up to S, generated token j at S + j. A row stops
    once it has emitted max_new tokens; the loop's step count is the
    largest row's."""
    import torch

    from ..models.speculative import ngram_draft

    b, max_new = script.shape
    s = prompt.shape[1]
    plen = np.asarray(prompt_len, np.int64)
    hist = np.full((b, s + max_new), -1, np.int64)
    hist[:, :s] = np.where(np.arange(s)[None, :] < plen[:, None], prompt, -1)
    hist[:, s] = script[:, 0]
    rows = np.arange(b)
    n_emit = np.ones(b, np.int64)
    row_steps = np.zeros(b, np.int64)
    koff = np.arange(block_len - 1)
    while (n_emit < max_new).any():
        idx_last = s + n_emit - 1
        pending = hist[rows, idx_last]
        prev = np.where(n_emit >= 2, hist[rows, np.maximum(idx_last - 1, 0)],
                        hist[rows, plen - 1])
        prev2_idx = np.where(n_emit >= 3, idx_last - 2,
                             np.where(n_emit == 2, plen - 1, plen - 2))
        prev2 = hist[rows, np.maximum(prev2_idx, 0)]
        t = torch.from_numpy
        drafts = ngram_draft(t(hist), t(idx_last), t(prev), t(pending),
                             block_len - 1, c00=t(prev2)).numpy()
        tgt = n_emit[:, None] + koff[None, :]
        ok = (tgt < max_new) & (
            drafts == script[rows[:, None], np.minimum(tgt, max_new - 1)])
        emitted = 1 + np.cumprod(ok, axis=1).sum(axis=1)
        live = n_emit < max_new
        emitted = np.where(live, np.minimum(emitted, max_new - n_emit), 0)
        for row in np.nonzero(live)[0]:
            e0, e1 = n_emit[row], n_emit[row] + emitted[row]
            hist[row, s + e0:s + e1] = script[row, e0:e1]
        n_emit += emitted
        row_steps += live
    return row_steps


def ngram_acceptance_estimate(script: np.ndarray, block_len: int = 8,
                              prompt: Optional[np.ndarray] = None) -> float:
    """Drafter-exact estimate of greedy speculative acceptance over a
    scripted token stream (B, max_new): ``forced_content_replay`` with the
    prompt (default 8 zeros a row) packed with no pad gap, the per-row
    mean of emitted tokens (after the first) per verify step. For a
    padded prompt the loop's count is the replay with each row's own
    prompt length, not this estimate."""
    b, max_new = script.shape
    if prompt is None:
        prompt = np.zeros((b, 8), np.int32)
    steps = forced_content_replay(script, prompt,
                                  np.full(b, prompt.shape[1]), block_len)
    return float(np.mean((max_new - 1) / np.maximum(steps, 1)))
