"""Evaluators: MRG report generation, VQA choice accuracy and the
per-dataset benchmark protocol (counterpart of
``u2tokenizer_tpu/eval/evaluators.py``).

Behavioral rebuild of the reference's eval/mrg.py (report generation over
the validation set and the GREEN mean), eval/vqa.py (choice-letter
generation with max_new_tokens=1 and exact-match accuracy) and the
evalscipt/ourmodel_*.py benchmark mains (BLEU/ROUGE/BERTScore/METEOR/GREEN
over the first N validation cases, with per-error-type GREEN analysis,
ourmodel_amos.py:86-279), as the JAX package rebuilt them. Cases are
generated one at a time (B=1), as there; where the JAX package splits a
``jax.random`` key a case, the port draws from one seeded
``torch.Generator`` (greedy tokens do not depend on it).
"""

from __future__ import annotations

import inspect
import json
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .green import GreenScorer
from .metrics import bert_score_f1, exact_match_accuracy, score_report


@dataclass
class EvalResult:
    rows: List[dict] = field(default_factory=list)
    metrics: Dict[str, float] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({"metrics": self.metrics, "rows": self.rows},
                          indent=2)


def _decode_tokens(tokenizer, tokens, pad_id, eos_id) -> str:
    ids = []
    for t in tokens:
        t = int(t)
        if t == eos_id:
            break
        if t == pad_id:
            continue
        ids.append(t)
    return tokenizer.decode(ids, skip_special_tokens=True).strip()


class ReportGenerator:
    """One sample to report text: ``generate_fn`` (a
    ``make_multimodal_generate_fn``'s, (input_ids, images, question_ids,
    prompt_len, generator) -> (B, max_new) tokens) at B=1 on the model's
    device, with the sample's ``attention_mask.sum()`` as its prompt
    length."""

    def __init__(self, model, tokenizer, generate_fn, pad_id=0, eos_id=1):
        self.model = model
        self.tokenizer = tokenizer
        self.generate_fn = generate_fn
        self.pad_id = pad_id
        self.eos_id = eos_id

    @property
    def device(self) -> torch.device:
        return self.model.device

    def __call__(self, sample, generator=None) -> str:
        dev = self.device
        batch = [torch.as_tensor(sample[key])[None].to(dev)
                 for key in ("input_id", "image", "question_ids")]
        plen = torch.tensor([int(sample["attention_mask"].sum())],
                            dtype=torch.int32, device=dev)
        toks = self.generate_fn(*batch, plen, generator)
        return _decode_tokens(self.tokenizer, toks[0].tolist(),
                              self.pad_id, self.eos_id)


def _case_generator(generator, seed: int) -> torch.Generator:
    """The seeded stream the cases draw from, on the generator's device
    (the CPU for a generator without one)."""
    return torch.Generator(getattr(generator, "device", "cpu")
                           ).manual_seed(seed)


def evaluate_mrg(dataset, generator: ReportGenerator,
                 green_scorer: Optional[GreenScorer] = None,
                 max_cases: int = 100, seed: int = 0) -> EvalResult:
    """Report generation + GREEN mean (eval/mrg.py:31-140 protocol)."""
    rng = _case_generator(generator, seed)
    result = EvalResult()
    refs, hyps = [], []
    for idx in range(min(max_cases, len(dataset))):
        sample = dataset[idx]
        if sample is None:
            continue
        pred = generator(sample, rng)
        refs.append(sample["answer"])
        hyps.append(pred)
        result.rows.append({"question": sample.get("prompt_question",
                                                   sample.get("question")),
                            "reference": sample["answer"], "prediction": pred})
    if green_scorer is not None and refs:
        green = green_scorer(refs, hyps)
        result.metrics["green_mean"] = green.mean
        result.metrics["green_std"] = green.std
        for row, score in zip(result.rows, green.scores):
            row["green"] = score
    return result


def evaluate_vqa(dataset, generator: ReportGenerator, max_cases: int = 10**9,
                 seed: int = 0) -> EvalResult:
    """Choice-letter VQA accuracy (eval/vqa.py:66-139): compare the first
    letter of the generation against the answer choice."""
    rng = _case_generator(generator, seed)
    result = EvalResult()
    answers, preds = [], []
    for idx in range(min(max_cases, len(dataset))):
        sample = dataset[idx]
        if sample is None:
            continue
        pred = generator(sample, rng)
        gold = sample.get("answer_choice") or sample["answer"]
        answers.append(str(gold))
        preds.append(pred)
        result.rows.append({"question": sample["question"],
                            "answer": str(gold), "prediction": pred})
    result.metrics["accuracy"] = exact_match_accuracy(answers, preds)
    return result


GREEN_ERRORS = ("false_report", "missing_finding", "wrong_location",
                "wrong_severity", "extra_comparison", "missing_comparison")


def evaluate_benchmark(
    refs: Sequence[str], hyps: Sequence[str],
    green_scorer: Optional[GreenScorer] = None,
    compute_bertscore: bool = True,
) -> Dict[str, float]:
    """Full NLG metric battery over (reference, prediction) pairs
    (evalscipt/ourmodel_amos.py:86-133): BLEU-1, ROUGE-1/2/L, METEOR,
    BERTScore-F1, GREEN mean/std + per-error-type accuracy breakdown."""
    per_pair = [score_report(r, h) for r, h in zip(refs, hyps)]
    metrics: Dict[str, float] = {}
    for key in ("bleu1", "rouge1_f", "rouge2_f", "rougeL_f", "meteor"):
        metrics[key] = float(np.mean([p[key] for p in per_pair])) if per_pair else 0.0

    if compute_bertscore:
        f1 = bert_score_f1(refs, hyps)
        if f1 is not None:
            metrics["bertscore_f1"] = float(np.mean(f1))

    if green_scorer is not None and refs:
        green = green_scorer(refs, hyps)
        metrics["green_mean"] = green.mean
        metrics["green_std"] = green.std
        counts = np.array([row["error_counts"] for row in green.rows])
        if len(counts):
            for i, name in enumerate(GREEN_ERRORS):
                metrics[f"green_err_{name}"] = float(np.mean(counts[:, i]))
            metrics["green_matched_findings"] = float(np.mean(counts[:, 6]))
    return metrics


def evaluate_by_body_part(
    cases: Sequence[dict], predict: Callable[[dict], str],
    parts: Sequence[str] = ("chest", "abdomen", "pelvis"),
    green_scorer: Optional[GreenScorer] = None,
) -> Dict[str, Dict[str, float]]:
    """AMOS-MM protocol: metrics per body part + overall
    (evalscipt/ourmodel_amos.py:182-271). Each case dict needs
    {body_part, reference} and is scored against predict(case)."""
    refs_by_part: Dict[str, List[str]] = {p: [] for p in parts}
    hyps_by_part: Dict[str, List[str]] = {p: [] for p in parts}
    for case in cases:
        part = case.get("body_part", parts[0])
        if part not in refs_by_part:
            refs_by_part[part] = []
            hyps_by_part[part] = []
        refs_by_part[part].append(case["reference"])
        hyps_by_part[part].append(predict(case))
    out: Dict[str, Dict[str, float]] = {}
    all_refs: List[str] = []
    all_hyps: List[str] = []
    for part in refs_by_part:
        if refs_by_part[part]:
            out[part] = evaluate_benchmark(refs_by_part[part],
                                           hyps_by_part[part], green_scorer,
                                           compute_bertscore=False)
            all_refs.extend(refs_by_part[part])
            all_hyps.extend(hyps_by_part[part])
    out["overall"] = evaluate_benchmark(all_refs, all_hyps, green_scorer,
                                        compute_bertscore=False)
    return out


def evaluate_predictions(rows: Sequence[dict],
                         green_scorer: Optional[GreenScorer] = None,
                         compute_bertscore: bool = True) -> EvalResult:
    """Score any model's predictions jsonl with the full battery.

    Covers the reference's comparative benchmark scripts (evalscipt/m3d_*.py,
    radfm_*.py, CT-CHAT_ctrate.py), which all reduce to (reference,
    prediction) pairs fed to the same metrics. Rows need {"answer" |
    "reference", and "prediction" | "predictions"[0]}; an optional
    "body_part" adds the AMOS per-part breakdown
    (evalscipt/ourmodel_amos.py:182-271).
    """
    result = EvalResult()
    refs, hyps, parts = [], [], []
    for row in rows:
        ref = row.get("reference", row.get("answer"))
        hyp = row.get("prediction")
        if hyp is None:
            preds = row.get("predictions") or []
            hyp = preds[0] if preds else None
        if ref is None or hyp is None:
            continue
        refs.append(ref)
        hyps.append(hyp)
        parts.append(row.get("body_part"))
        result.rows.append({"reference": ref, "prediction": hyp,
                            **({"body_part": row["body_part"]}
                               if row.get("body_part") else {}),
                            **score_report(ref, hyp)})
    result.metrics = evaluate_benchmark(
        refs, hyps, green_scorer, compute_bertscore=compute_bertscore)
    if any(p for p in parts):
        seen = sorted({p for p in parts if p})
        for part in seen:
            pr = [r for r, p in zip(refs, parts) if p == part]
            ph = [h for h, p in zip(hyps, parts) if p == part]
            sub = evaluate_benchmark(pr, ph, None, compute_bertscore=False)
            for k, v in sub.items():
                result.metrics[f"{part}_{k}"] = v
    return result


LLM_JUDGE_SYSTEM = "You are an AI assistant, please evaluate based on the following."

LLM_JUDGE_TEMPLATE = (
    "Please refer to the ground truth and the prediction below. Identify "
    "the clinical aspects mentioned in the ground truth, then compute what "
    "percentage of those aspects the prediction states correctly or "
    "partially matches, as a score from 0 to 100.\n"
    "ground truth: {answer}\n"
    "prediction: {pred}\n\n"
    "The output format is:\nScore: xx."
)


def evaluate_with_llm(rows: Sequence[dict], backend,
                      max_rows: Optional[int] = None) -> Dict[str, float]:
    """LLM-as-judge caption scoring (M3D-Bench eval/eval_with_llm.py
    protocol): ask a judge LLM for the percentage of ground-truth aspects
    matched by the prediction, parse 'Score: xx'. ``backend`` is any
    prompt->text callable (an OpenAI-protocol client against
    ``cli serve-llm``, or a stub).

    Rows: {"answer"|"reference", "prediction"}. Returns mean/valid counts;
    unparseable judge outputs are dropped (the reference writes 'NA').
    """
    scores: List[float] = []
    invalid = 0
    for i, row in enumerate(rows):
        if max_rows is not None and i >= max_rows:
            break
        answer = row.get("reference", row.get("answer"))
        pred = row.get("prediction")
        if answer is None or pred is None:
            continue
        prompt = LLM_JUDGE_TEMPLATE.format(answer=answer, pred=pred)
        out = backend(prompt, system=LLM_JUDGE_SYSTEM) \
            if _accepts_system(backend) else backend(prompt)
        match = re.search(r"Score:\s*(\d+(?:\.\d+)?)", out)
        if match:
            scores.append(float(match.group(1)))
        else:
            invalid += 1
    return {
        "llm_score_mean": float(np.mean(scores)) if scores else float("nan"),
        "llm_score_count": float(len(scores)),
        "llm_score_invalid": float(invalid),
    }


def _accepts_system(backend) -> bool:
    try:
        return "system" in inspect.signature(backend).parameters
    except (TypeError, ValueError):
        return False
