"""Per-dataset synthesis converters: raw dataset files -> Fused jsonl rows
(a copy of ``u2tokenizer_tpu/data/converters.py``; masks are read through
the port's ``data/nifti.py``).

Rebuilds the reference's preprocessing scripts
(src/preprocess/{amos_mm,ct_rate,abdomen_atlas,m3d_refseg}/*.py) as library
functions instead of path-hardcoded mains. Each converter emits the Fused
jsonl schema consumed by FusedDataset ({dataset, image, task_type, question,
answer, ...}); the LLM-backed stages (rewrite / translation / thinking
synthesis) delegate to data/synthesis.py with any OpenAI-protocol backend.
"""

from __future__ import annotations

import json
import os
import random
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np

from .prompt_templates import Caption_templates
from .synthesis import refine_thinking, rewrite_report, translate_report


def _write_jsonl(rows: Iterable[dict], out_path: str) -> int:
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    n = 0
    with open(out_path, "w") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
            n += 1
    return n


def _amos_image(item: dict) -> str:
    # "./imagesTr/x.nii.gz" -> "AMOS-MM/imagesTr/x.nii.gz"
    # (src/preprocess/amos_mm/extract_qa.py:24)
    return "AMOS-MM/" + item["image"][2:]


BODY_PARTS = ("chest", "abdomen", "pelvis")


def amos_mm_extract_qa(dataset_json: str, out_path: str,
                       splits: Sequence[str] = ("validation",)) -> int:
    """AMOS-MM dataset.json -> VQA-choice jsonl
    (src/preprocess/amos_mm/extract_qa.py)."""
    with open(dataset_json) as f:
        data = json.load(f)
    rows = []
    for split in splits:
        for item in data[split]:
            for qa in item.get("labels", {}).get("qa", []):
                opts = qa["options"]
                question = (qa["question"] + " Choices: A. {} B. {} C. {} "
                            "D. {}".format(opts["A"], opts["B"], opts["C"],
                                           opts["D"]))
                rows.append({
                    "dataset": "AMOS-MM", "image": _amos_image(item),
                    "is_extented": False, "meta": item.get("meta"),
                    "task_type": "VQA-Chioce",  # reference key, kept verbatim
                    "question": question, "answer": qa["answer"],
                })
    return _write_jsonl(rows, out_path)


def amos_mm_reports(dataset_json: str, out_path: str,
                    splits: Sequence[str] = ("training",),
                    seed: int = 0) -> int:
    """Per-body-part findings -> caption-question rows
    (src/preprocess/amos_mm/rewrite.py raw pass / qa_fewshot.py base)."""
    rng = random.Random(seed)
    with open(dataset_json) as f:
        data = json.load(f)
    rows = []
    for split in splits:
        for item in data[split]:
            findings = item["labels"]["report"]["findings"]
            for part in BODY_PARTS:
                if findings.get(part):
                    rows.append({
                        "dataset": "AMOS-MM", "image": _amos_image(item),
                        "is_extented": False, "meta": item.get("meta"),
                        "task_type": "VQA", "category": part,
                        "question": rng.choice(Caption_templates).format(
                            f"findings in {part}"),
                        "answer": findings[part],
                    })
    return _write_jsonl(rows, out_path)


def amos_mm_report_choice_questions(dataset_json: str, out_path: str,
                                    splits: Sequence[str] = ("training",),
                                    n_choices: int = 7, seed: int = 0) -> int:
    """Synthetic 'select the correct report' single-choice rows with
    same-part distractors (src/preprocess/amos_mm/report_choice_questions.py).
    """
    rng = random.Random(seed)
    with open(dataset_json) as f:
        data = json.load(f)
    pairs = []
    for split in splits:
        for item in data[split]:
            findings = item["labels"]["report"]["findings"]
            for part in BODY_PARTS:
                if findings.get(part):
                    pairs.append({"image": item["image"], "category": part,
                                  "answer": findings[part]})
    rows = []
    for pair in pairs:
        gt = pair["answer"]
        distractors = [p["answer"] for p in
                       rng.sample(pairs, min(n_choices + 2, len(pairs)))
                       if p["answer"] != gt][: n_choices - 1]
        correct = rng.randint(0, len(distractors))
        choices = distractors[:correct] + [gt] + distractors[correct:]
        question = ("Which of the following is the correct description of "
                    f"the findings in the {pair['category']} of this image?")
        for i, choice in enumerate(choices):
            question += f" {chr(65 + i)}. {choice}"
        rows.append({
            "dataset": "AMOS-MM", "image": pair["image"],
            "task_type": "Select a report", "synthesis": True,
            "question": question,
            "answer": "The correct answer is: " + chr(65 + correct),
        })
    return _write_jsonl(rows, out_path)


def ct_rate_volume_path(volume_name: str) -> str:
    """CT-RATE VolumeName -> nested path (ct_rate/rewrite.py:25-29):
    'train_1_a_1.nii.gz' -> 'train_1/train_1_a/train_1_a_1.nii.gz'."""
    parts = volume_name.split("_")
    top = parts[0] + "_" + parts[1]
    mid = top + "_" + parts[2]
    return f"{top}/{mid}/{volume_name}"


def ct_rate_reports(reports_csv: str, out_path: str, split: str = "train",
                    findings_key: str = "Findings_EN", seed: int = 0) -> int:
    """CT-RATE radiology_text_reports csv -> caption rows
    (src/preprocess/ct_rate/rewrite.py raw pass)."""
    import csv

    rng = random.Random(seed)
    rows = []
    with open(reports_csv) as f:
        for rec in csv.DictReader(f):
            findings = rec.get(findings_key)
            if not findings:
                continue
            rows.append({
                "image": os.path.join(
                    f"CT-RATE/dataset/{split}",
                    ct_rate_volume_path(rec["VolumeName"])),
                "dataset": "CT-RATE", "task_type": "VQA", "synthesis": False,
                "question": rng.choice(Caption_templates).format("findings"),
                "answer": findings,
            })
    return _write_jsonl(rows, out_path)


def abdomen_atlas_reports(report_root_or_rows, out_path: str,
                          seed: int = 0) -> int:
    """AbdomenAtlas per-case reports -> caption rows
    (src/preprocess/abdomen_atlas/rewrite.py shape). Accepts either an
    iterable of {image, answer} dicts or a directory of <case>/report.txt."""
    rng = random.Random(seed)
    if isinstance(report_root_or_rows, str):
        cases = []
        for case in sorted(os.listdir(report_root_or_rows)):
            path = os.path.join(report_root_or_rows, case, "report.txt")
            if os.path.exists(path):
                with open(path) as f:
                    cases.append({"image": f"AbdomenAtlas/{case}/ct.nii.gz",
                                  "answer": f.read().strip()})
    else:
        cases = list(report_root_or_rows)
    rows = [{
        "image": c["image"], "dataset": "AbdomenAtlas", "task_type": "VQA",
        "synthesis": False,
        "question": rng.choice(Caption_templates).format("findings"),
        "answer": c["answer"],
    } for c in cases if c.get("answer")]
    return _write_jsonl(rows, out_path)


def m3d_refseg_convert(csv_path: str, mask_root: str, out_path: str,
                       mask_loader: Optional[Callable] = None) -> int:
    """M3D-RefSeg csv -> SEG rows with '[SEG]' replaced by the flat indices
    of the mask's nonzero voxels (src/preprocess/m3d_refseg/m3d_refseg.py:
    torch.nonzero on the transformed mask)."""
    import csv

    from .nifti import read_nifti

    loader = mask_loader or (lambda p: read_nifti(p).transpose(2, 0, 1))
    rows = []
    with open(csv_path) as f:
        for rec in csv.DictReader(f):
            mask_path = os.path.join(mask_root, rec["Mask"])
            try:
                mask = np.asarray(loader(mask_path))
            except Exception:
                continue
            mask = mask[0] if mask.ndim == 4 else mask
            seq = np.argwhere(mask.reshape(-1) != 0).reshape(-1).tolist()
            rows.append({
                "image": os.path.join("M3D-RefSeg/M3D_RefSeg", rec["Image"]),
                "dataset": "M3D-RefSeg", "task_type": "SEG",
                "synthesis": False, "question": rec["Question"],
                "answer": rec["Answer"].replace("[SEG]", str(seq)),
            })
    return _write_jsonl(rows, out_path)


# --- LLM-backed stages (delegate to data/synthesis.py) ----------------------

def rewrite_jsonl(backend, in_path: str, out_path: str,
                  max_rows: Optional[int] = None) -> int:
    """Paraphrase every answer (amos_mm/ct_rate/abdomen_atlas rewrite.py)."""
    rows = []
    with open(in_path) as f:
        for i, line in enumerate(f):
            if max_rows is not None and i >= max_rows:
                break
            row = json.loads(line)
            row["answer"] = rewrite_report(backend, row["answer"])
            row["synthesis"] = True
            rows.append(row)
    return _write_jsonl(rows, out_path)


def translate_jsonl(backend, in_path: str, out_path: str,
                    max_rows: Optional[int] = None) -> int:
    """EN->ZH report translation rows (report_translation.py)."""
    rows = []
    with open(in_path) as f:
        for i, line in enumerate(f):
            if max_rows is not None and i >= max_rows:
                break
            row = json.loads(line)
            row["answer"] = translate_report(backend, row["answer"])
            row["synthesis"] = True
            row["language"] = "zh"
            rows.append(row)
    return _write_jsonl(rows, out_path)


def thinking_synthesis_jsonl(backend, in_path: str, out_path: str,
                             max_rows: Optional[int] = None) -> int:
    """Chain-of-thought refinement rows (thinking_synthesis.py): the answer
    gains a refined <think> prefix via synthesis.refine_thinking."""
    rows = []
    with open(in_path) as f:
        for i, line in enumerate(f):
            if max_rows is not None and i >= max_rows:
                break
            row = json.loads(line)
            thinking, refined = refine_thinking(
                backend, row["answer"], row["question"], "", row["answer"])
            answer = refined or row["answer"]
            row["answer"] = f"<think>{thinking}</think>{answer}"
            row["synthesis"] = True
            rows.append(row)
    return _write_jsonl(rows, out_path)
