"""M3D dataset family: caption, VQA (close/open/yes-no), 3D grounding
(PosREC/PosREG), segmentation-referencing datasets and combinators
(counterpart of ``u2tokenizer_tpu/data/m3d_datasets.py``).

Behavioral rebuild of src/dataset/multi_dataset.py (CapDataset:132,
VQADataset:248, VQAYNDataset:366, PosRECDataset:476, PosREGDataset:649,
SegDataset:827, RefSegDataset:992, combinators:1106-1203). Shared recipe:

  * volumes are pre-normalized .npy arrays (C, D, H, W) from the M3D-Cap
    release; training applies the rotate/flip/intensity augmentations
    (``data/transforms.apply_augmentations``, drawn in the JAX package's
    order from a ``TorchDraws`` seeded by ``seed``; a numpy Generator in
    ``draws`` gives the JAX package's volumes).
  * prompt = "<im_patch>"*proj_out_num [+ ' '] + task question; sequence =
    question + ' ' + answer, right-padded; EOS written at the first pad slot;
    labels mask the question span and padding (same as fused_dataset).
  * every sample retries on a corrupted file with a random re-index
    (multi_dataset.py:178-245, max_attempts=100).

Grounding answers embed normalized 3D boxes (utils/box.py); segmentation
answers carry the '[SEG]' marker token (the reference's seg head lives only
in the vendored M3D-LaMed remote code — SURVEY.md §2.8 note)."""

from __future__ import annotations

import csv
import json
import os
import random
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.box import box_to_text, mask_to_box
from .prompt_templates import (
    Caption_templates,
    PosREC_templates,
    PosREG_templates,
    Seg_templates,
)
from .transforms import AugmentConfig, TorchDraws, apply_augmentations

IGNORE_INDEX = -100
MAX_ATTEMPTS = 100


def read_csv_rows(path: str) -> List[Dict[str, str]]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


class M3DBase:
    """Shared volume loading + tokenization recipe."""

    def __init__(self, data_root: str, tokenizer, max_length: int,
                 proj_out_num: int = 256, mode: str = "train",
                 seg_enable: bool = False, seed: Optional[int] = None):
        self.data_root = data_root
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.image_tokens = "<im_patch>" * proj_out_num
        self.mode = mode
        self.training = mode == "train"
        self.seg_enable = seg_enable
        self.draws = TorchDraws(seed)
        self._pyrng = random.Random(seed)

    # -- volume --

    def load_volume(self, rel_path: str) -> np.ndarray:
        image = np.load(os.path.join(self.data_root, rel_path))
        if self.training:
            image = apply_augmentations(torch.from_numpy(image), self.draws,
                                        AugmentConfig()).numpy()
        return image.astype(np.float32)

    # -- tokenization (multi_dataset.py:199-227 recipe) --

    def _pad(self, ids: List[int]):
        ids = ids[: self.max_length]
        out = np.full(self.max_length, self.tokenizer.pad_token_id, np.int32)
        out[: len(ids)] = ids
        mask = np.zeros(self.max_length, np.int32)
        mask[: len(ids)] = 1
        return out, mask, len(ids)

    def encode_qa(self, question: str, answer: str,
                  raw_question: str) -> Dict[str, Any]:
        # Eval modes prompt with the question only (the reference's
        # *TestDataset variants tokenize just the question —
        # eval/M3D-Bench/eval/eval_pos.py:110); training packs Q+A for the
        # teacher-forced LM loss.
        text = question if not self.training else question + " " + answer
        input_id, attention_mask, valid_len = self._pad(
            self.tokenizer(text)["input_ids"])
        if valid_len < self.max_length:
            input_id[valid_len] = self.tokenizer.eos_token_id
        _, _, question_len = self._pad(self.tokenizer(question)["input_ids"])
        question_ids, _, _ = self._pad(
            self.tokenizer(raw_question, add_special_tokens=False)["input_ids"])

        label = input_id.astype(np.int64).copy()
        label[:question_len] = IGNORE_INDEX
        label[label == self.tokenizer.pad_token_id] = IGNORE_INDEX
        if (self.tokenizer.pad_token_id == self.tokenizer.eos_token_id
                and valid_len < self.max_length):
            label[valid_len] = self.tokenizer.eos_token_id
        return {
            "input_id": input_id,
            "label": label,
            "attention_mask": attention_mask,
            "question": question,
            "question_ids": question_ids,
            "answer": answer,
        }

    def build(self, image: np.ndarray, question: str, answer: str,
              raw_question: str, question_type: str,
              seg: Optional[np.ndarray] = None) -> Dict[str, Any]:
        ret = self.encode_qa(question, answer, raw_question)
        ret["image"] = image
        ret["question_type"] = question_type
        if self.seg_enable:
            ret["seg"] = seg if seg is not None else np.zeros_like(image)
        return ret

    def getitem_with_retry(self, idx: int, fetch_at):
        for _ in range(MAX_ATTEMPTS):
            try:
                return fetch_at(idx)
            except Exception as e:
                print(f"Error in __getitem__ at index {idx}: {e}")
                idx = self._pyrng.randint(0, len(self) - 1)
        return None


class M3DCapDataset(M3DBase):
    """Caption dataset over the M3D-Cap json split file
    ({mode: [{image, text}, ...]}) (multi_dataset.py:132-245)."""

    def __init__(self, data_root: str, cap_data_path: str, tokenizer,
                 max_length: int, **kw):
        super().__init__(data_root, tokenizer, max_length, **kw)
        with open(cap_data_path) as f:
            self.data_list = json.load(f)[self.mode]

    def __len__(self):
        return len(self.data_list)

    def __getitem__(self, idx):
        def fetch(i):
            data = self.data_list[i]
            image = self.load_volume(data["image"])
            with open(os.path.join(self.data_root, data["text"])) as f:
                answer = f.read()
            prompt = self._pyrng.choice(Caption_templates).format("findings")
            question = self.image_tokens + prompt
            return self.build(image, question, answer, prompt, "Caption")

        return self.getitem_with_retry(idx, fetch)


class M3DVQADataset(M3DBase):
    """Close/open-ended VQA over the M3D-VQA csv
    (multi_dataset.py:248-363). Close-ended appends the four choices and the
    answer is '<letter>. <text>'."""

    def __init__(self, data_root: str, csv_path: str, tokenizer,
                 max_length: int, close_ended: bool = True, **kw):
        super().__init__(data_root, tokenizer, max_length, **kw)
        self.rows = read_csv_rows(csv_path)
        if self.mode == "validation":
            self.rows = self.rows[:2048]
        self.close_ended = close_ended

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        def fetch(i):
            row = self.rows[i]
            image = self.load_volume(row["Image Path"])
            if self.close_ended:
                question = (f"{row['Question']} Choices: A. {row['Choice A']} "
                            f"B. {row['Choice B']} C. {row['Choice C']} "
                            f"D. {row['Choice D']}")
                answer = f"{row['Answer Choice']}. {row['Answer']}"
            else:
                question = row["Question"]
                answer = str(row["Answer"])
            full_q = self.image_tokens + " " + question
            ret = self.build(image, full_q, answer, question,
                             row.get("Question Type", "VQA"))
            ret["answer_choice"] = row.get("Answer Choice")
            return ret

        return self.getitem_with_retry(idx, fetch)


class M3DVQAYNDataset(M3DVQADataset):
    """Yes/no VQA (multi_dataset.py:366-473): open-ended form whose answers
    are yes/no strings."""

    def __init__(self, data_root: str, csv_path: str, tokenizer,
                 max_length: int, **kw):
        super().__init__(data_root, csv_path, tokenizer, max_length,
                         close_ended=False, **kw)


class M3DPosRECDataset(M3DBase):
    """Referring-expression comprehension: term -> 3D box
    (multi_dataset.py:476-646). Boxes come from the mask npy alongside the
    volume."""

    def __init__(self, data_root: str, seg_data_path: str, tokenizer,
                 max_length: int, tag: str = "0000", description: bool = False,
                 **kw):
        super().__init__(data_root, tokenizer, max_length, **kw)
        from .dataset_info import dataset_info

        self.tag = tag
        self.description = description
        self.terms = dataset_info[tag]
        split_file = os.path.join(seg_data_path, tag, f"{self.mode}.json")
        if os.path.exists(split_file):
            with open(split_file) as f:
                self.data_list = json.load(f)
        else:
            self.data_list = []

    def __len__(self):
        return len(self.data_list)

    def _load_pair(self, entry):
        image = self.load_volume(entry["image"])
        mask = np.load(os.path.join(self.data_root, entry["label"]))
        return image, mask

    def __getitem__(self, idx):
        def fetch(i):
            entry = self.data_list[i]
            image, mask = self._load_pair(entry)
            cls_id = int(entry.get("cls_id", 1))
            term = self.terms[min(cls_id, len(self.terms) - 1)]
            box = mask_to_box(mask[0] if mask.ndim == 4 else mask)
            if box is None:
                raise ValueError("empty mask")
            qtpl = self._pyrng.choice(PosREC_templates["cls_questions"])
            atpl = self._pyrng.choice(PosREC_templates["cls_answers"])
            raw_q = qtpl.format(term)
            answer = atpl.format(term, box_to_text(box))
            question = self.image_tokens + " " + raw_q
            return self.build(image, question, answer, raw_q, "REC")

        return self.getitem_with_retry(idx, fetch)


class M3DPosREGDataset(M3DPosRECDataset):
    """Region grounding: box -> term (multi_dataset.py:649-824)."""

    def __getitem__(self, idx):
        def fetch(i):
            entry = self.data_list[i]
            image, mask = self._load_pair(entry)
            cls_id = int(entry.get("cls_id", 1))
            term = self.terms[min(cls_id, len(self.terms) - 1)]
            box = mask_to_box(mask[0] if mask.ndim == 4 else mask)
            if box is None:
                raise ValueError("empty mask")
            qtpl = self._pyrng.choice(PosREG_templates["cls_questions"])
            atpl = self._pyrng.choice(PosREG_templates["cls_answers"])
            raw_q = qtpl.format(box_to_text(box))
            answer = atpl.format(box_to_text(box), term)
            question = self.image_tokens + " " + raw_q
            return self.build(image, question, answer, raw_q, "REG")

        return self.getitem_with_retry(idx, fetch)


class M3DSegDataset(M3DPosRECDataset):
    """Term -> segmentation mask (multi_dataset.py:827-989); the answer
    carries the '[SEG]' marker and the mask rides in ret['seg']."""

    def __init__(self, *a, **kw):
        kw.setdefault("seg_enable", True)
        super().__init__(*a, **kw)

    def __getitem__(self, idx):
        def fetch(i):
            entry = self.data_list[i]
            image, mask = self._load_pair(entry)
            cls_id = int(entry.get("cls_id", 1))
            term = self.terms[min(cls_id, len(self.terms) - 1)]
            qtpl = self._pyrng.choice(Seg_templates["cls_questions"])
            atpl = self._pyrng.choice(Seg_templates["cls_answers"])
            raw_q = qtpl.format(term)
            answer = atpl.format(term)
            question = self.image_tokens + " " + raw_q
            return self.build(image, question, answer, raw_q, "SEG",
                              seg=mask.astype(np.float32))

        return self.getitem_with_retry(idx, fetch)


class M3DRefSegDataset(M3DBase):
    """Referring segmentation from a csv of (Image, Mask, Question, Answer)
    (multi_dataset.py:992-1103)."""

    def __init__(self, data_root: str, refseg_data_path: str, tokenizer,
                 max_length: int, **kw):
        kw.setdefault("seg_enable", True)
        super().__init__(data_root, tokenizer, max_length, **kw)
        self.rows = read_csv_rows(refseg_data_path)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        def fetch(i):
            row = self.rows[i]
            image = self.load_volume(row["Image"])
            mask = np.load(os.path.join(self.data_root, row["Mask"]))
            raw_q = row["Question"]
            answer = row["Answer"]
            question = self.image_tokens + " " + raw_q
            return self.build(image, question, answer, raw_q, "RefSEG",
                              seg=mask.astype(np.float32))

        return self.getitem_with_retry(idx, fetch)


def truncate_text_random_sentences(text: str, max_tokens: int, tokenizer,
                                   rng: random.Random) -> str:
    """Reference truncate_text (multi_dataset.py:63-89 / fused_dataset.py:78-105):
    keep the first sentence, then add random sentences while the token budget
    allows."""
    def count(t):
        return len(tokenizer.encode(t, add_special_tokens=True)
                   if hasattr(tokenizer, "encode") else tokenizer(t)["input_ids"])

    if count(text) <= max_tokens:
        return text
    sentences = text.split(".")
    selected = []
    current = 0
    if sentences:
        selected.append(sentences.pop(0))
    while current <= max_tokens and sentences:
        cand = rng.choice(sentences)
        n = count(cand)
        if current + n <= max_tokens and cand not in selected:
            selected.append(cand)
            current += n
        else:
            sentences.remove(cand)
    return ".".join(selected)


class M3DITRDataset(M3DBase):
    """Image-text retrieval pairs (multi_dataset.py:21-129): volume + a
    token-budgeted report text, no QA structure. Validation truncates the
    split to 512 rows."""

    def __init__(self, data_root: str, cap_data_path: str, tokenizer,
                 max_length: int, **kw):
        super().__init__(data_root, tokenizer, max_length, **kw)
        with open(cap_data_path) as f:
            self.data_list = json.load(f)[self.mode]
        if self.mode == "validation":
            self.data_list = self.data_list[:512]

    def __len__(self):
        return len(self.data_list)

    def __getitem__(self, idx):
        def fetch(i):
            data = self.data_list[i]
            image = self.load_volume(data["image"])
            with open(os.path.join(self.data_root, data["text"])) as f:
                raw_text = f.read()
            text = truncate_text_random_sentences(
                raw_text, self.max_length, self.tokenizer, self._pyrng)
            input_id, attention_mask, _ = self._pad(
                self.tokenizer(text)["input_ids"])
            return {
                "image": image,
                "text": text,
                "input_id": input_id,
                "attention_mask": attention_mask,
                "question_type": "Image_text_retrieval",
            }

        return self.getitem_with_retry(idx, fetch)


class ConcatDataset:
    """Uniform concatenation (the Multi*/Uni combinators,
    multi_dataset.py:1106-1203)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.lengths = [len(d) for d in self.datasets]
        self.total = sum(self.lengths)

    def __len__(self):
        return self.total

    def __getitem__(self, idx):
        for d, n in zip(self.datasets, self.lengths):
            if idx < n:
                return d[idx]
            idx -= n
        raise IndexError(idx)


def build_uni_datasets(datasets: Sequence) -> ConcatDataset:
    """UniDatasets equivalent: one dataset view over every task."""
    return ConcatDataset(datasets)
