"""AMOS-MM and CT-RATE datasets and the offline volume resizers
(counterpart of ``u2tokenizer_tpu/data/amos_ct_datasets.py``).

Behavioral rebuilds of:
  * src/dataset/amos_mm_monai_dataset.py:36-338 — MRGDataset: AMOS-MM
    dataset.json annotations with per-body-part findings; linear-mode ingest
    (normalize -> flip/rotate90 -> crop -> resize to (32, 256, 256)); empty
    findings resample another case; fixed per-part prompt (clean spelling,
    as the JAX package's).
  * src/dataset/ct_rate_dataset.py:9-169 — CapDataset over the CT-RATE
    layout: VolumeName 'train_<a>_<b>_<c>.nii.gz' lives under
    train/train_<a>/train_<a>_<b>/; min-max + trilinear resize ingest
    (NIfTIProcessor).
  * src/utils/ct_rate_reduction.py / abdomen_atlas_reduction.py — offline
    bulk adaptive-resize of NIfTI archives.

The ingests run on ``device`` (the GPU unless the caller names another)
through the port's ``data/transforms.py`` steps in fp32, where the JAX
package computes in float64 with numpy and scipy; items come out on the
CPU, as ``FusedDataset``'s do (token arrays int64, attention masks
int32). The training jitter of ``linear_ingest`` takes its draws from a
``TorchDraws`` the dataset owns, seeded by ``seed``, in numpy's order (a
gate, then a value, for the scale and then the shift), so the two packages
jitter alike only when given the same draws. The empty-findings resample
keeps the standard library's ``random.Random(seed)``, so its indices equal
the JAX package's.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.u2_model import resolve_device
from .nifti import write_nifti
from .transforms import (TorchDraws, _upload_nifti, crop_foreground,
                         normalize_ct, resize_trilinear)

IGNORE_INDEX = -100

BODY_PARTS = ("chest", "abdomen", "pelvis")


def mrg_prompt(body_part: str) -> str:
    """Per-part MRG prompt (amos_mm_monai_dataset.py:138 uses a fixed string;
    spelling normalized, as the JAX package's)."""
    return ("please provide a detailed caption outlining the findings in "
            f"{body_part} of this image.")


def _encode_padded(tokenizer, text: str, max_length: int):
    ids = tokenizer(text)["input_ids"][:max_length]
    out = torch.full((max_length,), tokenizer.pad_token_id,
                     dtype=torch.int64)
    out[: len(ids)] = torch.tensor(ids, dtype=torch.int64)
    mask = torch.zeros(max_length, dtype=torch.int32)
    mask[: len(ids)] = 1
    return out, mask, len(ids)


def _qa_tensors(tokenizer, question: str, answer: str, max_length: int):
    input_id, attention_mask, valid_len = _encode_padded(
        tokenizer, question + " " + answer, max_length)
    if valid_len < max_length:
        input_id[valid_len] = tokenizer.eos_token_id
    _, _, qlen = _encode_padded(tokenizer, question, max_length)
    label = input_id.clone()
    label[:qlen] = IGNORE_INDEX
    label[label == tokenizer.pad_token_id] = IGNORE_INDEX
    if tokenizer.pad_token_id == tokenizer.eos_token_id and valid_len < max_length:
        label[valid_len] = tokenizer.eos_token_id
    return input_id, attention_mask, label


def linear_ingest(path: str, out_shape=(32, 256, 256),
                  training: bool = False, draws=None,
                  device="cuda") -> torch.Tensor:
    """AMOS linear-mode ingest on ``device``: normalize -> flip z -> rot90
    over (X, Y) -> crop -> resize without anti-aliasing
    (amos_mm_monai_dataset.py:57-76) -> (1, 32, 256, 256) float32 there.
    In training, ``draws`` (``random()``, ``uniform(low, high)``: a
    ``TorchDraws`` or numpy Generator) gates and sizes an intensity scale
    and then a shift."""
    x = normalize_ct(_upload_nifti(path, resolve_device(device)))
    x = torch.flip(x, dims=(3,))              # Flip(spatial_axis=2) on (Z, X, Y)
    x = torch.rot90(x, 1, dims=(1, 2))        # Rotate90 spatial_axes (0, 1)
    x = crop_foreground(x.contiguous())
    resized = resize_trilinear(x[0], tuple(out_shape), anti_aliasing=False)
    if training and draws is not None:
        if draws.random() < 0.5:
            resized = resized * (1.0 + draws.uniform(-0.1, 0.1))
        if draws.random() < 0.5:
            resized = resized + draws.uniform(-0.1, 0.1)
    return resized[None].float()


class AMOSMRGDataset:
    """AMOS-MM medical report generation, one body part per instance."""

    def __init__(self, image_dir: str, json_path: str, tokenizer,
                 max_length: int, image_tokens_num: int = 256,
                 categorize: Tuple[str, str] = ("findings", "chest"),
                 data_type: str = "training", seed: Optional[int] = None,
                 device="cuda"):
        if categorize[1] not in BODY_PARTS:
            raise ValueError(f"categorize[1] must be one of {BODY_PARTS}")
        if data_type not in ("training", "validation", "testing"):
            raise ValueError("data_type must be training|validation|testing")
        self.image_dir = image_dir
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.image_tokens = "<im_patch>" * image_tokens_num
        self.categorize = categorize
        self.data_type = data_type
        self.device = resolve_device(device)
        with open(json_path) as f:
            self.annotations = json.load(f)[data_type]
        self.training = data_type == "training"
        self.draws = TorchDraws(seed)
        self._pyrng = random.Random(seed)

    def __len__(self):
        return len(self.annotations)

    def __getitem__(self, idx: int):
        ann = self.annotations[idx]
        image_path = os.path.join(self.image_dir, ann["image"])
        if not os.path.exists(image_path):
            print(f"Image file not found: {image_path}")
            return None
        answer = ann["labels"]["report"][self.categorize[0]][self.categorize[1]]
        if not answer:
            # empty findings: resample (amos_mm_monai_dataset.py:147-148)
            return self[self._pyrng.randint(0, len(self) - 1)]
        image = linear_ingest(image_path, training=self.training,
                              draws=self.draws, device=self.device).cpu()
        raw_q = mrg_prompt(self.categorize[1])
        question = self.image_tokens + raw_q
        input_id, attention_mask, label = _qa_tensors(
            self.tokenizer, question, answer, self.max_length)
        q_ids, _, _ = _encode_padded(self.tokenizer, raw_q, self.max_length)
        return {
            "image": image,
            "image_path": image_path,
            "input_id": input_id,
            "label": label,
            "attention_mask": attention_mask,
            "question": question,
            "prompt_question": raw_q,
            "question_ids": q_ids,
            "answer": answer,
            "body_part": self.categorize[1],
            "question_type": "Caption",
        }


def ct_rate_volume_path(volume_name: str) -> str:
    """CT-RATE nested layout: 'train_17_2_3.nii.gz' ->
    'train/train_17/train_17_2/train_17_2_3.nii.gz'
    (ct_rate_dataset.py path derivation)."""
    stem = volume_name.replace(".nii.gz", "").replace(".nii", "")
    parts = stem.split("_")
    split = parts[0]
    lvl1 = "_".join(parts[:2])
    lvl2 = "_".join(parts[:3])
    return os.path.join(split, lvl1, lvl2, volume_name)


def minmax_resize_ingest(path: str, output_size=(32, 256, 256),
                         device="cuda") -> torch.Tensor:
    """NIfTIProcessor.scale_image semantics (src/utils/NIfTI_processor.py:7-60)
    on ``device``: min-max normalize + trilinear resize without
    anti-aliasing, one chunk -> (1, *output_size) float32 there."""
    vol = _upload_nifti(path, resolve_device(device))
    x = vol.permute(2, 0, 1)  # (Z, X, Y)
    lo, hi = x.min().item(), x.max().item()
    x = (x - lo) / max(hi - lo, 1e-8)
    x = resize_trilinear(x, tuple(output_size), anti_aliasing=False)
    return x[None].float()


class CTRateCapDataset:
    """CT-RATE caption dataset: {VolumeName, question, answer} rows."""

    def __init__(self, image_dir: str, annotations: List[Dict], tokenizer,
                 max_length: int, image_tokens_num: int = 256,
                 output_size=(32, 256, 256), seed: Optional[int] = None,
                 device="cuda"):
        self.image_dir = image_dir
        self.annotations = annotations
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.image_tokens = "<im_patch>" * image_tokens_num
        self.output_size = output_size
        self.device = resolve_device(device)
        self._pyrng = random.Random(seed)

    @classmethod
    def from_json(cls, image_dir: str, json_path: str, *a, **kw):
        with open(json_path) as f:
            return cls(image_dir, json.load(f), *a, **kw)

    def __len__(self):
        return len(self.annotations)

    def __getitem__(self, idx: int):
        ann = self.annotations[idx]
        name = ann.get("VolumeName") or ann["image"]
        rel = ct_rate_volume_path(name) if "VolumeName" in ann else name
        path = os.path.join(self.image_dir, rel)
        try:
            image = minmax_resize_ingest(path, self.output_size,
                                         self.device).cpu()
        except Exception as e:  # noqa: BLE001 — a bad volume is skipped
            print(f"Error loading {path}: {e}")
            return None  # collate drops None (ct_rate_dataset.py:155-168)
        raw_q = ann.get("question", "Please describe the findings of this CT.")
        answer = ann["answer"]
        question = self.image_tokens + raw_q
        input_id, attention_mask, label = _qa_tensors(
            self.tokenizer, question, answer, self.max_length)
        q_ids, _, _ = _encode_padded(self.tokenizer, raw_q, self.max_length)
        return {
            "image": image,
            "image_path": path,
            "input_id": input_id,
            "label": label,
            "attention_mask": attention_mask,
            "question": question,
            "prompt_question": raw_q,
            "question_ids": q_ids,
            "answer": answer,
            "question_type": "Caption",
        }


# ---------------------------------------------------------------------------
# offline resizers (src/utils/ct_rate_reduction.py, abdomen_atlas_reduction.py)
# ---------------------------------------------------------------------------

def adaptive_resize_file(in_path: str, out_path: str,
                         target_image_size: int = 256,
                         device="cuda") -> None:
    """Shrink one NIfTI so max(X, Y) == target (aspect preserved), keeping
    Z, by the anti-aliased trilinear resize on ``device``; written as
    float32 NIfTI. The bulk offline reduction the reference runs over
    CT-RATE/AbdomenAtlas."""
    vol = _upload_nifti(in_path, resolve_device(device))
    ratio = min(target_image_size / vol.shape[0],
                target_image_size / vol.shape[1])
    if ratio < 1.0:
        vol = resize_trilinear(
            vol, (max(1, int(vol.shape[0] * ratio)),
                  max(1, int(vol.shape[1] * ratio)), vol.shape[2]))
    write_nifti(out_path, vol.cpu().numpy().astype(np.float32))


def bulk_adaptive_resize(image_dir: str, out_dir: str,
                         target_image_size: int = 256,
                         num_workers: int = 4, device="cuda") -> int:
    """Walk a NIfTI tree and adaptive-resize every volume (host threads
    read and write; the resize runs on ``device``; the reference uses a
    multiprocessing pool, ct_rate_reduction.py:20-40). Returns the number
    of volumes written; a failed one is printed and skipped."""
    import concurrent.futures as cf

    dev = resolve_device(device)
    jobs = []
    for root, _, files in os.walk(image_dir):
        for fname in files:
            if fname.endswith((".nii", ".nii.gz")):
                src = os.path.join(root, fname)
                rel = os.path.relpath(src, image_dir)
                dst = os.path.join(out_dir, rel)
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                jobs.append((src, dst))

    def work(job):
        src, dst = job
        try:
            adaptive_resize_file(src, dst, target_image_size, dev)
            return 1
        except Exception as e:  # noqa: BLE001 — one volume's failure is its own
            print(f"resize failed for {src}: {e}")
            return 0

    with cf.ThreadPoolExecutor(num_workers) as pool:
        return sum(pool.map(work, jobs))
