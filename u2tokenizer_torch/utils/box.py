"""3D box / grounding utilities (a copy of ``u2tokenizer_tpu/utils/box.py``).

Behavioral rebuild of src/utils/utils.py:5-56: mask -> normalized 3D bbox,
box extraction from generated text, and IoU for PosREC/PosREG evaluation
(eval/M3D-Bench/eval/metrics.py box metrics).
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

import numpy as np


def mask_to_box(mask: np.ndarray) -> Optional[List[float]]:
    """Binary 3D mask -> normalized [z1, y1, x1, z2, y2, x2] in [0, 1]."""
    idx = np.argwhere(mask > 0)
    if idx.size == 0:
        return None
    lo = idx.min(axis=0).astype(float)
    hi = (idx.max(axis=0) + 1).astype(float)
    dims = np.array(mask.shape, float)
    return list(np.concatenate([lo / dims, hi / dims]))


def box_to_text(box: Sequence[float], decimals: int = 2) -> str:
    """Normalized box -> the bracketed text form used in prompts/answers,
    e.g. '[0.12, 0.30, 0.05, 0.60, 0.88, 0.95]'."""
    return "[" + ", ".join(f"{v:.{decimals}f}" for v in box) + "]"


_BOX_RE = re.compile(r"\[([^\[\]]+)\]")


def extract_box_from_text(text: str) -> Optional[List[float]]:
    """First bracketed 6-number group in generated text -> box, else None."""
    for m in _BOX_RE.finditer(text):
        parts = [p.strip() for p in m.group(1).split(",")]
        try:
            vals = [float(p) for p in parts]
        except ValueError:
            continue
        if len(vals) == 6:
            return vals
    return None


def box_iou_3d(a: Sequence[float], b: Sequence[float]) -> float:
    """IoU of two [z1,y1,x1,z2,y2,x2] boxes (any consistent normalization)."""
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    lo = np.maximum(a[:3], b[:3])
    hi = np.minimum(a[3:], b[3:])
    inter = float(np.prod(np.clip(hi - lo, 0, None)))
    vol_a = float(np.prod(np.clip(a[3:] - a[:3], 0, None)))
    vol_b = float(np.prod(np.clip(b[3:] - b[:3], 0, None)))
    union = vol_a + vol_b - inter
    return inter / union if union > 0 else 0.0


def dice_score(pred: np.ndarray, target: np.ndarray, eps: float = 1e-8) -> float:
    """Soft Dice over binary masks (M3D-Bench seg metric)."""
    pred = np.asarray(pred > 0.5, np.float64)
    target = np.asarray(target > 0.5, np.float64)
    inter = float((pred * target).sum())
    return (2 * inter + eps) / (pred.sum() + target.sum() + eps)
