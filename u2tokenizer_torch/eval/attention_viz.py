"""Attention maps of the μ²tokenizer over a CT volume (counterpart of
``u2tokenizer_tpu/eval/attention_viz.py``), the reference's demo notebook
as a library and ``cli demo --attention out.png``.

``capture_attention_maps`` runs one vision forward with capture on and
returns the first layers' softmax maps; ``render_attention_png`` draws
them into one RGB PNG with the port's own writer (``utils/png.py``; no
matplotlib), in three rows of square panels:
  * each chunk's middle slice in gray under its SVR spatial salience (the
    mean attention each token receives, on the projector's token grid,
    upsampled) as a heat overlay;
  * the SVR temporal T×T map, then the TTA query self-attention, query ->
    visual and query -> text maps, each averaged over heads;
  * the weight each question token receives and the salience of each
    refined visual token, as heat strips.
The colours and pixels are the port's; the maps are the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.png import encode_png

PANEL = 128  # side of a square panel, pixels
GAP = 4      # between panels and at the border
STRIP = 24   # height of a heat strip
ALPHA = 0.45  # weight of the salience over the slice

# anchors of the heat colour map, dark to bright
_HEAT = np.array([[0, 0, 4], [87, 16, 110], [188, 55, 84], [249, 142, 9],
                  [252, 255, 164]], np.float32)


@torch.no_grad()
def capture_attention_maps(model, images, question_ids
                           ) -> Dict[str, np.ndarray]:
    """One vision forward of ``model`` (a ``U2CausalLM``) with attention
    capture, on its device; returns fp32 numpy maps of the first layers
    (the reference captures layer 0 only): ``svr_spatial`` (B, T, H, N,
    N), ``svr_temporal`` (B, N, H, T, T), ``tta_self`` (B, H, Q, Q),
    ``tta_cross_visual`` (B, H, Q, Nv), ``tta_cross_text`` (B, H, Q,
    St)."""
    dev = model.device
    images = torch.as_tensor(images, dtype=torch.float32).to(dev)
    question_ids = torch.as_tensor(question_ids).to(dev)
    b, t = images.shape[:2]
    model.encode_vision_with_attention(images, question_ids)
    svr = model.u2tokenizer.svt_module.layers[0]
    tta = model.u2tokenizer.tta_module.layers_vt[0]
    read = lambda m: m.attn.float().cpu().numpy()
    spatial, temporal = read(svr.spatial_attention), read(
        svr.temporal_attention)
    n = spatial.shape[-1]
    return {"svr_spatial": spatial.reshape(b, t, *spatial.shape[1:]),
            "svr_temporal": temporal.reshape(b, n, *temporal.shape[1:]),
            "tta_self": read(tta.self_attention),
            "tta_cross_visual": read(tta.visual_cross_attention),
            "tta_cross_text": read(tta.text_cross_attention)}


def spatial_salience(maps: Dict[str, np.ndarray],
                     grid_hw: Optional[tuple] = None) -> np.ndarray:
    """Per-token received attention from the SVR spatial map: mean over
    heads and query positions -> (B, T, N), reshaped to (B, T, H', W')
    when ``grid_hw`` (the projector token grid) holds N tokens."""
    sal = maps["svr_spatial"].mean(axis=(2, 3))  # (B, T, N)
    if grid_hw is not None:
        b, t, n = sal.shape
        h, w = grid_hw
        if h * w == n:
            sal = sal.reshape(b, t, h, w)
    return sal


def _upsample2d(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Nearest-neighbour upsample for heatmap overlay (display only)."""
    h, w = img.shape
    ys = (np.arange(out_h) * h // out_h).clip(0, h - 1)
    xs = (np.arange(out_w) * w // out_w).clip(0, w - 1)
    return img[ys][:, xs]


def _unit(x: np.ndarray) -> np.ndarray:
    """Min-max scaled to [0, 1] (a constant array to 0)."""
    x = np.asarray(x, np.float32)
    lo, hi = float(x.min()), float(x.max())
    return (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)


def heat(x: np.ndarray) -> np.ndarray:
    """(..., 3) float RGB in [0, 255] of ``x`` scaled to [0, 1] through the
    heat map's anchors."""
    pos = _unit(x) * (len(_HEAT) - 1)
    lo = np.minimum(pos.astype(np.int64), len(_HEAT) - 2)
    frac = (pos - lo)[..., None]
    return _HEAT[lo] * (1 - frac) + _HEAT[lo + 1] * frac


def png_layout(num_chunks: int) -> Tuple[int, int]:
    """(height, width) of ``render_attention_png``'s image for a volume of
    ``num_chunks`` chunks: three rows of max(T, 4) panels."""
    cols = max(num_chunks, 4)
    return 3 * PANEL + 4 * GAP, cols * PANEL + (cols + 1) * GAP


def render_attention_png(maps: Dict[str, np.ndarray], volume, out_path: str,
                         grid_hw: Optional[tuple] = None) -> str:
    """Draw the captured maps of batch row 0 over ``volume`` (T, D, H, W)
    into the PNG ``out_path`` (``png_layout(T)`` in size); returns the
    path."""
    if torch.is_tensor(volume):
        volume = volume.detach().float().cpu().numpy()
    volume = np.asarray(volume, np.float32)
    t = volume.shape[0]
    height, width = png_layout(t)
    canvas = np.full((height, width, 3), 255.0, np.float32)

    def place(row: int, col: int, tile: np.ndarray) -> None:
        y, x = GAP + row * (PANEL + GAP), GAP + col * (PANEL + GAP)
        canvas[y:y + tile.shape[0], x:x + tile.shape[1]] = tile

    def square(m: np.ndarray) -> np.ndarray:
        return heat(_upsample2d(np.asarray(m, np.float32), PANEL, PANEL))

    sal = spatial_salience(maps, grid_hw)[0]  # (T, N) or (T, H', W')
    for ci in range(t):
        mid = _upsample2d(volume[ci, volume.shape[1] // 2], PANEL, PANEL)
        s = sal[ci]
        if s.ndim == 1:  # no grid: the largest square of tokens
            side = int(np.sqrt(s.shape[0]))
            s = s[: side * side].reshape(side, side)
        gray = np.repeat(_unit(mid)[..., None] * 255.0, 3, axis=-1)
        place(0, ci, (1 - ALPHA) * gray + ALPHA * square(s))

    place(1, 0, square(maps["svr_temporal"][0].mean(axis=(0, 1))))
    place(1, 1, square(maps["tta_self"][0].mean(axis=0)))
    place(1, 2, square(maps["tta_cross_visual"][0].mean(axis=0)))
    place(1, 3, square(maps["tta_cross_text"][0].mean(axis=0)))

    # what each question token and each refined visual token receives
    for col, key in ((0, "tta_cross_text"), (1, "tta_cross_visual")):
        weights = maps[key][0].mean(axis=(0, 1))
        place(2, col, heat(_upsample2d(weights[None], STRIP, PANEL)))

    with open(out_path, "wb") as f:
        f.write(encode_png(np.clip(canvas, 0, 255).astype(np.uint8)))
    return out_path
