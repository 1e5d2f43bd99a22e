"""CT volume preprocessing on the device (counterpart of the validation path
of ``u2tokenizer_tpu/data/transforms.py``): NIfTI path -> (T, 32, 256, 256)
float32 chunks.

The steps are the JAX package's Python path (``use_native=False``): the
(X, Y, Z) volume as (1, Z, X, Y), percentile windowing (0.5 and 99.5 to
[0, 1], clipped), a crop to the bounding box of voxels > 0, an
aspect-preserving resize so that min(X, Y) fits the target (anti-aliased
with a Gaussian of sigma (factor - 1) / 2, then trilinear at
``align_corners`` coordinates; Z is resized only when deeper than the
chunks hold), zero padding to (target, target, depth), and (Z, X, Y) cut
into chunks. Here each step is a torch function that runs where its input
lies, in fp32, so that a raw volume of a few hundred MB is not ground
through numpy on the host; the JAX package computes in float64 with numpy
and scipy. The two agree to about 1e-5 on the [0, 1] output
(``tests/test_torch_transforms.py`` holds 1e-4).

* Percentiles follow ``np.percentile``'s linear rule, value at index
  q/100 (n - 1), read from one ``torch.sort`` of the volume
  (``torch.quantile`` refuses inputs over 2^24 elements, and a 512x512x300
  CT has 78 M; four ``torch.kthvalue`` calls took 2.28 s on an H100 at
  that size, ``chip_smoke.py``'s ingest check).
* The Gaussian is scipy's ``gaussian_filter``: per axis with sigma > 0, a
  normalised kernel of radius int(4 sigma + 0.5), the edge handled as
  scipy's ``mode="reflect"`` (d c b a | a b c d), built by index; the taps
  are summed one by one (no convolution, so no TF32 rounding).
* The interpolation is ``map_coordinates(order=1, mode="nearest")`` at
  ``linspace`` coordinates, which on a grid is linear interpolation along
  each axis in turn; an output size of 1 takes the centre.

Training augmentations and the 'linear' (non-u2) transform are not ported
yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..models.u2_model import resolve_device
from .nifti import read_nifti_raw, scaling_applies


def percentiles(x: torch.Tensor, qs: Sequence[float]) -> list:
    """``np.percentile(x, qs)`` (linear interpolation) of all of ``x``'s
    elements, as Python floats, from one sort of them."""
    flat = torch.sort(x.reshape(-1)).values
    n = flat.numel()
    pos = [q / 100.0 * (n - 1) for q in qs]
    lo = [int(np.floor(p)) for p in pos]
    idx = torch.tensor([i for j in lo for i in (j, min(j + 1, n - 1))],
                       device=flat.device)
    ends = flat[idx].double().tolist()
    out = []
    for p, j, a, b in zip(pos, lo, ends[0::2], ends[1::2]):
        t = p - j
        # numpy's _lerp: from the nearer end, so t = 1 gives b exactly
        out.append(a + (b - a) * t if t < 0.5 else b - (b - a) * (1 - t))
    return out


def scale_intensity_range_percentiles(
        x: torch.Tensor, lower: float = 0.5, upper: float = 99.5,
        b_min: float = 0.0, b_max: float = 1.0,
        clip: bool = True) -> torch.Tensor:
    """MONAI ScaleIntensityRangePercentiles (relative=False)."""
    a_min, a_max = percentiles(x, (lower, upper))
    if a_max == a_min:
        out = x - a_min + b_min
    else:
        out = (x - a_min) / (a_max - a_min) * (b_max - b_min) + b_min
    if clip:
        out = out.clamp(min(b_min, b_max), max(b_min, b_max))
    return out


def crop_foreground(x: torch.Tensor, margin: int = 0) -> torch.Tensor:
    """MONAI CropForeground (select_fn > 0): x (C, *spatial) cropped to the
    bounding box of positive voxels over all spatial axes; returned as it
    is when no voxel is positive."""
    mask = (x > 0).any(dim=0)
    if not bool(mask.any()):
        return x
    slices = [slice(None)]
    for ax in range(mask.ndim):
        other = tuple(i for i in range(mask.ndim) if i != ax)
        idx = torch.nonzero(mask.any(dim=other))[:, 0]
        first, last = int(idx[0]), int(idx[-1])
        slices.append(slice(max(0, first - margin),
                            min(mask.shape[ax], last + 1 + margin)))
    return x[tuple(slices)]


def _reflect_index(n: int, radius: int, device) -> torch.Tensor:
    """Indices of an axis of length n padded by ``radius`` on each side as
    scipy's mode="reflect" pads (d c b a | a b c d | d c b a ...)."""
    i = torch.arange(-radius, n + radius, device=device) % (2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def gaussian_filter_axis(x: torch.Tensor, axis: int,
                         sigma: float) -> torch.Tensor:
    """scipy's ``gaussian_filter1d(x, sigma, axis, truncate=4.0,
    mode="reflect")``."""
    radius = int(4.0 * sigma + 0.5)
    taps = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-0.5 / (sigma * sigma) * taps ** 2)
    w = (w / w.sum()).tolist()
    n = x.shape[axis]
    padded = x.index_select(axis, _reflect_index(n, radius, x.device))
    out = padded.narrow(axis, 0, n) * w[0]
    for t in range(1, 2 * radius + 1):
        out += padded.narrow(axis, t, n) * w[t]
    return out


def _linear_axis(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    """Linear interpolation along ``axis`` at ``np.linspace(0, n - 1,
    out_size)`` (the centre when ``out_size`` is 1), reads past the last
    sample clamped to it."""
    n = x.shape[axis]
    c = (np.linspace(0, n - 1, out_size) if out_size > 1
         else np.array([(n - 1) / 2.0]))
    lo = np.floor(c).astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    shape = [1] * x.ndim
    shape[axis] = out_size
    t = torch.as_tensor(c - lo, dtype=x.dtype, device=x.device).reshape(shape)
    a = x.index_select(axis, torch.as_tensor(lo, device=x.device))
    b = x.index_select(axis, torch.as_tensor(hi, device=x.device))
    return a + (b - a) * t


def resize_trilinear(x: torch.Tensor, out_size: Tuple[int, ...],
                     anti_aliasing: bool = True) -> torch.Tensor:
    """Anti-aliased, ``align_corners`` trilinear resize of a (*spatial,)
    tensor; returned as it is when the sizes are equal."""
    in_size = tuple(x.shape)
    if in_size == tuple(out_size):
        return x
    if anti_aliasing:
        for ax, (i, o) in enumerate(zip(in_size, out_size)):
            sigma = max(0.0, (i / o - 1.0) / 2.0)
            if sigma > 1e-15:  # scipy skips the axes it would not blur
                x = gaussian_filter_axis(x, ax, sigma)
    for ax, o in enumerate(out_size):
        x = _linear_axis(x, ax, o)
    return x


class U2VolumeTransform:
    """The u2 ingest on ``device`` (the GPU unless the caller names
    another): NIfTI path, or (X, Y, Z) voxel array, -> (num_chunks,
    chunk_depth, target_size, target_size) float32 tensor on that device.
    The defaults are the reference's: target 256 and depth 256, 8 chunks of
    32. Only the validation mode exists."""

    def __init__(self, data_type: str = "validation", target_size: int = 256,
                 chunk_depth: int = 32, num_chunks: int = 8, device="cuda"):
        if data_type in ("training", "train"):
            raise NotImplementedError(
                "training augmentations are not ported yet")
        self.device = resolve_device(device)
        self.target_size = target_size
        self.chunk_depth = chunk_depth
        self.num_chunks = num_chunks

    def __call__(self, path: str) -> torch.Tensor:
        raw, slope, inter = read_nifti_raw(path)
        vol = torch.from_numpy(raw.astype(raw.dtype.newbyteorder("=")))
        vol = vol.to(self.device).float()
        if scaling_applies(slope, inter):
            vol = vol * (slope if slope != 0.0 else 1.0) + inter
        return self.from_array(vol)

    def from_array(self, vol) -> torch.Tensor:
        """vol: the (X, Y, Z) voxels (nibabel's layout), numpy or torch."""
        target = self.target_size
        depth = self.chunk_depth * self.num_chunks
        x = torch.as_tensor(vol).to(self.device, torch.float32)
        x = x.permute(2, 0, 1)[None]  # (1, Z, X, Y)
        x = scale_intensity_range_percentiles(x)
        x = crop_foreground(x)
        x = x[0].permute(1, 2, 0)  # (X, Y, Z)

        ratio = min(target / x.shape[0], target / x.shape[1])
        sx, sy = int(x.shape[0] * ratio), int(x.shape[1] * ratio)
        sz = x.shape[2] if depth >= x.shape[2] else depth
        x = resize_trilinear(x, (sx, sy, sz))

        out = torch.zeros(target, target, depth, device=self.device)
        out[:sx, :sy, :sz] = x
        out = out.permute(2, 0, 1)  # (Z, X, Y)
        return out.reshape(self.num_chunks, self.chunk_depth, target, target)
