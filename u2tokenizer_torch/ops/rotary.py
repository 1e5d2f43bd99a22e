"""Rotary position embedding (GPT-NeoX half-rotate layout)."""

from __future__ import annotations

import math

import torch


def llama3_scale_inv_freq(inv_freq: torch.Tensor, factor: float,
                          low_freq_factor: float, high_freq_factor: float,
                          original_max_position: int) -> torch.Tensor:
    """Llama-3.x rope frequency rescaling (HF rope_scaling type 'llama3'):
    low frequencies slowed by ``factor``, high ones kept, the band between
    linearly interpolated."""
    wavelen = 2.0 * math.pi / inv_freq
    low_freq_wavelen = original_max_position / low_freq_factor
    high_freq_wavelen = original_max_position / high_freq_factor
    smooth = (original_max_position / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor)
    smoothed = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    return torch.where(wavelen > low_freq_wavelen, inv_freq / factor,
                       torch.where(wavelen < high_freq_wavelen, inv_freq,
                                   smoothed))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 dtype=torch.float32, scaling=None):
    """cos/sin tables shaped ``positions.shape + (head_dim,)``; dims i and
    i + head_dim/2 share a frequency. ``scaling`` is an optional
    (type, factor, low_freq, high_freq, original_max) tuple, 'llama3' only."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, half, dtype=torch.float32, device=positions.device) / half))
    if scaling is not None and scaling[0]:
        kind, factor, low, high, orig = scaling
        if kind != "llama3":
            raise ValueError(f"unsupported rope scaling: {kind}")
        inv_freq = llama3_scale_inv_freq(inv_freq, factor, low, high, orig)
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(-x2, x1) for x split into halves along the last dim."""
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); cos/sin: (S, D) or (B, S, D)."""
    if cos.ndim < x.ndim:  # insert the head axis
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    return x * cos.to(x.dtype) + rotate_half(x) * sin.to(x.dtype)
