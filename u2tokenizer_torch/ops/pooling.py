"""Pooling ops: multi-scale token pooling (fixed, or gated as DMTP) and the
SPP projector's two pools, 3D over the declared grid and 1D over the
sequence."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def avg_pool_tokens(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Non-overlapping average pool over the token axis of (B, S, E);
    trailing tokens that do not fill a window are dropped."""
    if scale == 1:
        return x
    b, s, e = x.shape
    s_out = s // scale
    return x[:, :s_out * scale].reshape(b, s_out, scale, e).mean(dim=2)


def multi_scale_pool(x: torch.Tensor,
                     scales: Sequence[int] = (1, 2, 4)) -> torch.Tensor:
    """Concat of average pools at each scale: S=1024 with (1, 2, 4) gives
    1024 + 512 + 256 = 1792 tokens."""
    return torch.cat([avg_pool_tokens(x, s) for s in scales
                      if x.shape[1] >= s], dim=1)


def dynamic_multi_scale_pool(
        x: torch.Tensor, gate_kernel: torch.Tensor, gate_bias: torch.Tensor,
        scales: Sequence[int] = (1, 2, 4)) -> torch.Tensor:
    """DMTP: the pools of ``multi_scale_pool``, each scaled by a softmax
    over scales of one gate a scale, the gate ``mean(pool) @ gate_kernel +
    gate_bias`` with gate_kernel (E, 1) and gate_bias (1,)."""
    pooled = [avg_pool_tokens(x, s) for s in scales if x.shape[1] >= s]
    gates = torch.cat([p.mean(dim=1) @ gate_kernel + gate_bias
                       for p in pooled], dim=1)  # (B, num_scales)
    weights = torch.softmax(gates, dim=1)
    return torch.cat([p * weights[:, i, None, None]
                      for i, p in enumerate(pooled)], dim=1)


def spatial_pool_3d(x: torch.Tensor, grid: Tuple[int, int, int],
                    pool: int) -> torch.Tensor:
    """(B, S, E) tokens viewed as the *declared* 3D ``grid``, average-pooled
    with kernel = stride = ``pool``, flattened back to tokens."""
    b, s, e = x.shape
    g0, g1, g2 = grid
    if s != g0 * g1 * g2:
        raise ValueError(f"token count {s} != grid {grid}")
    o0, o1, o2 = g0 // pool, g1 // pool, g2 // pool
    x = x.reshape(b, g0, g1, g2, e)[:, :o0 * pool, :o1 * pool, :o2 * pool]
    x = x.reshape(b, o0, pool, o1, pool, o2, pool, e)
    return x.mean(dim=(2, 4, 6)).reshape(b, o0 * o1 * o2, e)


def sequence_pool(x: torch.Tensor, pool: int) -> torch.Tensor:
    """The SPP projector's 'sequence' pooling: a 1-D average pool of (B, S,
    E) tokens in sequence order with kernel = stride = ``pool ** 3``."""
    return avg_pool_tokens(x, pool ** 3)
