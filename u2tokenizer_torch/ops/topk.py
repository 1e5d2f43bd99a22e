"""Token selection for the μ²tokenizer."""

from __future__ import annotations

import torch


def hard_topk_select(x: torch.Tensor, scores: torch.Tensor,
                     k: int) -> torch.Tensor:
    """x (B, S, E), scores (B, S) -> (B, k, E): the k highest-scoring tokens
    ordered by descending score. Tied scores may order differently from
    ``jax.lax.top_k``."""
    idx = torch.topk(scores, k, dim=-1, sorted=True).indices
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
