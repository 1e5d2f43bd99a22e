"""Token selection for the μ²tokenizer: hard top-k, and DiffTS's soft
selection (``soft_topk_select``)."""

from __future__ import annotations

import torch


def hard_topk_select(x: torch.Tensor, scores: torch.Tensor,
                     k: int) -> torch.Tensor:
    """x (B, S, E), scores (B, S) -> (B, k, E): the k highest-scoring tokens
    ordered by descending score. Tied scores may order differently from
    ``jax.lax.top_k``."""
    idx = torch.topk(scores, k, dim=-1, sorted=True).indices
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def soft_topk_select(x: torch.Tensor, scores: torch.Tensor,
                     tau: float = 1.0) -> torch.Tensor:
    """DiffTS: x (B, S, E), scores (B, S, K) -> (B, K, E); output token k
    is the softmax(scores[..., k] / tau over S)-weighted sum of all input
    tokens."""
    weights = torch.softmax(scores / tau, dim=1)
    return torch.einsum("bsk,bse->bke", weights, x)
