"""Token sampling. The port decodes greedily; nucleus sampling waits."""

from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) -> (B,) int64 argmax token ids."""
    return torch.argmax(logits, dim=-1)


def sample(logits: torch.Tensor, *, do_sample: bool, temperature: float = 1.0,
           top_p: float = 1.0) -> torch.Tensor:
    """(B, V) logits -> (B,) token ids. Only ``do_sample=False`` exists."""
    if do_sample:
        raise NotImplementedError(
            "sampled decoding is not ported yet; use do_sample=False")
    return greedy(logits)
