"""Token sampling (counterpart of ``u2tokenizer_tpu/ops/sampling.py``):
greedy, temperature and top-p (nucleus), exact under the JAX package's
threshold semantics: a row keeps every logit at or above the smallest one
whose preceding cumulative probability is below ``top_p``, so tokens tied
at the threshold are all kept.

The JAX package finds the threshold inside the top-128 prefix when every
row's nucleus lies there, and picks the level (k=128, 2048, or a full
sort) with ``lax.cond`` on the device. In eager PyTorch that choice is a
host read on every decode step, which a CUDA graph of the step cannot
hold, and without the read each level's work runs anyway, the full sort
included. So the port sorts the full row (``top_p_filter``) on every call:
one sort of (B, V) fp32 values, the same mask as every level of the
cascade. The k-space functions (``_topk_nucleus``, ``_kspace_cascade``)
come with the speculative residual ops, which use them.

Draws come from an explicit ``torch.Generator``: the Gumbel-max trick,
argmax(logits - log E) with E ~ Exp(1), a categorical draw with no host
read. Its numbers differ from ``jax.random``'s; its distribution does not.
"""

from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) -> (B,) int64 argmax token ids."""
    return torch.argmax(logits, dim=-1)


def _nucleus_threshold(sorted_desc: torch.Tensor, lse: torch.Tensor,
                       top_p: float) -> torch.Tensor:
    """(B, 1) smallest kept logit a row, from its descending-sorted logits
    and the logsumexp of the full row: keep while the cumulative
    probability before the token is below ``top_p`` (HF TopPLogitsWarper;
    the token that crosses it is kept)."""
    probs = torch.exp(sorted_desc - lse[..., None])
    cum = torch.cumsum(probs, dim=-1)
    num_keep = ((cum - probs) < top_p).sum(dim=-1, keepdim=True)  # >= 1
    idx = (num_keep - 1).clamp(0, sorted_desc.shape[-1] - 1)
    return sorted_desc.gather(-1, idx)


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """fp32 logits with every entry outside the nucleus set to -inf."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    sorted_desc = torch.sort(lf, dim=-1, descending=True).values
    thr = _nucleus_threshold(sorted_desc, lse, top_p)
    return torch.where(lf >= thr, lf, torch.full_like(lf, -torch.inf))


def categorical(logits: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """(B, V) logits -> (B,) int64 draws from softmax(logits)."""
    noise = torch.empty(logits.shape, dtype=torch.float32,
                        device=logits.device).exponential_(generator=generator)
    # a draw of 0 would give +inf, or NaN at a masked -inf logit
    noise = noise.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits.float() - noise.log(), dim=-1)


def nucleus_sample(logits: torch.Tensor, top_p: float,
                   generator: torch.Generator) -> torch.Tensor:
    """Exact top-p sampling: a draw from the renormalised nucleus."""
    return categorical(top_p_filter(logits, top_p), generator)


def sample(logits: torch.Tensor, *, do_sample: bool, temperature: float = 1.0,
           top_p: float = 1.0,
           generator: torch.Generator = None) -> torch.Tensor:
    """(B, V) logits -> (B,) int64 token ids: the argmax, or with
    ``do_sample`` a draw at ``temperature`` from the ``top_p`` nucleus."""
    if not do_sample:
        return greedy(logits)
    if generator is None:
        raise ValueError("sampled decoding needs a torch.Generator")
    if temperature != 1.0:
        logits = logits / temperature
    if top_p < 1.0:
        return nucleus_sample(logits, top_p, generator)
    return categorical(logits, generator)
