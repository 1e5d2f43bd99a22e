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
included. So the port's plain draw sorts the full row (``top_p_filter``)
on every call: one sort of (B, V) fp32 values, the same mask as every
level of the cascade.

The speculative ops (``nucleus_membership_bounds``, ``nucleus_p_draft``,
``nucleus_accept_residual``) decide acceptance, so they give the JAX
package's probabilities: the membership bounds from two reductions over
the row, the exact probability and the residual draw from the k-space
cascade (``_topk_nucleus``, ``_kspace_cascade``). The port's cascade picks
the level per row, not for the whole call: every row runs the top-128
level, and only the rows whose nucleus spills past it go on to the
top-2048 level and then to the full sort. Each level after the first
needs the count of rows left, one host read (``nonzero``): a call reads
the host once when every row's nucleus lies in the top 128, twice
otherwise, and not at all when the vocabulary is no larger than 128.

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


# ---------------------------------------------------------------------------
# k-space nucleus ops of speculative sampling
# ---------------------------------------------------------------------------


def _topk_nucleus(logits: torch.Tensor, top_p: float, k: int):
    """(topv, topi, keep, lse_n, contained) of fp32 ``logits`` (B, V): the
    descending top-k values and ids, the in-prefix nucleus mask (every
    value at or above the smallest kept one, so ties at the threshold are
    all kept), the nucleus logsumexp (B, 1), and per row whether its
    nucleus lies inside the prefix. ``contained`` is conservative, as the
    JAX package's: a row whose threshold equals the k-th value may have
    ties past the prefix and counts as spilling."""
    k = min(k, logits.shape[-1])
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    topv, topi = torch.topk(logits, k, dim=-1)
    probs = torch.exp(topv - lse)
    cum = torch.cumsum(probs, dim=-1)
    num_keep = ((cum - probs) < top_p).sum(dim=-1, keepdim=True)
    thr = topv.gather(-1, (num_keep - 1).clamp_min(0))
    keep = topv >= thr
    contained = (cum[:, -1] >= top_p) & (
        (thr[:, 0] > topv[:, -1]) | (k == logits.shape[-1]))
    masked = torch.where(keep, probs, torch.zeros_like(probs))
    lse_n = torch.log(masked.sum(-1, keepdim=True)) + lse
    return topv, topi, keep, lse_n, contained


def _kspace_cascade(logits: torch.Tensor, top_p: float, fast, slow,
                    k: int, k_escalate: int):
    """Per-row escalating dispatch over (B, V) logits: ``fast(rows, topv,
    topi, keep, lse_n)`` at prefix size k for every row, then at
    k_escalate for the rows whose nucleus spilled, then ``slow(rows)``
    (the full sort) for the rows left. ``rows`` are the row indices a
    level takes; each function returns a tuple of per-row tensors, merged
    back in row order. One host read after each level that leaves rows to
    the next (see the module docstring)."""
    lf = logits.float()
    b, v = lf.shape
    ks = [kx for kx in (k, k_escalate) if kx < v]
    rows = torch.arange(b, device=lf.device)
    out = None
    for kx in ks:
        topv, topi, keep, lse_n, contained = _topk_nucleus(lf[rows], top_p,
                                                           kx)
        res = fast(rows, topv, topi, keep, lse_n)
        if out is None:
            out = tuple(r.clone() for r in res)
        else:
            for o, r in zip(out, res):
                o[rows] = torch.where(contained, r, o[rows])
        rows = rows[~contained]  # the host read
        if rows.numel() == 0:
            return out
    res = slow(rows)
    if out is None:
        return res
    for o, r in zip(out, res):
        o[rows] = r
    return out


def nucleus_membership_bounds(logits: torch.Tensor, draft: torch.Tensor,
                              top_p: float):
    """Sort-free acceptance bounds of a draft under the top-p-warped
    distribution: (member, p_lo, p_hi) per row from two reductions over
    the vocabulary (logsumexp and the mass strictly above the draft's
    logit), no sort and no host read. ``member``: the draft lies in the
    nucleus (the mass above its logit is below top_p). p_lo <= p(d) <=
    p_hi with p(d) = p_full(d) / N and the nucleus mass N in
    [max(top_p, P_above + p_full), 1]. A uniform u accepts for certain
    when u < p_lo and rejects for certain when u >= p_hi. Rows with a
    draft below 0 give member False, p_lo = p_hi = 0."""
    lf = logits.float()
    d_safe = draft.clamp_min(0).long()
    l_d = lf.gather(-1, d_safe[:, None])[:, 0]
    lse = torch.logsumexp(lf, dim=-1)
    above = torch.where(lf > l_d[:, None], torch.exp(lf - lse[:, None]),
                        torch.zeros_like(lf))
    p_above = above.sum(-1)
    member = (p_above < top_p) & (draft >= 0)
    p_full = torch.exp(l_d - lse)
    zero = torch.zeros_like(p_full)
    p_lo = torch.where(member, p_full, zero)
    p_hi = torch.where(member, torch.clamp(
        p_full / torch.clamp(p_above + p_full, min=top_p), max=1.0), zero)
    return member, p_lo, p_hi


def nucleus_p_draft(logits: torch.Tensor, draft: torch.Tensor, top_p: float,
                    k: int = 128, k_escalate: int = 2048) -> torch.Tensor:
    """Exact probability of each row's draft token under the top-p-warped
    distribution of its (temperature-scaled) logits (B, V): 0 outside the
    nucleus and for a draft below 0. Host reads as ``_kspace_cascade``."""
    lf = logits.float()
    d_safe = draft.clamp_min(0).long()
    l_d = lf.gather(-1, d_safe[:, None])[:, 0]

    def fast(rows, topv, topi, keep, lse_n):
        member = ((topi == d_safe[rows, None]) & keep).any(-1)
        p = torch.exp(l_d[rows] - lse_n[:, 0])
        return (torch.where(member & (draft[rows] >= 0), p,
                            torch.zeros_like(p)),)

    def slow(rows):
        p = torch.softmax(top_p_filter(lf[rows], top_p), dim=-1).gather(
            -1, d_safe[rows, None])[:, 0]
        return (torch.where(draft[rows] >= 0, p, torch.zeros_like(p)),)

    return _kspace_cascade(lf, top_p, fast, slow, k, k_escalate)[0]


def nucleus_accept_residual(logits: torch.Tensor, draft: torch.Tensor,
                            top_p: float, generator: torch.Generator,
                            k: int = 128, k_escalate: int = 2048):
    """One speculative-sampling step on (temperature-scaled) logits
    (B, V): (p_draft, fresh). ``p_draft`` is ``nucleus_p_draft``'s value,
    the acceptance probability of a point-mass draft; ``fresh`` (B,)
    int64 is a draw from the warped distribution with the draft's mass
    removed, the rejection residual (the whole nucleus for a draft below
    0, or when the draft is the whole nucleus, where the caller never uses
    it). Host reads as ``_kspace_cascade``."""
    lf = logits.float()
    d_safe = draft.clamp_min(0).long()
    l_d = lf.gather(-1, d_safe[:, None])[:, 0]
    ninf = -torch.inf

    def fast(rows, topv, topi, keep, lse_n):
        dr = d_safe[rows, None]
        valid = draft[rows] >= 0
        member = ((topi == dr) & keep).any(-1)
        p = torch.exp(l_d[rows] - lse_n[:, 0])
        p_d = torch.where(member & valid, p, torch.zeros_like(p))
        kl = torch.where(keep, topv, torch.full_like(topv, ninf))
        res = kl.masked_fill((topi == dr) & valid[:, None], ninf)
        empty = torch.isinf(res).all(-1, keepdim=True)
        res = torch.where(empty, kl, res)
        j = categorical(res, generator)
        return p_d, topi.gather(-1, j[:, None])[:, 0]

    def slow(rows):
        w = top_p_filter(lf[rows], top_p)
        dr = d_safe[rows, None]
        valid = draft[rows] >= 0
        p = torch.softmax(w, dim=-1).gather(-1, dr)[:, 0]
        p_d = torch.where(valid, p, torch.zeros_like(p))
        res = w.scatter(-1, dr, ninf)
        res = torch.where(valid[:, None], res, w)
        return p_d, categorical(res, generator)

    return _kspace_cascade(lf, top_p, fast, slow, k, k_escalate)
