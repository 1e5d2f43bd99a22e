"""Stage-2 DPO: preference collation, concatenated forward, DPO loss
(counterpart of ``u2tokenizer_tpu/train/dpo.py``) on one card.

The reference's TRL-based u2DPOTrainer (src/train/dpo_u2trainer.py:28-381
+ train_stage2.py), as the JAX package rebuilt it:

  * chosen and rejected share one forward over a 2B batch with the images
    duplicated (``concatenated_forward``, dpo_u2trainer.py:185-359); the
    completion tokens' log-probs are summed (sigmoid loss) or averaged
    (IPO);
  * the reference model is a frozen second copy of the policy
    (``requires_grad_(False)``, fp32 parameters like the policy's), its
    forward run under ``torch.no_grad()``;
  * flush-left rows [prompt, completion, pad...], equivalent to TRL's
    left-padded prompt after its flush_left normalisation; the packed
    layout puts [prompt, chosen, rejected, pad] in one row under a segment
    mask with restarting positions, and attends in plain PyTorch (the
    kernel K2 takes per-row lengths, not a segment mask), as the JAX
    package attends in XLA there.

Batches are dicts of CPU tensors (the collators') or of tensors on the
model's device; the step moves them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import DPOConfig
from .sft import TrainState, global_norm


# ---------------------------------------------------------------------------
# collation
# ---------------------------------------------------------------------------

def _image_of(sample: dict, image_transform) -> torch.Tensor:
    img = sample["image"]
    if isinstance(img, str):
        if image_transform is None:
            raise ValueError("sample has an image path but no transform")
        img = image_transform(img)
    return torch.as_tensor(img).cpu().float()


def collate_preference_batch(
    samples: Sequence[dict], tokenizer, max_prompt_length: int,
    max_completion_length: int, image_transform=None,
) -> Optional[Dict[str, torch.Tensor]]:
    """The concatenated (2B, S) batch from FusedDataset dpo_mode samples:
    row i the chosen sequence of sample i, row B+i its rejected one.
    Images are transformed here from the stored path when
    ``image_transform`` is given (dpo_u2trainer.py:160-162 applies
    u2Transform at step time); samples may carry a path or a volume."""
    samples = [s for s in samples if s is not None]
    if not samples:
        return None
    b = len(samples)
    s_total = max_prompt_length + max_completion_length

    input_ids = torch.full((2 * b, s_total), tokenizer.pad_token_id,
                           dtype=torch.int64)
    attention = torch.zeros((2 * b, s_total), dtype=torch.int32)
    comp_mask = torch.zeros((2 * b, s_total), dtype=torch.float32)
    images, question_ids = [], []

    for i, s in enumerate(samples):
        prompt_ids = tokenizer(s["prompt"], add_special_tokens=False)[
            "input_ids"][:max_prompt_length]
        for j, key in enumerate(("chosen", "rejected")):
            comp = tokenizer(s[key], add_special_tokens=False)["input_ids"]
            comp = comp[: max_completion_length - 1] + [tokenizer.eos_token_id]
            row = i + j * b
            seq = prompt_ids + comp
            input_ids[row, : len(seq)] = torch.tensor(seq)
            attention[row, : len(seq)] = 1
            comp_mask[row, len(prompt_ids): len(seq)] = 1.0
        images.append(_image_of(s, image_transform))
        question_ids.append(torch.as_tensor(s["prompt_question_ids"],
                                            dtype=torch.int64))

    return {
        "input_ids": input_ids,
        "attention_mask": attention,
        "completion_mask": comp_mask,
        "images": torch.stack(images),
        "question_ids": torch.stack(question_ids),
    }


def collate_packed_preference_batch(
    samples: Sequence[dict], tokenizer, max_prompt_length: int,
    max_completion_length: int, image_transform=None,
) -> Optional[Dict[str, torch.Tensor]]:
    """Packed layout: one row per sample = [prompt, chosen, rejected, pad]
    with segment ids (0/1/2/3), restarting positions for the rejected
    segment, and explicit boundary indices (``_packed_completion_logps``).
    """
    samples = [s for s in samples if s is not None]
    if not samples:
        return None
    b = len(samples)
    s_total = max_prompt_length + 2 * max_completion_length

    input_ids = torch.full((b, s_total), tokenizer.pad_token_id,
                           dtype=torch.int64)
    segment_ids = torch.full((b, s_total), 3, dtype=torch.int32)
    positions = torch.zeros((b, s_total), dtype=torch.int32)
    chosen_mask = torch.zeros((b, s_total), dtype=torch.float32)
    rejected_mask = torch.zeros((b, s_total), dtype=torch.float32)
    rejected_start = torch.zeros((b,), dtype=torch.int64)
    prompt_last = torch.zeros((b,), dtype=torch.int64)
    images, question_ids = [], []

    for i, s in enumerate(samples):
        prompt_ids = tokenizer(s["prompt"], add_special_tokens=False)[
            "input_ids"][:max_prompt_length]
        comps = []
        for key in ("chosen", "rejected"):
            c = tokenizer(s[key], add_special_tokens=False)["input_ids"]
            comps.append(c[: max_completion_length - 1] +
                         [tokenizer.eos_token_id])
        lp, lc, lr = len(prompt_ids), len(comps[0]), len(comps[1])
        row = prompt_ids + comps[0] + comps[1]
        input_ids[i, : len(row)] = torch.tensor(row)
        segment_ids[i, :lp] = 0
        segment_ids[i, lp: lp + lc] = 1
        segment_ids[i, lp + lc: lp + lc + lr] = 2
        positions[i, : lp + lc] = torch.arange(lp + lc)
        # rejected positions restart after the prompt (two-row equivalence)
        positions[i, lp + lc: lp + lc + lr] = lp + torch.arange(lr)
        chosen_mask[i, lp: lp + lc] = 1.0
        # the boundary token is left out here: it is added from the
        # prompt_last logits
        rejected_mask[i, lp + lc + 1: lp + lc + lr] = 1.0
        rejected_start[i] = lp + lc
        prompt_last[i] = lp - 1
        images.append(_image_of(s, image_transform))
        question_ids.append(torch.as_tensor(s["prompt_question_ids"],
                                            dtype=torch.int64))

    return {
        "input_ids": input_ids,
        "segment_ids": segment_ids,
        "positions": positions,
        "chosen_mask": chosen_mask,
        "rejected_mask": rejected_mask,
        "rejected_start": rejected_start,
        "prompt_last": prompt_last,
        "images": torch.stack(images),
        "question_ids": torch.stack(question_ids),
    }


def to_device(batch: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _completion_logps(model, batch, average: bool, aux: bool = False,
                      ce_chunk: int = 0):
    """(2B,) summed (or mean) completion-token log-probs under ``model``.

    With ``aux=True`` also returns (wpo_weights, chosen_nll): the WPO
    sequence weights (dpo_u2trainer.py:320-329) and the chosen-completion
    mean NLL used by RPO (dpo_u2trainer.py:331-340).

    ``ce_chunk > 0`` computes everything from hidden states in sequence
    chunks, each checkpointed, never holding the (2B, S, V) logits whole
    (the step otherwise holds two such tensors, the policy's and the
    reference's). The same numbers up to summation order.
    """
    b = batch["input_ids"].shape[0] // 2
    images = batch.get("images")
    if images is not None:
        images = torch.cat([images, images], dim=0)
    question_ids = torch.cat([batch["question_ids"], batch["question_ids"]],
                             dim=0)
    targets = batch["input_ids"][:, 1:].long()
    mask = batch["completion_mask"][:, 1:].float()
    if ce_chunk:
        embeds = model.prepare_inputs_embeds(batch["input_ids"], images,
                                             question_ids)
        _, hidden, _ = model.forward_embeds(
            embeds, batch["attention_mask"], compute_logits=False)
        s_tok, s_adj = _chunked_completion_stats(
            model.lm_logits, hidden[:, :-1], targets, mask, ce_chunk,
            need_adj=aux)
        msum = mask.sum(-1)
        sums = s_tok / msum.clamp(min=1.0) if average else s_tok
        if not aux:
            return sums
        w = s_adj / msum.clamp(min=1.0)
        weights = torch.exp(w[:b] + w[b:]).clamp(max=1.0)
        nll = -s_tok[:b].sum() / msum[:b].sum().clamp(min=1.0)
        return sums, weights, nll
    logits, _, _ = model(batch["input_ids"], images, question_ids,
                         attention_mask=batch["attention_mask"])
    # token t predicted by logits[t-1] (selective_log_softmax parity,
    # dpo_u2trainer.py:296)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tok_logp = logp.gather(-1, targets[..., None])[..., 0]
    sums = (tok_logp * mask).sum(-1)
    if average:
        sums = sums / mask.sum(-1).clamp(min=1.0)
    if not aux:
        return sums
    return sums, _wpo_weights(logp, tok_logp, mask, b), _chosen_nll(
        tok_logp[:b], mask[:b])


def _chunked_completion_stats(apply_logits, hidden, targets, mask,
                              chunk: int, need_adj: bool = True):
    """Masked per-sequence sums of (tok_logp, WPO-adjusted tok_logp) from
    hidden states, ``chunk`` positions at a time, each chunk checkpointed
    (peak (2B, chunk, V) in the forward and the backward).
    ``need_adj=False`` (the reference forward, or a policy forward
    without WPO) skips the adjustment's extra full-vocab logsumexp and
    returns None for it."""
    if chunk <= 0:
        raise ValueError(f"ce_chunk must be > 0, got {chunk}")

    def body(h, t, m):
        logp = torch.log_softmax(apply_logits(h).float(), dim=-1)
        tok = logp.gather(-1, t[..., None])[..., 0]
        s_tok = (tok * m).sum(-1)
        if not need_adj:
            return s_tok, torch.zeros_like(s_tok)
        adj = torch.logsumexp(2.0 * logp.detach(), dim=-1)
        return s_tok, ((tok.detach() - adj) * m).sum(-1)

    s_tok = s_adj = hidden.new_zeros(targets.shape[0], dtype=torch.float32)
    for start in range(0, targets.shape[1], chunk):
        piece = slice(start, start + chunk)
        c_tok, c_adj = checkpoint(body, hidden[:, piece], targets[:, piece],
                                  mask[:, piece], use_reentrant=False)
        s_tok = s_tok + c_tok
        s_adj = s_adj + c_adj
    return s_tok, (s_adj if need_adj else None)


def _wpo_weights(logp, tok_logp, mask, b):
    """WPO policy weights, eq. (2) of arXiv 2406.11827
    (dpo_u2trainer.py:320-329): per-token logp minus logsumexp(2*logp),
    masked-mean per sequence; weight = clamp(exp(w_chosen + w_rejected), 1).
    """
    adjustment = torch.logsumexp(2.0 * logp.detach(), dim=-1)  # (2B, S-1)
    adjusted = tok_logp.detach() - adjustment
    w = (adjusted * mask).sum(-1) / mask.sum(-1).clamp(min=1.0)
    return torch.exp(w[:b] + w[b:]).clamp(max=1.0)


def _chosen_nll(chosen_tok_logp, chosen_mask):
    """Mean NLL over chosen completion tokens (RPO, dpo_u2trainer.py:331-340)."""
    return -(chosen_tok_logp * chosen_mask).sum() / chosen_mask.sum().clamp(
        min=1.0)


# --- packed (padding-free-equivalent) forward -------------------------------

def packed_segment_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """bool (B, 1, S, S) attention mask for packed preference rows.

    Segment ids per token: 0=prompt, 1=chosen completion, 2=rejected
    completion, 3=pad. A query attends a key iff the key is not pad, the
    key precedes it in the row, and the key is prompt or same-segment:
    chosen and rejected completions never see each other, reproducing the
    two-row concatenated forward (TRL padding-free semantics,
    dpo_u2trainer.py:300-310)."""
    s = segment_ids.shape[1]
    q = segment_ids[:, :, None]
    k = segment_ids[:, None, :]
    causal = torch.ones(s, s, dtype=torch.bool,
                        device=segment_ids.device).tril()[None]
    ok = causal & (k != 3) & (q != 3) & ((k == 0) | (k == q))
    return ok[:, None]


def _packed_completion_logps(model, batch, average: bool, aux: bool = False):
    """Packed rows [prompt, chosen, rejected, pad]: one forward of B rows
    (vision and prompt encoded once a sample instead of twice), returning
    the concatenated forward's (2B,) order, chosen logps first.

    Within a segment token t is predicted by logits[t-1]. The rejected
    segment's first token sits after the last chosen token, whose logits
    carry the wrong context; in the two-row layout it is predicted by the
    last prompt position, whose logits the packed row holds too (the
    prompt sees no completion token under the segment mask). So that
    boundary term is gathered from ``prompt_last``, and ``rejected_mask``
    leaves the boundary index out (the collation's contract)."""
    mask = packed_segment_mask(batch["segment_ids"])
    embeds = model.prepare_inputs_embeds(batch["input_ids"],
                                         batch.get("images"),
                                         batch["question_ids"])
    logits, _, _ = model.forward_embeds(embeds, mask=mask,
                                        positions=batch["positions"])
    logp = torch.log_softmax(logits.float(), dim=-1)  # (B, S, V)
    ids = batch["input_ids"].long()
    tok_logp = logp[:, :-1].gather(-1, ids[:, 1:, None])[..., 0]
    c_mask = batch["chosen_mask"][:, 1:].float()
    r_mask = batch["rejected_mask"][:, 1:].float()  # boundary left out
    # boundary: the first rejected token, predicted by the last prompt
    # position
    rej_start = batch["rejected_start"].long()
    prompt_last = batch["prompt_last"].long()
    rows = torch.arange(ids.shape[0], device=ids.device)
    boundary_tok = ids[rows, rej_start]
    at_prompt_last = logp[rows, prompt_last]             # (B, V)
    boundary_lp = at_prompt_last[rows, boundary_tok]
    has_rej = batch["segment_ids"][rows, rej_start] == 2
    boundary_lp = torch.where(has_rej, boundary_lp,
                              torch.zeros_like(boundary_lp))

    sums_c = (tok_logp * c_mask).sum(-1)
    sums_r = (tok_logp * r_mask).sum(-1) + boundary_lp
    n_c = c_mask.sum(-1).clamp(min=1.0)
    n_r = (r_mask.sum(-1) + has_rej).clamp(min=1.0)
    if average:
        sums_c, sums_r = sums_c / n_c, sums_r / n_r
    sums = torch.cat([sums_c, sums_r], dim=0)
    if not aux:
        return sums
    adjustment = torch.logsumexp(2.0 * logp[:, :-1].detach(), dim=-1)
    adjusted = tok_logp.detach() - adjustment
    b_adj = torch.logsumexp(2.0 * at_prompt_last.detach(), dim=-1)
    b_adjusted = torch.where(has_rej, boundary_lp.detach() - b_adj,
                             torch.zeros_like(b_adj))
    w_c = (adjusted * c_mask).sum(-1) / n_c
    w_r = ((adjusted * r_mask).sum(-1) + b_adjusted) / n_r
    weights = torch.exp(w_c + w_r).clamp(max=1.0)
    return sums, weights, _chosen_nll(tok_logp, c_mask)


def dpo_loss(policy_c, policy_r, ref_c, ref_r, cfg: DPOConfig,
             weights=None, nll=None):
    """Per-pair DPO loss, meaned; optional WPO weighting and RPO NLL term.
    Returns (loss, logits)."""
    logits = (policy_c - policy_r) - (ref_c - ref_r)
    if cfg.loss_type == "sigmoid":
        loss = (-F.logsigmoid(cfg.beta * logits) * (1.0 - cfg.label_smoothing)
                - F.logsigmoid(-cfg.beta * logits) * cfg.label_smoothing)
    elif cfg.loss_type == "ipo":
        loss = (logits - 1.0 / (2.0 * cfg.beta)) ** 2
    else:
        raise ValueError(cfg.loss_type)
    if weights is not None:  # WPO (dpo_u2trainer.py:320-329)
        loss = loss * weights
    loss = loss.mean()
    if nll is not None and cfg.rpo_alpha is not None:
        loss = loss + cfg.rpo_alpha * nll  # RPO (dpo_u2trainer.py:331-340)
    return loss, logits


def make_dpo_loss_fn(cfg: DPOConfig):
    """loss_fn(model, ref_model, batch) -> (loss, metrics): the policy
    forward with grad, the reference's under ``torch.no_grad()``."""
    average = cfg.loss_type == "ipo"
    need_aux = cfg.use_weighting or cfg.rpo_alpha is not None
    if cfg.packed:
        # the packed forward keeps the full-logits path (its per-segment
        # boundary gathers do not chunk cleanly); ce_chunk applies unpacked
        if cfg.ce_chunk:
            import warnings

            warnings.warn("DPOConfig(packed=True) ignores ce_chunk: the "
                          "packed forward materializes full logits; drop "
                          "packed to get the chunked memory relief",
                          stacklevel=2)
        fwd = _packed_completion_logps
    else:
        def fwd(model, batch, average, aux=False):
            return _completion_logps(model, batch, average, aux,
                                     ce_chunk=cfg.ce_chunk)

    def loss_fn(model, ref_model, batch):
        weights = nll = None
        if need_aux:
            logps, weights, nll = fwd(model, batch, average, aux=True)
            if not cfg.use_weighting:
                weights = None
        else:
            logps = fwd(model, batch, average)
        with torch.no_grad():
            ref_logps = fwd(ref_model, batch, average)
        b = logps.shape[0] // 2
        policy_c, policy_r = logps[:b], logps[b:]
        ref_c, ref_r = ref_logps[:b], ref_logps[b:]
        loss, _ = dpo_loss(policy_c, policy_r, ref_c, ref_r, cfg,
                           weights=weights, nll=nll)
        reward_c = cfg.beta * (policy_c.detach() - ref_c)
        reward_r = cfg.beta * (policy_r.detach() - ref_r)
        metrics = {
            "loss": loss.detach(),
            "rewards_chosen": reward_c.mean(),
            "rewards_rejected": reward_r.mean(),
            "rewards_margin": (reward_c - reward_r).mean(),
            "rewards_accuracy": (reward_c > reward_r).float().mean(),
        }
        if nll is not None:
            metrics["nll_loss"] = nll.detach()
        return loss, metrics

    return loss_fn


def frozen_reference(model):
    """The reference model: a frozen copy of the policy (its fp32
    parameters, ``requires_grad`` off), as the JAX package copies the
    parameter tree."""
    import copy

    return copy.deepcopy(model).requires_grad_(False)


@torch.no_grad()
def generate_from_model_and_ref(model, gen_cfg, ref_model, batch,
                                generator=None):
    """Sample completions from the policy and the frozen reference
    (dpo_u2trainer.py:61-113: eval-time generation logging), in turn from
    ``generator``. Returns (policy_tokens, ref_tokens), each
    (B, max_new_tokens) int64."""
    from ..models.generate import make_multimodal_generate_fn

    dev = next(model.parameters()).device
    batch = to_device(batch, dev)
    prompt_len = batch["prompt_attention_mask"].sum(-1).to(torch.int32)
    out = []
    for m in (model, ref_model):
        gen_fn = make_multimodal_generate_fn(m, gen_cfg)
        out.append(gen_fn(batch["prompt_input_ids"], batch.get("images"),
                          batch["question_ids"], prompt_len, generator))
    return tuple(out)


def make_dpo_train_step(model, cfg: DPOConfig):
    """train_step(state, ref_model, batch) -> (state, metrics): loss,
    rewards, (nll_loss,) grad_norm. ``state`` is ``sft.TrainState`` over
    ``model`` with the ``sft.make_optimizer`` AdamW; the batch is moved to
    the model's device."""
    loss_fn = make_dpo_loss_fn(cfg)

    def train_step(state: TrainState, ref_model, batch):
        params = state.optimizer.params
        for p in params:  # free the last step's gradients before this one
            p.grad = None
        batch = to_device(batch, next(state.model.parameters()).device)
        loss, metrics = loss_fn(state.model, ref_model, batch)
        live = [p for p in params if p.requires_grad]
        got = iter(torch.autograd.grad(loss, live, allow_unused=True,
                                       materialize_grads=True))
        grads = [next(got) if p.requires_grad else None for p in params]
        metrics["grad_norm"] = global_norm(g for g in grads if g is not None)
        state.optimizer.update(grads)
        state.step += 1
        return state, metrics

    return train_step
