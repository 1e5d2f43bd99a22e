"""Stage-1 SFT: loss, optimizer and train step (counterpart of
``u2tokenizer_tpu/train/sft.py``) on one card.

The JAX package's semantics, kept exactly:
  * the shifted causal LM loss with ``IGNORE_INDEX`` masking, in fp32;
  * AdamW with beta (0.9, 0.999) and eps 1e-8 outside the square root
    (``torch.optim.AdamW`` computes what ``optax.adamw`` does), its learning
    rate set before every update from a plain copy of optax's warmup-cosine
    or warmup-constant schedule at the update count *before* it advances,
    so the first update has lr 0;
  * ``grad_accum_steps`` k > 1 as ``optax.MultiSteps``: the running mean of
    k gradients, then one update that advances the schedule once;
  * frozen parameters (the trainable filter) get ``requires_grad=False``,
    so no backward runs through them, and zero gradients at the update, as
    ``_mask_grads`` gives them: AdamW then moves them by weight decay only;
  * ``grad_norm`` is the global L2 norm of the masked gradients.

Training runs on fp32 parameters with the model's bf16 compute
(``U2CausalLM(cfg, dtype=torch.bfloat16)``, no ``cast_for_inference``).
Not ported yet: meshes (``make_sharded_trainer``; ``make_trainer`` is the
single-card counterpart), the segmentation loss.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import TrainConfig
from ..weights import trainable_names

IGNORE_INDEX = -100  # label mask value (src/dataset/fused_dataset.py:180-186)


def _token_terms(logits, targets):
    """(sum of -log p(target) over valid positions, count correct)."""
    valid = targets != IGNORE_INDEX
    safe = torch.where(valid, targets, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok = logp.gather(-1, safe[..., None])[..., 0]
    correct = (logits.argmax(-1) == targets) & valid
    return -(tok * valid).sum(), correct.sum()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shifted causal LM loss with IGNORE_INDEX masking: logits (B, S, V),
    labels (B, S); logits[t] predicts labels[t+1]. Returns (loss, token
    accuracy)."""
    targets = labels[:, 1:]
    nll, correct = _token_terms(logits[:, :-1], targets)
    n = (targets != IGNORE_INDEX).sum().clamp(min=1)
    return nll / n, correct / n


def chunked_cross_entropy_from_hidden(apply_logits, hidden: torch.Tensor,
                                      labels: torch.Tensor, chunk: int = 128):
    """The loss of ``cross_entropy_loss`` from hidden states, ``chunk``
    positions at a time, each chunk checkpointed, so that the (B, S, V)
    logits are never held whole in the forward or the backward. Same numbers
    up to summation order. ``apply_logits(h (B, c, E)) -> (B, c, V)``."""
    if chunk <= 0:
        raise ValueError(f"ce_chunk must be > 0, got {chunk}")
    hidden = hidden[:, :-1]
    targets = labels[:, 1:]
    nll = hidden.new_zeros((), dtype=torch.float32)
    correct = torch.zeros((), dtype=torch.int64, device=hidden.device)
    terms = lambda h, t: _token_terms(apply_logits(h), t)
    for start in range(0, targets.shape[1], chunk):
        c_nll, c_correct = checkpoint(terms, hidden[:, start:start + chunk],
                                      targets[:, start:start + chunk],
                                      use_reentrant=False)
        nll = nll + c_nll
        correct = correct + c_correct
    n = (targets != IGNORE_INDEX).sum().clamp(min=1)
    return nll / n, correct / n


def make_schedule(cfg: TrainConfig, total_steps: int) -> Callable[[int], float]:
    """count -> learning rate, equal to the optax schedule of the JAX
    package's ``make_optimizer``: linear warmup from 0 over
    max(1, int(total_steps * warmup_ratio)) updates, then cosine decay to 0
    at max(total_steps, warmup + 1), or constant."""
    warmup = max(1, int(total_steps * cfg.warmup_ratio))
    peak = cfg.learning_rate
    decay = max(total_steps, warmup + 1) - warmup
    if cfg.lr_schedule == "cosine":
        after = lambda c: peak * 0.5 * (1.0 + math.cos(
            math.pi * min(c, decay) / decay))
    elif cfg.lr_schedule == "constant":
        after = lambda c: peak
    else:
        raise ValueError(cfg.lr_schedule)

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * max(count, 0) / warmup
        return after(count - warmup)

    return schedule


class Optimizer:
    """AdamW over every parameter of a model, with the schedule and the
    MultiSteps accumulation of the JAX package's ``make_optimizer``."""

    def __init__(self, params: Iterable[nn.Parameter],
                 schedule: Callable[[int], float], weight_decay: float,
                 every: int = 1):
        self.params = list(params)
        self.schedule = schedule
        self.every = every
        self.adamw = torch.optim.AdamW(self.params, lr=schedule(0),
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)
        self.mini_step = 0      # gradients accumulated since the last update
        self.gradient_step = 0  # updates applied: the schedule's count
        self.acc: Optional[List[torch.Tensor]] = None

    def update(self, grads: Sequence[Optional[torch.Tensor]]) -> bool:
        """Take one gradient per parameter (None for a frozen one: zero);
        returns whether the parameters were updated. The gradients stay in
        ``p.grad`` after an update."""
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        if self.every > 1:
            n = self.mini_step
            self.acc = grads if self.acc is None else [
                (g + n * a) / (n + 1) for g, a in zip(grads, self.acc)]
            self.mini_step += 1
            if self.mini_step < self.every:
                return False
            grads, self.acc, self.mini_step = self.acc, None, 0
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.gradient_step)
        self.adamw.step()
        self.gradient_step += 1
        return True

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "mini_step": self.mini_step,
                "gradient_step": self.gradient_step, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.mini_step = state["mini_step"]
        self.gradient_step = state["gradient_step"]
        self.acc = (None if state["acc"] is None else
                    [a.to(p.device) for a, p in zip(state["acc"],
                                                    self.params)])


def make_optimizer(cfg: TrainConfig, params: Iterable[nn.Parameter],
                   total_steps: int) -> Optimizer:
    return Optimizer(params, make_schedule(cfg, total_steps),
                     cfg.weight_decay, cfg.grad_accum_steps)


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optimizer


def make_loss_fn(ce_chunk: int = 0):
    """loss_fn(model, batch) -> (loss, {"loss", "token_accuracy"}).
    ce_chunk > 0 computes the loss from hidden states in sequence chunks
    (chunked_cross_entropy_from_hidden)."""

    def loss_fn(model, batch: Dict[str, torch.Tensor]):
        if ce_chunk:
            embeds = model.prepare_inputs_embeds(
                batch["input_ids"], batch.get("images"),
                batch.get("question_ids"))
            _, hidden, _ = model.forward_embeds(
                embeds, batch.get("attention_mask"), compute_logits=False)
            loss, acc = chunked_cross_entropy_from_hidden(
                model.lm_logits, hidden, batch["labels"], ce_chunk)
        else:
            logits, _, _ = model(batch["input_ids"], batch.get("images"),
                                 batch.get("question_ids"),
                                 attention_mask=batch.get("attention_mask"))
            loss, acc = cross_entropy_loss(logits, batch["labels"])
        return loss, {"loss": loss.detach(), "token_accuracy": acc}

    return loss_fn


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))


def set_trainable(model: nn.Module,
                  trainable_filter: Callable[[str], bool]) -> None:
    """requires_grad from a filter over the JAX package's parameter paths
    (``weights.flax_path``), e.g. ``lambda p: "vision_tower" not in p``."""
    keep = set(trainable_names(model, trainable_filter))
    for name, p in model.named_parameters():
        p.requires_grad_(name in keep)


def make_train_step(model: nn.Module, trainable_filter=None,
                    ce_chunk: int = 0):
    """train_step(state, batch) -> (state, metrics): loss, token_accuracy
    and grad_norm. ``trainable_filter`` freezes the parameters whose flax
    path it rejects (reference freeze_vision_tower / freeze_backbone)."""
    if trainable_filter is not None:
        set_trainable(model, trainable_filter)
    loss_fn = make_loss_fn(ce_chunk)

    def train_step(state: TrainState, batch):
        params = state.optimizer.params
        for p in params:  # free the last step's gradients before this one
            p.grad = None
        loss, metrics = loss_fn(state.model, batch)
        live = [p for p in params if p.requires_grad]
        got = iter(torch.autograd.grad(loss, live, allow_unused=True,
                                       materialize_grads=True))
        grads = [next(got) if p.requires_grad else None for p in params]
        metrics["grad_norm"] = global_norm(g for g in grads if g is not None)
        state.optimizer.update(grads)
        state.step += 1
        return state, metrics

    return train_step


def make_trainer(model: nn.Module, cfg: TrainConfig, total_steps: int,
                 trainable_filter=None):
    """(TrainState, train_step) for ``model`` on its device: the
    single-card counterpart of the JAX package's ``make_sharded_trainer``;
    the model is built (and seeded) by the caller."""
    optimizer = make_optimizer(cfg, model.parameters(), total_steps)
    state = TrainState(step=0, model=model, optimizer=optimizer)
    return state, make_train_step(model, trainable_filter, cfg.ce_chunk)
