"""Stage-1 SFT: loss, optimizer and train step (counterpart of
``u2tokenizer_tpu/train/sft.py``), on one card (``make_trainer``) or on a
(data, fsdp, tensor) mesh of ranks (``make_sharded_trainer``).

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
Joint report and segmentation training (the reference's seg_enable
collator): ``make_seg_loss_fn`` adds each row's BCE + Dice of the SegVol
head's mask logits, gated by ``has_seg``, to the LM loss;
``make_seg_train_step`` takes AdamW steps on it.

On a mesh (``parallel.mesh``) each rank runs the step on its rows of the
global batch with the decoder split over the tensor dim and the fsdp
dim's parameters gathered for the step, and the JAX package's global
numbers come out: the loss is the sum over every rank's valid tokens over
the global count of valid tokens, all-reduced before the division (a mean
of the ranks' means differs whenever their rows hold different numbers of
valid tokens), each rank's gradients are of its share of that loss and
summed over the ranks that hold other rows, and ``grad_norm`` is the norm
over the whole, sharded, gradient.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import TrainConfig
from ..weights import trainable_names

IGNORE_INDEX = -100  # label mask value (src/dataset/fused_dataset.py:180-186)


def valid_count(labels: torch.Tensor) -> torch.Tensor:
    """The shifted targets' valid positions: the loss's denominator before
    its clamp at 1."""
    return (labels[:, 1:] != IGNORE_INDEX).sum()


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
    nll, correct = _token_terms(logits[:, :-1], labels[:, 1:])
    n = valid_count(labels).clamp(min=1)
    return nll / n, correct / n


def chunked_cross_entropy_from_hidden(apply_logits, hidden: torch.Tensor,
                                      labels: torch.Tensor, chunk: int = 128):
    """The loss of ``cross_entropy_loss`` from hidden states, ``chunk``
    positions at a time, each chunk checkpointed, so that the (B, S, V)
    logits are never held whole in the forward or the backward. Same numbers
    up to summation order. ``apply_logits(h (B, c, E)) -> (B, c, V)``."""
    nll, correct = chunked_token_terms(apply_logits, hidden, labels, chunk)
    n = valid_count(labels).clamp(min=1)
    return nll / n, correct / n


def chunked_token_terms(apply_logits, hidden: torch.Tensor,
                        labels: torch.Tensor, chunk: int = 128):
    """(sum of -log p(target), count correct) over the valid shifted
    targets, ``chunk`` positions at a time (``chunked_cross_entropy_from_
    hidden``'s numerator)."""
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
    return nll, correct


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

    def state_dict(self) -> dict:
        """What a checkpoint holds: the step, the model's and the
        optimizer's state dicts."""
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, saved: dict) -> None:
        self.model.load_state_dict(saved["model"])
        self.optimizer.load_state_dict(saved["optimizer"])
        self.step = saved["step"]


def lm_token_terms(model, batch: Dict[str, torch.Tensor], ce_chunk: int = 0):
    """(sum of -log p(target), count correct) of a batch's valid shifted
    targets: from the logits, or with ce_chunk > 0 from hidden states in
    sequence chunks (chunked_token_terms)."""
    if ce_chunk:
        embeds = model.prepare_inputs_embeds(
            batch["input_ids"], batch.get("images"),
            batch.get("question_ids"))
        _, hidden, _ = model.forward_embeds(
            embeds, batch.get("attention_mask"), compute_logits=False)
        return chunked_token_terms(model.lm_logits, hidden, batch["labels"],
                                   ce_chunk)
    logits, _, _ = model(batch["input_ids"], batch.get("images"),
                         batch.get("question_ids"),
                         attention_mask=batch.get("attention_mask"))
    return _token_terms(logits[:, :-1], batch["labels"][:, 1:])


def make_loss_fn(ce_chunk: int = 0, count: Optional[Callable] = None):
    """loss_fn(model, batch) -> (loss, {"loss", "token_accuracy"}): the sum
    over the valid tokens over their count. ce_chunk > 0 computes the loss
    from hidden states in sequence chunks (chunked_cross_entropy_from_
    hidden). ``count`` maps the batch's valid count to the denominator (a
    mesh's all-reduce over the ranks of the global batch)."""

    def loss_fn(model, batch: Dict[str, torch.Tensor]):
        nll, correct = lm_token_terms(model, batch, ce_chunk)
        n = valid_count(batch["labels"])
        if count is not None:
            n = count(n)
        n = n.clamp(min=1)
        loss = nll / n
        return loss, {"loss": loss.detach(), "token_accuracy": correct / n}

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
                    ce_chunk: int = 0, loss_fn=None):
    """train_step(state, batch) -> (state, metrics): loss, token_accuracy
    and grad_norm. ``trainable_filter`` freezes the parameters whose flax
    path it rejects (reference freeze_vision_tower / freeze_backbone);
    ``loss_fn`` (model, batch) -> (loss, metrics) replaces
    ``make_loss_fn(ce_chunk)``'s."""
    if trainable_filter is not None:
        set_trainable(model, trainable_filter)
    loss_fn = loss_fn or make_loss_fn(ce_chunk)

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
    """(TrainState, train_step) for ``model`` on its device, one card
    (``make_sharded_trainer`` is the mesh's, as in the JAX package); the
    model is built (and seeded) by the caller."""
    optimizer = make_optimizer(cfg, model.parameters(), total_steps)
    state = TrainState(step=0, model=model, optimizer=optimizer)
    return state, make_train_step(model, trainable_filter, cfg.ce_chunk)


class ShardedTrainState:
    """The training state on a mesh: the step, the tensor-split model, the
    ``parallel.mesh.ShardedParams`` that hold its parameters and the AdamW
    ``Optimizer`` over their flat buffers. ``state_dict`` gives what a
    one-card ``TrainState`` gives for the same numbers, whole tensors in
    its names and order (on the main rank; None on the others), so a
    checkpoint written on any mesh loads on one card or on another mesh
    (``load_state_dict``). Both are collectives: every rank calls them."""

    def __init__(self, model: nn.Module, optimizer: Optimizer,
                 store, mesh):
        self.step = 0
        self.model = model
        self.optimizer = optimizer
        self.store = store
        self.mesh = mesh

    @property
    def is_main(self) -> bool:
        return self.mesh.is_main

    def agree(self, value):
        """The main rank's ``value`` on every rank."""
        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def barrier(self) -> None:
        dist.barrier()

    def state_dict(self) -> Optional[dict]:
        store = self.store
        params = store.full({k: b for k, b in store.buffers.items()})
        adamw = self.optimizer.adamw
        saved = adamw.state_dict()
        order = [store.buffers[k] for k in store.KINDS]
        per_param = {}
        if adamw.state:
            moments = {key: store.full({k: adamw.state[store.buffers[k]][key]
                                        for k in store.KINDS})
                       for key in ("exp_avg", "exp_avg_sq")}
            step = adamw.state[order[0]]["step"]
            per_param = {i: {"step": step.clone(),
                             "exp_avg": moments["exp_avg"][n],
                             "exp_avg_sq": moments["exp_avg_sq"][n]}
                         for i, n in enumerate(store.names)}
        groups = [{**g, "params": list(range(len(store.names)))}
                  for g in saved["param_groups"]]
        acc = self.optimizer.acc
        if acc is not None:
            full = store.full(dict(zip(store.KINDS, acc)))
            acc = [full[n] for n in store.names]
        if not self.is_main:
            return None
        return {"step": self.step, "model": params,
                "optimizer": {"adamw": {"state": per_param,
                                        "param_groups": groups},
                              "mini_step": self.optimizer.mini_step,
                              "gradient_step": self.optimizer.gradient_step,
                              "acc": acc}}

    def load_state_dict(self, saved: dict) -> None:
        store = self.store
        store.load_full(saved["model"])
        opt = saved["optimizer"]
        state = {}
        per_param = opt["adamw"]["state"]
        if per_param:
            by_name = {n: per_param[i] for i, n in enumerate(store.names)}
            moments = {key: store.local({n: v[key] for n, v in
                                         by_name.items()})
                       for key in ("exp_avg", "exp_avg_sq")}
            state = {j: {"step": per_param[0]["step"].clone(),
                         "exp_avg": moments["exp_avg"][k],
                         "exp_avg_sq": moments["exp_avg_sq"][k]}
                     for j, k in enumerate(store.KINDS)}
        groups = [{**g, "params": list(range(len(store.KINDS)))}
                  for g in opt["adamw"]["param_groups"]]
        self.optimizer.adamw.load_state_dict({"state": state,
                                              "param_groups": groups})
        self.optimizer.mini_step = opt["mini_step"]
        self.optimizer.gradient_step = opt["gradient_step"]
        acc = opt["acc"]
        if acc is not None:
            local = store.local(dict(zip(store.names, acc)))
            acc = [local[k] for k in store.KINDS]
        self.optimizer.acc = acc
        self.step = saved["step"]


class BatchSlicer:
    """A global batch (every rank draws the same one) -> this rank's rows:
    [k*b, (k+1)*b) with k = data_index * fsdp + fsdp_index (the JAX
    package's ``data_sharding``); ``rows(n)`` is that slice of n rows."""

    def __init__(self, mesh):
        self.mesh = mesh

    def rows(self, global_rows: int) -> slice:
        return self.mesh.batch_rows(global_rows)

    def __call__(self, batch: Dict[str, torch.Tensor]) -> Dict[str, object]:
        n = len(next(iter(batch.values())))
        rows = self.rows(n)
        return {k: v[rows] for k, v in batch.items()}


def make_sharded_trainer(model: nn.Module, cfg: TrainConfig,
                         total_steps: int, mesh, trainable_filter=None,
                         ce_chunk: int = 0):
    """(state, train_step, batch_slicer) for ``model`` on ``mesh``
    (``parallel.mesh.make_mesh``): the counterpart of the JAX package's
    ``make_sharded_trainer``. Every rank builds the same whole model (the
    same seed, or ``--pretrained`` loaded into it) and calls this; the
    decoder is split over the tensor dim (``shard_decoder``), the
    parameters and their AdamW state placed by the JAX package's rules
    (``ShardedParams``). ``train_step(state, batch)`` takes this rank's
    rows (``batch_slicer(global_batch)``) and returns the global metrics
    (``reduce_dict`` over the ranks): loss and token_accuracy over the
    global batch, grad_norm over the whole gradient. ``trainable_filter``
    and ``ce_chunk`` as for ``make_trainer``."""
    from ..parallel.collectives import all_reduce_sum, reduce_dict
    from ..parallel.mesh import ShardedParams, placements, shard_decoder

    if trainable_filter is not None:
        set_trainable(model, trainable_filter)
    places = placements(model, mesh.shape)
    partial = shard_decoder(model, mesh, places)
    store = ShardedParams(model, mesh, places, partial)
    optimizer = Optimizer([store.buffers[k] for k in store.KINDS],
                          make_schedule(cfg, total_steps), cfg.weight_decay,
                          cfg.grad_accum_steps)
    state = ShardedTrainState(model, optimizer, store, mesh)
    rows_group = mesh.group("data,fsdp")
    count = None
    if mesh.size("data,fsdp") > 1:
        count = lambda n: all_reduce_sum(n, rows_group)
    loss_fn = make_loss_fn(ce_chunk, count)
    main_tensor_rank = float(mesh.coords["tensor"] == 0)

    def train_step(state: ShardedTrainState, batch):
        store.gather()
        try:
            loss, metrics = loss_fn(state.model, batch)
            live = [p for p in store.params if p.requires_grad]
            got = iter(torch.autograd.grad(loss, live, allow_unused=True,
                                           materialize_grads=True))
            grads = [next(got) if p.requires_grad else None
                     for p in store.params]
        finally:
            store.release()
        flat = store.reduce_grads(grads)
        del grads
        # every tensor rank holds the same share of the loss: rank 0's counts
        parts = {"loss": metrics["loss"] * main_tensor_rank,
                 "token_accuracy": metrics["token_accuracy"].float()
                 * main_tensor_rank,
                 "grad_norm": store.square_norm_part(flat)}
        metrics = reduce_dict(parts, mesh.group("world"), average=False)
        metrics["grad_norm"] = metrics["grad_norm"].sqrt()
        state.optimizer.update([flat[k] for k in store.KINDS])
        state.step += 1
        return state, metrics

    return state, train_step, BatchSlicer(mesh)


def make_seg_loss_fn(seg_weight: float = 1.0):
    """loss_fn(model, batch) -> (loss, {"loss", "lm_loss", "seg_loss",
    "token_accuracy"}): the LM loss plus ``seg_weight`` times the mean over
    rows with ``has_seg`` of each row's BCE + soft Dice (fp32). The batch
    holds the SFT keys and seg_image (B, 1, D, H, W), seg (the target
    mask, same shape), seg_positions (B,) and has_seg (B,) {0, 1}."""

    def loss_fn(model, batch: Dict[str, torch.Tensor]):
        logits, masks = model.forward_seg(
            batch["input_ids"], batch.get("images"),
            batch.get("question_ids"), batch["seg_image"],
            batch["seg_positions"], batch.get("attention_mask"))
        lm_loss, acc = cross_entropy_loss(logits, batch["labels"])
        b = masks.shape[0]
        z = masks.reshape(b, -1).float()
        t = batch["seg"].reshape(b, -1).float()
        bce_row = (z.clamp_min(0) - z * t
                   + torch.log1p(torch.exp(-z.abs()))).mean(-1)
        p = torch.sigmoid(z)
        dice_row = 1.0 - (2.0 * (p * t).sum(-1) + 1.0) / (
            (p * p).sum(-1) + (t * t).sum(-1) + 1.0)
        gate = batch["has_seg"].float()
        seg = ((bce_row + dice_row) * gate).sum() / gate.sum().clamp_min(1.0)
        loss = lm_loss + seg_weight * seg
        return loss, {"loss": loss.detach(), "lm_loss": lm_loss.detach(),
                      "seg_loss": seg.detach(), "token_accuracy": acc}

    return loss_fn


def make_seg_train_step(model: nn.Module, trainable_filter=None,
                        seg_weight: float = 1.0):
    """train_step(state, batch) -> (state, metrics) for joint report and
    segmentation training: ``make_train_step``'s AdamW update and
    grad_norm on ``make_seg_loss_fn``'s loss."""
    return make_train_step(model, trainable_filter,
                           loss_fn=make_seg_loss_fn(seg_weight))


def seg_positions_from_ids(input_ids, seg_token_id: int):
    """(B, S) ids -> ((B,) int32 first '[SEG]' index, (B,) float32 has_seg
    {0, 1}), numpy arrays."""
    ids = np.asarray(input_ids)
    is_seg = ids == seg_token_id
    return (np.argmax(is_seg, axis=1).astype(np.int32),
            is_seg.any(axis=1).astype(np.float32))
