"""Adafactor as the JAX package builds it with optax, for the QLoRA run's
μ²tokenizer and projector (``u2tokenizer_tpu/cli.py``
``_run_qlora_training``; ``train.lora.QLoraOptimizer`` routes the
adapters to ``torch.optim.AdamW``, which computes what ``optax.adamw``
does).

``Adafactor(schedule)`` is optax 0.2.6's ``adafactor(schedule,
min_dim_size_to_factor=128)``, step for step in the parameter's dtype, so
that bf16 parameters round where optax rounds them: the chain
``scale_by_factored_rms`` (the two largest dims factored when both are
>= 128; decay 1 - (t + 1)^-0.8; eps 1e-30; the moments stored in the
parameter's dtype), ``clip_by_block_rms(1.0)``, the learning rate (rounded
to the dtype first), ``scale_by_param_block_rms(1e-3)`` and the sign.
``torch.optim.Adafactor`` is another algorithm. It works as optax's
transform does, on flat dicts of named tensors: ``init(params) -> state``
and ``update(grads, state, params) -> (updates, state)``, then
``apply_updates(params, updates)`` adds the updates in place in each
parameter's dtype. Its state is a dict of tensors and a count, so that a
checkpoint (``torch.save``) carries it.

A schedule is ``count -> learning rate`` (``sft.make_schedule``), read at
the update count before it advances, so the first update has lr 0 under a
warmup.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]


def _mean(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """jnp.mean: summed in fp32 for a bf16 input, the result in its dtype."""
    xf = x.float()
    out = xf.mean() if dim is None else xf.mean(dim, keepdim=keepdim)
    return out.to(x.dtype)


def _lr(schedule: Schedule, count: int, like: torch.Tensor) -> torch.Tensor:
    """optax's ``jnp.array(step_size, dtype=g.dtype)``: the rate rounded to
    the update's dtype."""
    return torch.tensor(schedule(count), dtype=torch.float32).to(like.dtype)


def _factored_dims(shape, min_dim_size_to_factor: int) -> Optional[Tuple]:
    """optax's ``_factored_dims``: the second largest and the largest dim
    (ties in index order), or None when the second is under the limit."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return order[-2], order[-1]


class Adafactor:
    """``optax.adafactor(learning_rate, min_dim_size_to_factor=128)`` with
    its other defaults: decay rate 0.8, no decay offset, eps 1e-30,
    clipping 1.0, multiply_by_parameter_scale (floor 1e-3), no momentum,
    no weight decay."""

    MIN_DIM, DECAY_RATE, EPS, CLIP, MIN_SCALE = 128, 0.8, 1e-30, 1.0, 1e-3

    def __init__(self, schedule: Schedule):
        self.schedule = schedule

    def init(self, params: Params) -> dict:
        state = {"count": 0, "v_row": {}, "v_col": {}, "v": {}}
        for name, p in params.items():
            one = torch.zeros(1, dtype=p.dtype, device=p.device)
            dims = _factored_dims(tuple(p.shape), self.MIN_DIM)
            if dims is None:
                state["v_row"][name], state["v_col"][name] = one, one.clone()
                state["v"][name] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                row = [n for i, n in enumerate(p.shape) if i != d0]
                col = [n for i, n in enumerate(p.shape) if i != d1]
                state["v_row"][name] = p.new_zeros(row)
                state["v_col"][name] = p.new_zeros(col)
                state["v"][name] = one
        return state

    def _rescale(self, g, v_row, v_col, v, decay):
        """scale_by_factored_rms for one leaf: (update, v_row, v_col, v)."""
        dt = g.dtype
        grad_sqr = g * g + self.EPS
        dims = _factored_dims(tuple(g.shape), self.MIN_DIM)
        if dims is None:
            v = (decay * v.float() + (1.0 - decay) * grad_sqr.float()).to(dt)
            return g * v.rsqrt(), v_row, v_col, v
        d1, d0 = dims
        v_row = (decay * v_row.float() + (1.0 - decay)
                 * _mean(grad_sqr, d0).float()).to(dt)
        v_col = (decay * v_col.float() + (1.0 - decay)
                 * _mean(grad_sqr, d1).float()).to(dt)
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_factor = (v_row / _mean(v_row, reduced_d1, keepdim=True)).rsqrt()
        col_factor = v_col.rsqrt()
        update = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        return update, v_row, v_col, v

    def update(self, grads: Params, state: dict, params: Params):
        count = state["count"]
        t = torch.tensor(count + 1, dtype=torch.float32)
        decay = float(1.0 - t ** -self.DECAY_RATE)
        new = {"count": count + 1, "v_row": {}, "v_col": {}, "v": {}}
        updates = {}
        for name, g in grads.items():
            u, new["v_row"][name], new["v_col"][name], new["v"][name] = \
                self._rescale(g, state["v_row"][name], state["v_col"][name],
                              state["v"][name], decay)
            # clip_by_block_rms
            denom = torch.clamp(_mean(u * u).sqrt() / self.CLIP, min=1.0)
            u = u / denom
            u = _lr(self.schedule, count, u) * u
            # scale_by_param_block_rms
            p = params[name]
            rms = _mean(p * p).sqrt()
            floor = torch.tensor(self.MIN_SCALE, dtype=torch.float32).to(
                p.dtype)
            u = u * torch.where(rms <= self.MIN_SCALE, floor, rms)
            updates[name] = -u
        return updates, new


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> None:
    """optax.apply_updates in place: p <- (p + u) in p's dtype."""
    for name, p in params.items():
        p.copy_((p + updates[name]).to(p.dtype))


def state_to(state, device):
    """A transform's state with every tensor moved to ``device``."""
    if isinstance(state, dict):
        return {k: state_to(v, device) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.to(device)
    return state
