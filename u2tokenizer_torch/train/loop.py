"""Training loop: the SFT run with checkpointing and logging
(counterpart of ``u2tokenizer_tpu/train/loop.py``).

Epoch and step accounting, metric logging (stdout + metrics.jsonl; wandb
optional), periodic saves with auto-resume and an in-epoch skip of the
batches a resumed run already consumed, and eval-time token accuracy.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import time
from collections import deque
from typing import Callable, Dict, Iterable, Optional

import torch

from ..config import TrainConfig
from .checkpoint import CheckpointManager
from .sft import TrainState


def device_prefetch(batches: Iterable[dict], device, depth: int = 2):
    """Keep ``depth`` batches in flight to ``device`` ahead of the step:
    on a GPU each host array is copied into pinned memory and sent with a
    non-blocking copy, so the transfer overlaps the step before it."""
    device = torch.device(device)
    buf = deque()

    def put(batch):
        out = {}
        for key, value in batch.items():
            t = torch.as_tensor(value)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.to(device)
            out[key] = t
        return out

    for batch in batches:
        buf.append(put(batch))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


class MetricLogger:
    """stdout + metrics.jsonl; wandb if asked for and installed."""

    def __init__(self, output_dir: str, use_wandb: bool = False,
                 wandb_project: Optional[str] = None,
                 wandb_run_name: Optional[str] = None):
        os.makedirs(output_dir, exist_ok=True)
        self._f = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=wandb_project, name=wandb_run_name)
            except Exception as e:  # wandb genuinely optional
                print(f"wandb unavailable ({e}); logging to jsonl only",
                      file=sys.stderr)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        record = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()
        msg = " ".join(f"{k}={v:.5g}" for k, v in record.items()
                       if k != "step")
        print(f"[step {step}] {msg}", flush=True)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self):
        self._f.close()


def run_training(
    cfg: TrainConfig,
    state: TrainState,
    train_step: Callable,
    data_iter_fn: Callable[[int], Iterable[dict]],
    device=None,
    steps_per_epoch: Optional[int] = None,
    eval_fn: Optional[Callable[[TrainState], Dict[str, float]]] = None,
    eval_steps: Optional[int] = None,
    logger: Optional[MetricLogger] = None,
) -> TrainState:
    """Run the SFT loop.

    data_iter_fn(epoch) -> iterable of host batches (dicts of arrays); they
    are copied to ``device`` (the model's by default). Auto-resumes from the
    latest checkpoint in cfg.output_dir/checkpoints.
    """
    logger = logger or MetricLogger(cfg.output_dir)
    device = device or next(state.model.parameters()).device
    ckpt = CheckpointManager(
        os.path.join(cfg.output_dir, "checkpoints"),
        save_total_limit=cfg.save_total_limit,
        save_interval_steps=cfg.save_steps)

    restored = ckpt.restore(state)
    if restored is not None:
        state = restored
        print(f"resumed from step {state.step}", flush=True)

    start_step = state.step
    total_steps = cfg.max_steps
    if total_steps is None and steps_per_epoch is not None:
        total_steps = int(steps_per_epoch * cfg.num_epochs)

    step = start_step
    t_last = time.time()
    done = False
    epoch = 0 if steps_per_epoch is None else start_step // max(
        steps_per_epoch, 1)
    # in-epoch fast-forward after a mid-epoch resume: skip the batches the
    # interrupted run already consumed, so the data stream lines up with
    # the step counter again (HF Trainer's default resume semantics)
    skip = 0
    if restored is not None and steps_per_epoch:
        skip = start_step % max(steps_per_epoch, 1)
        if skip:
            print(f"resume: skipping {skip} already-consumed batches of "
                  f"epoch {epoch}", flush=True)
    while not done:
        data_iter = data_iter_fn(epoch)
        if skip:
            data_iter = itertools.islice(data_iter, skip, None)
            skip = 0
        for batch in device_prefetch(data_iter, device):
            state, metrics = train_step(state, batch)
            step += 1
            if step % cfg.log_steps == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t_last
                metrics["steps_per_s"] = cfg.log_steps / dt
                t_last = time.time()
                logger.log(step, metrics)
            if eval_fn is not None and eval_steps and step % eval_steps == 0:
                logger.log(step, {f"eval_{k}": v
                                  for k, v in eval_fn(state).items()})
            ckpt.save(step, state)
            if total_steps is not None and step >= total_steps:
                done = True
                break
        epoch += 1
        if total_steps is None and epoch >= cfg.num_epochs:
            done = True

    ckpt.save(step, state, force=True)
    ckpt.close()
    return state


@torch.no_grad()
def evaluate_token_accuracy(model, loss_fn, state: TrainState,
                            batches: Iterable[dict]) -> Dict[str, float]:
    """Validation loss and token accuracy (reference compute_metrics,
    train_stage1.py:138-152); ``loss_fn`` from ``sft.make_loss_fn``."""
    losses, accs = [], []
    for batch in batches:
        _, metrics = loss_fn(state.model, batch)
        losses.append(float(metrics["loss"]))
        accs.append(float(metrics["token_accuracy"]))
    mean = lambda xs: sum(xs) / len(xs) if xs else float("nan")
    return {"loss": mean(losses), "token_accuracy": mean(accs)}
