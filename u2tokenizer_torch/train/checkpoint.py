"""Checkpointing with auto-resume (counterpart of
``u2tokenizer_tpu/train/checkpoint.py``).

Same interface as the JAX package's orbax manager: ``save_interval_steps``,
``save_total_limit``, an idempotent ``save`` with ``force``,
``latest_step`` and ``restore``. Each checkpoint is one ``torch.save`` of
the training state's ``state_dict()`` (SFT's {step, model, optimizer};
QLoRA's {step, trainable leaves, optimizer state}, ``train.lora``) in
``<directory>/<step>/state.pt``, written under a temporary name and
renamed, so a killed save leaves no step directory behind. Saves are
synchronous: the training loop waits for the write, where orbax writes in
a background thread.

A state on a mesh (``sft.ShardedTrainState``) saves the same whole
checkpoint a one-card run writes: every rank takes the main rank's
decision to save (``state.agree``), the whole tensors are gathered to it
(``state.state_dict()``) and it writes them while the others wait; restore
reads the main rank's latest step on every rank and loads it onto any mesh,
or onto one card.

``save_params_msgpack`` and ``load_params_msgpack`` write and read a
parameter tree in flax's msgpack form (``utils.msgpack``), the JAX
package's single-file export (the QLoRA adapters file).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional

import torch

from ..utils import msgpack

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, save_total_limit: int = 2,
                 save_interval_steps: int = 2000):
        self.directory = os.path.abspath(directory)
        self.save_total_limit = save_total_limit
        self.save_interval_steps = save_interval_steps
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(
                          os.path.join(self.directory, n, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Write ``state`` (a ``TrainState`` or ``QLoraState``) as step ``step`` when the step
        is a multiple of ``save_interval_steps`` past the latest one, or
        when ``force``; a step already saved is not written again. Keeps the
        newest ``save_total_limit`` steps."""
        steps = self.all_steps()
        write = step not in steps and (force or not (
            step % self.save_interval_steps or (steps and steps[-1] >= step)))
        write = _agreed(state, write)
        if not write:
            return False
        saved = state.state_dict()  # on a mesh: None but on the main rank
        if saved is not None:
            final = os.path.join(self.directory, str(step))
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(saved, os.path.join(tmp, STATE_FILE))
            os.replace(tmp, final)
            for old in self.all_steps()[:-self.save_total_limit]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        if hasattr(state, "barrier"):
            state.barrier()
        return True

    def restore(self, state: Any, step: Optional[int] = None) -> Any:
        """Load step ``step`` (the latest when None) into ``state`` in place
        and return it; None when there is no checkpoint."""
        step = _agreed(state, self.latest_step() if step is None else step)
        if step is None:
            return None
        saved = torch.load(os.path.join(self.directory, str(step),
                                        STATE_FILE),
                           map_location="cpu", weights_only=True)
        state.load_state_dict(saved)
        return state

    def close(self) -> None:
        """Nothing is in flight: saves are synchronous."""


def _agreed(state: Any, value):
    """The main rank's ``value`` for a state on a mesh; else ``value``."""
    return state.agree(value) if hasattr(state, "agree") else value


def save_params_msgpack(path: str, params: Any) -> None:
    """A nested tree of tensors or numpy arrays as one flax msgpack file
    (``flax.serialization.to_bytes`` of the same tree)."""
    with open(path, "wb") as f:
        msgpack.dump(params, f)


def load_params_msgpack(path: str) -> Any:
    """The nested tree of a flax msgpack file, its arrays as CPU tensors
    (``msgpack.restore``)."""
    with open(path, "rb") as f:
        return msgpack.restore(f.read())
