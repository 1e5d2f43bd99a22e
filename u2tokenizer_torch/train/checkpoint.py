"""Checkpointing with auto-resume (counterpart of
``u2tokenizer_tpu/train/checkpoint.py``).

Same interface as the JAX package's orbax manager: ``save_interval_steps``,
``save_total_limit``, an idempotent ``save`` with ``force``,
``latest_step`` and ``restore``. Each checkpoint is one ``torch.save`` of
{step, model, optimizer} state dicts in ``<directory>/<step>/state.pt``,
written under a temporary name and renamed, so a killed save leaves no step
directory behind. Saves are synchronous: the training loop waits for the
write, where orbax writes in a background thread.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional

import torch

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
        """Write ``state`` (a ``TrainState``) as step ``step`` when the step
        is a multiple of ``save_interval_steps`` past the latest one, or
        when ``force``; a step already saved is not written again. Keeps the
        newest ``save_total_limit`` steps."""
        steps = self.all_steps()
        if step in steps:
            return False
        if not force and (step % self.save_interval_steps
                          or (steps and steps[-1] >= step)):
            return False
        final = os.path.join(self.directory, str(step))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"step": step, "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict()},
                   os.path.join(tmp, STATE_FILE))
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.save_total_limit]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore(self, state: Any, step: Optional[int] = None) -> Any:
        """Load step ``step`` (the latest when None) into ``state`` in place
        and return it; None when there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        saved = torch.load(os.path.join(self.directory, str(step),
                                        STATE_FILE),
                           map_location="cpu", weights_only=True)
        state.model.load_state_dict(saved["model"])
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step = saved["step"]
        return state

    def close(self) -> None:
        """Nothing is in flight: saves are synchronous."""
