"""Profiling and tracing helpers (counterpart of
``u2tokenizer_tpu/utils/profiling.py``).

``trace`` records the host's operators and the card's kernels with
``torch.profiler`` and writes a Chrome trace (open it in Perfetto or
chrome://tracing) where the JAX package writes a jax.profiler trace for
TensorBoard; ``StepTimer`` keeps wall-clock step times with the JAX
package's percentile summary; ``device_memory_stats`` reads
``torch.cuda.memory_stats`` of each visible card; ``param_count_report``
counts parameters by the top-level name of the flax tree, which the
port's module names follow (``weights.flax_path``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str = "./u2_trace"):
    """Record the host's operators and, where a card is visible, its
    kernels; on exit write ``<log_dir>/trace.json`` (Chrome's format).
    Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class StepTimer:
    """Wall-clock step timer with mean/p50/p90/p99 summaries; ``dump``
    appends the summary to a jsonl file. The first ``warmup`` steps are
    not kept. Time spent on the card counts only where the step waits
    for it (``torch.cuda.synchronize()`` inside the ``with``)."""

    def __init__(self, name: str = "step", warmup: int = 1):
        self.name = name
        self.warmup = warmup
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return False

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            f"{self.name}_mean_s": float(arr.mean()),
            f"{self.name}_p50_s": float(np.percentile(arr, 50)),
            f"{self.name}_p90_s": float(np.percentile(arr, 90)),
            f"{self.name}_p99_s": float(np.percentile(arr, 99)),
            f"{self.name}_count": float(len(arr)),
        }

    def dump(self, path: str):
        with open(path, "a") as f:
            f.write(json.dumps(self.summary()) + "\n")


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """``torch.cuda.memory_stats`` of each visible card, its integer
    entries only, keyed "cuda:<i>"; {} without a card (the JAX function
    gives no entry for a backend without stats)."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {k: int(v) for k, v in stats.items()
                            if isinstance(v, (int, np.integer))
                            and not isinstance(v, bool)}
    return out


def param_count_report(model_or_state_dict) -> Dict[str, int]:
    """Parameter counts by top-level module, keyed as the flax tree's
    top-level names (a module's parameters through ``weights.flax_path``;
    a state dict's keys by their first component), plus "total"."""
    if isinstance(model_or_state_dict, nn.Module):
        from ..weights import flax_path

        modules = dict(model_or_state_dict.named_modules())
        items = [(flax_path(name, modules).split("/")[1], p.numel())
                 for name, p in model_or_state_dict.named_parameters()]
    else:
        state: Mapping = model_or_state_dict
        items = [(key.split(".")[0], int(t.numel()))
                 for key, t in state.items()]
    report: Dict[str, int] = {}
    for key, n in items:
        report[key] = report.get(key, 0) + int(n)
    report["total"] = sum(report.values())
    return report
