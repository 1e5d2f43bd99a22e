"""Structured failure reporting and retry after transient failures
(counterpart of ``u2tokenizer_tpu/utils/errors.py``).

Entry points wrapped with ``record`` write a JSON crash report (host,
process, traceback, the card's state) before re-raising, as the reference's
torch.distributed.elastic ``@record`` does (src/train/train_stage1.py:30-31);
``run_with_restarts`` runs a resumable loop again after a transient failure.
The report's device fields come from torch where the JAX package reads
``jax.process_index()`` and ``jax.default_backend()``: the backend ('cuda'
or 'cpu'), the card's name, its allocated and peak bytes, and the rank and
world size of an initialised ``torch.distributed`` group (else 0 and 1).
"""

from __future__ import annotations

import datetime
import functools
import json
import os
import socket
import sys
import time
import traceback
from typing import Callable


def _device_fields() -> dict:
    import torch

    fields = {"process_index": 0, "process_count": 1, "backend": "cpu"}
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        fields["process_index"] = dist.get_rank()
        fields["process_count"] = dist.get_world_size()
    if torch.cuda.is_available():
        dev = torch.cuda.current_device()
        fields.update(backend="cuda",
                      device_name=torch.cuda.get_device_name(dev),
                      memory_allocated=torch.cuda.memory_allocated(dev),
                      max_memory_allocated=torch.cuda.max_memory_allocated(
                          dev))
    return fields


def _error_report(exc: BaseException) -> dict:
    report = {
        "timestamp": datetime.datetime.now().isoformat(),
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "exception_type": type(exc).__name__,
        "message": str(exc),
        "traceback": traceback.format_exc(),
        "argv": sys.argv,
    }
    try:
        report.update(_device_fields())
    except Exception as e:  # noqa: BLE001 — the report must still be written
        report["device_error"] = f"{type(e).__name__}: {e}"
    return report


def record(fn: Callable = None, *, error_dir: str = "./error_reports"):
    """Decorator: on an exception, write a JSON report into ``error_dir``
    and re-raise (elastic ``record`` semantics); ``KeyboardInterrupt`` and
    ``SystemExit`` pass through unreported."""

    def decorate(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            try:
                return f(*args, **kwargs)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — report everything
                os.makedirs(error_dir, exist_ok=True)
                path = os.path.join(
                    error_dir,
                    f"error_{os.getpid()}_{int(time.time())}.json")
                with open(path, "w") as fp:
                    json.dump(_error_report(e), fp, indent=2)
                print(f"[u2-torch] crash report written to {path}",
                      file=sys.stderr)
                raise

        return wrapper

    if fn is not None:
        return decorate(fn)
    return decorate


TRANSIENT_ERRORS = (
    "DATA_LOSS", "UNAVAILABLE", "DEADLINE_EXCEEDED", "RESOURCE_EXHAUSTED",
    "preempt", "socket closed", "connection reset",
)


def is_transient(exc: BaseException) -> bool:
    text = f"{type(exc).__name__}: {exc}".lower()
    return any(tok.lower() in text for tok in TRANSIENT_ERRORS)


def run_with_restarts(fn: Callable, max_restarts: int = 3,
                      backoff_s: float = 30.0,
                      error_dir: str = "./error_reports"):
    """Run ``fn()`` (a resumable loop, e.g. ``train.loop.run_training``,
    which resumes from its last checkpoint) and run it again after each
    transient failure, at most ``max_restarts`` times."""
    attempts = 0
    while True:
        try:
            return record(fn, error_dir=error_dir)()
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001
            attempts += 1
            if attempts > max_restarts or not is_transient(e):
                raise
            print(f"[u2-torch] transient failure ({e}); restart "
                  f"{attempts}/{max_restarts} in {backoff_s:.0f}s",
                  file=sys.stderr)
            time.sleep(backoff_s)
