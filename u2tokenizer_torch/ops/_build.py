"""Build and load the hand-written CUDA kernels.

Every ``u2tokenizer_torch/csrc/*.cu`` compiles with ``nvcc`` into its own
shared library with a plain C interface, loaded with ``ctypes``; the
headers beside them (``csrc/*.cuh``) are shared by the sources. Sources
build in parallel, one ``nvcc`` process each, at first use; a library is
named by the hash of its source, every header and the flags, so a changed
source or header rebuilds and an unchanged one is reused. Output goes to
``build/kernels/`` at the root of the checkout (git-ignored).

Nothing here runs at import time: the CPU tests import every module on a
machine that has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_info: Dict[str, dict] = {}  # per source: seconds, ptxas report


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only on a machine with "
            "the CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def _start(src: Path):
    out = _target(src)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile (in parallel) and load every kernel library; returns
    {source stem: CDLL}. Raises if a compile fails."""
    with _lock:
        sources = sorted(CSRC.glob("*.cu"))
        pending = {}
        t0 = time.perf_counter()
        for src in sources:
            if src.stem not in _libs:
                pending[src.stem] = _start(src)
        errors = []
        for stem, (out, tmp, proc) in pending.items():
            report = ""
            if proc is not None:
                report, _ = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"nvcc failed for {stem}.cu:\n{report}")
                    continue
                os.replace(tmp, out)
            _libs[stem] = ctypes.CDLL(str(out))
            build_info[stem] = {"library": str(out), "cached": proc is None,
                                "seconds": time.perf_counter() - t0,
                                "ptxas": report}
        if errors:
            raise RuntimeError("\n".join(errors))
        return dict(_libs)


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    if stem not in _libs:
        build_all()
    return _libs[stem]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
