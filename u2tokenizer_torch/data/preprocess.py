"""Offline bulk ingest: NIfTI volumes -> preprocessed (T, D, H, W) arrays,
the work queue behind ``cli preprocess`` (counterpart of
``u2tokenizer_tpu/native/__init__.py``'s ``bulk_preprocess``, lines
97-171, and the JAX CLI's ``cmd_preprocess``).

The JAX command runs its C++ loader (``native/nifti_loader.cpp``) on host
threads. The port reads with ``data/nifti.py`` and runs the ingest of
``U2VolumeTransform`` on ``device`` (the GPU unless the caller names
another), so its arrays equal ``U2VolumeTransform(device=...)(path)`` bit
for bit and follow the JAX package's Python path (``use_native=False``)
to about 1e-5; the C++ loader differs from that path by up to 5e-2
(``ROADMAP.md``, known difference 19).

Host threads read and inflate the files and write the ``.npy`` outputs;
the calling thread moves each volume to the device, runs the ingest and
brings the array back. At most as many volumes as there are threads are
read ahead, and as many written behind, so a dataset-scale run holds a
bounded number of volumes in host memory. Three behaviours are the JAX
function's: results come back in input order as ``(path, array_or_None,
error_or_None)``; one volume's failure is its own entry and does not stop
the others; and same-named volumes from different directories are written
as ``<parent>__<stem>.npy``, a collision even then being refused.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .nifti import read_nifti_raw
from .transforms import U2VolumeTransform, upload_raw

Result = Tuple[str, Optional[np.ndarray], Optional[str]]


def _path_stem(path: str) -> str:
    stem = os.path.basename(path)
    for ext in (".nii.gz", ".nii", ".npy"):
        if stem.endswith(ext):
            return stem[: -len(ext)]
    return stem


def output_names(paths: Sequence[str]) -> Dict[str, str]:
    """Each path's output stem: its own, or ``<parent>__<stem>`` where
    several paths share a stem; raises ``ValueError`` if names still
    collide."""
    by_stem: Dict[str, List[str]] = {}
    for p in paths:
        by_stem.setdefault(_path_stem(p), []).append(p)
    names = {}
    for stem, group in by_stem.items():
        if len(group) == 1:
            names[group[0]] = stem
        else:
            for p in group:
                parent = os.path.basename(os.path.dirname(p)) or "root"
                names[p] = f"{parent}__{stem}"
    if len(set(names.values())) != len(paths):
        raise ValueError(
            "bulk_preprocess: output stem collision even after "
            "directory-prefix disambiguation; pass distinct paths")
    return names


def _error(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"


def bulk_preprocess(paths, target: int = 256, chunk_depth: int = 32,
                    num_chunks: int = 8, num_workers: Optional[int] = None,
                    out_dir: Optional[str] = None,
                    device="cuda") -> List[Result]:
    """Ingest every NIfTI path as ``U2VolumeTransform(data_type=
    "validation", target_size=target, chunk_depth=chunk_depth,
    num_chunks=num_chunks, device=device)`` does.

    Args:
      paths: iterable of NIfTI paths.
      num_workers: host threads that read and write (default: the CPU
        count).
      out_dir: when set, each result is written as ``<out_dir>/<stem>.npy``
        and the returned arrays are None.

    Returns:
      list of (path, float32 array or None, error or None), in input order.
    """
    paths = list(paths)
    transform = U2VolumeTransform(
        data_type="validation", target_size=target, chunk_depth=chunk_depth,
        num_chunks=num_chunks, device=device)
    names = {}
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        names = output_names(paths)
    ahead = num_workers or os.cpu_count() or 1

    def write(path: str, arr: np.ndarray) -> Result:
        try:
            np.save(os.path.join(out_dir, names[path] + ".npy"), arr)
            return path, None, None
        except Exception as e:  # noqa: BLE001 — per-volume isolation
            return path, None, _error(e)

    results: List[Optional[Result]] = [None] * len(paths)
    writes = []  # (index, future), oldest first
    with ThreadPoolExecutor(max_workers=ahead) as pool:
        reads = [pool.submit(read_nifti_raw, p) for p in paths[:ahead]]
        for i, path in enumerate(paths):
            if i + ahead < len(paths):
                reads.append(pool.submit(read_nifti_raw, paths[i + ahead]))
            try:
                vol = upload_raw(*reads[i].result(), transform.device)
                arr = transform.from_array(vol).cpu().numpy()
            except Exception as e:  # noqa: BLE001 — per-volume isolation
                results[i] = (path, None, _error(e))
                continue
            finally:
                reads[i] = None  # the host copy is not kept
            if out_dir is None:
                results[i] = (path, arr, None)
                continue
            writes.append((i, pool.submit(write, path, arr)))
            del arr
            while len(writes) > ahead:
                j, fut = writes.pop(0)
                results[j] = fut.result()
        for j, fut in writes:
            results[j] = fut.result()
    return results

