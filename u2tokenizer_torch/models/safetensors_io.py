""".safetensors files read and written with torch, numpy and the standard
library alone.

The format: an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` and an
optional ``"__metadata__"``), then the tensors' raw little-endian bytes,
offsets counted from the end of the header.

``read_safetensors`` maps the file (copy on write) and returns CPU torch
tensors that are views of it, so that a tensor's bytes are read when it is
used, not when the file is opened; numpy has no bfloat16, so BF16 data is
read as uint16 and viewed as ``torch.bfloat16``. ``write_safetensors``
writes tensor by tensor, so that it holds one tensor's bytes at a time,
wider types first so that each tensor's bytes are aligned to its type.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping

import numpy as np
import torch

# safetensors dtype name -> (numpy dtype of the stored bytes, torch dtype)
_DTYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
}
_NAMES = {torch_dt: name for name, (_, torch_dt) in _DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """All tensors of one .safetensors file, as CPU tensors mapped from it."""
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    if not header:
        return {}
    data = np.memmap(path, dtype=np.uint8, mode="c", offset=8 + n)
    out = {}
    for name, info in header.items():
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {name} has unsupported dtype "
                             f"{info['dtype']}")
        np_dt, torch_dt = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape))
        if end - begin != count * np.dtype(np_dt).itemsize:
            raise ValueError(f"{path}: {name} holds {end - begin} bytes, "
                             f"not {count} x {info['dtype']}")
        arr = data[begin:end].view(np.dtype(np_dt).newbyteorder("<"))
        t = torch.from_numpy(arr.astype(arr.dtype.newbyteorder("="),
                                        copy=False)).reshape(shape)
        out[name] = t.view(torch_dt) if torch_dt == torch.bfloat16 else t
    return out


_NP_NAMES = {np.dtype(np_dt): name for name, (np_dt, torch_dt)
             in _DTYPES.items() if torch_dt != torch.bfloat16}


def _describe(x):
    """(safetensors dtype name, shape, bytes a value) of a tensor or an
    array."""
    if isinstance(x, torch.Tensor):
        return _NAMES.get(x.dtype), list(x.shape), x.element_size()
    x = np.asarray(x)
    return _NP_NAMES.get(x.dtype.newbyteorder("=")), list(x.shape), \
        x.dtype.itemsize


def _raw(x) -> memoryview:
    """The little-endian bytes of a tensor or an array, C order."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    x = np.ascontiguousarray(x)
    return memoryview(x.astype(x.dtype.newbyteorder("<"), copy=False)
                      ).cast("B")


def write_safetensors(path: str, tensors: Mapping[str, object]) -> None:
    """Write ``tensors`` (torch tensors or numpy arrays, on any device) in
    their own types."""
    info = {name: _describe(x) for name, x in tensors.items()}
    header, offset = {}, 0
    # wider types first, so that every tensor starts aligned to its type
    order = sorted(info, key=lambda k: (-info[k][2], k))
    for name in order:
        dtype, shape, size = info[name]
        if dtype is None:
            raise ValueError(f"{name}: cannot store {tensors[name].dtype}")
        nbytes = int(np.prod(shape, dtype=np.int64)) * size
        header[name] = {"dtype": dtype, "shape": shape,
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob)
        for name in order:
            f.write(_raw(tensors[name]))
