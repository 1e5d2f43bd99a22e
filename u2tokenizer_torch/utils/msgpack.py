"""flax's msgpack form of a parameter tree, in the standard library alone.

The JAX package writes parameter trees with ``flax.serialization.to_bytes``
(``train/checkpoint.save_params_msgpack``: the QLoRA adapters file,
``u2_params.msgpack``). That is MessagePack (https://msgpack.org) of the
nested dict, each array an extension of type 1 whose data is itself the
MessagePack of ``(shape, dtype name, raw C-order bytes)``, bf16 named
``"bfloat16"``; an array over 2**30 bytes is split into a dict marked
``__msgpack_chunked_array__``. The port has no ``msgpack`` package, and
numpy no bf16, so this module packs and unpacks the format itself and
reads arrays into CPU tensors:

  * ``to_bytes(tree)``: nested dicts (keys as ``str``), lists and tuples as
    flax's state dicts ({"0": ...}), bool, int, float, str, bytes, and
    tensors or numpy arrays (any dtype numpy names, and bf16) as type-1
    extensions;
  * ``restore(data)``: the tree back, arrays as tensors (chunked arrays
    joined);
  * ``packb`` and ``unpackb``: plain MessagePack of such values (lists as
    arrays).
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np
import torch

EXT_NDARRAY = 1
CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30  # flax's limit on one array's bytes


# ---------------------------------------------------------------- packing ---

def _head(out: List[bytes], n: int, fix: int, fix_max: int, codes) -> None:
    """A length-prefixed header: the fix form below ``fix_max``, else the
    smallest of the 8-, 16- and 32-bit forms ``codes`` allows."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, limit in codes:
        if code is not None and n < limit:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack: length {n} is too large")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARRAY = ((None, "", 0), (0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((None, "", 0), (0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _int(out: List[bytes], n: int) -> None:
    if 0 <= n < 128:
        out.append(bytes([n]))
    elif -32 <= n < 0:
        out.append(struct.pack(">b", n))
    elif n >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < limit:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise ValueError(f"msgpack: {n} does not fit 64 bits")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if n >= -limit:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise ValueError(f"msgpack: {n} does not fit 64 bits")


def _ext(out: List[bytes], code: int, data: bytes) -> None:
    n = len(data)
    if n in _FIXEXT:
        out.append(bytes([_FIXEXT[n], code]))
    else:
        _head(out, n, None, 0, ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16),
                                (0xC9, ">I", 1 << 32)))
        out.append(bytes([code]))
    out.append(data)


def _array_bytes(x) -> bytes:
    """The type-1 extension's data of a tensor or numpy array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            name, raw = "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            arr = t.numpy()
            name, raw = arr.dtype.name, arr.tobytes()
        shape = tuple(t.shape)
    else:
        arr = np.ascontiguousarray(x)
        name, raw, shape = arr.dtype.name, arr.tobytes(), arr.shape
    return packb((tuple(int(n) for n in shape), name, raw))


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        _ext(out, EXT_NDARRAY, _array_bytes(obj))
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _head(out, len(raw), 0xA0, 32, _STR)
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _head(out, len(raw), None, 0, _BIN)
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, _ARRAY)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, _MAP)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def _state_dict(tree: Any) -> Any:
    """flax's ``to_state_dict`` of plain containers: dict keys as ``str``,
    lists and tuples as {"0": ...}, arrays over MAX_CHUNK_SIZE bytes split
    as flax splits them."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        nbytes = (tree.numel() * tree.element_size()
                  if isinstance(tree, torch.Tensor) else tree.nbytes)
        if nbytes > MAX_CHUNK_SIZE:
            flat = tree.reshape(-1)
            size = max(1, MAX_CHUNK_SIZE // (nbytes // max(flat.shape[0], 1)))
            return {CHUNKED: True,
                    "shape": {str(i): int(n) for i, n in
                              enumerate(tree.shape)},
                    "chunks": {str(i): flat[j:j + size] for i, j in
                               enumerate(range(0, flat.shape[0], size))}}
    return tree


def to_bytes(tree: Any) -> bytes:
    """``flax.serialization.to_bytes`` of a tree of plain containers."""
    return packb(_state_dict(tree))


# -------------------------------------------------------------- unpacking ---

def _dtype_of(name: str):
    if name == "bfloat16":
        return torch.bfloat16
    return np.dtype(name)


def _array(data: bytes) -> torch.Tensor:
    shape, name, raw = unpackb(data)
    if isinstance(name, bytes):
        name = name.decode()
    dtype = _dtype_of(name)
    if dtype is torch.bfloat16:
        flat = torch.frombuffer(bytearray(raw), dtype=torch.int16).view(
            torch.bfloat16) if raw else torch.empty(0, dtype=torch.bfloat16)
        return flat.reshape(shape)
    return torch.from_numpy(np.frombuffer(raw, dtype=dtype).reshape(
        shape).copy())


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: data ends inside a value")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, n: int) -> Any:
        code = self.num(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _array(data)
        raise ValueError(f"msgpack: unknown extension type {code}")

    def value(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return self.take(self.num(sized[b]))
        sized = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in sized:
            return self.ext(self.num(sized[b]))
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.num(fixed[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in sized:
            return self.take(self.num(sized[b])).decode("utf-8")
        if b in (0xDC, 0xDD):
            return [self.value() for _ in
                    range(self.num(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.num(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: unknown format byte {b:#x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data: bytes) -> Any:
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes after the value")
    return out


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get(CHUNKED):
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return torch.cat(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: the tree of ``to_bytes``,
    arrays as CPU tensors."""
    return _unchunk(unpackb(data))
