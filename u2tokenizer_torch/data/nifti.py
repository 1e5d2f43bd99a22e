"""NIfTI-1/2 reader and writer in numpy (counterpart of
``u2tokenizer_tpu/data/nifti.py``).

``read_nifti`` returns the voxels as nibabel's ``get_fdata`` gives them:
(X, Y, Z[, ...]) in Fortran order, ``scl_slope``/``scl_inter`` applied,
float64. It reads NIfTI-1 in either byte order, NIfTI-2, and ``.gz``.
``read_nifti_raw`` stops before the cast, so that a caller can move the
stored integers to the GPU and scale them there. ``write_nifti`` writes a
NIfTI-1 file in the array's own type.
"""

from __future__ import annotations

import gzip
import struct
from typing import Tuple

import numpy as np

_NIFTI1_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_NIFTI_CODES = {np.dtype(t): code for code, t in _NIFTI1_DTYPES.items()}


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _voxels(f, path: str, bo: str, datatype: int, shape, offset: int):
    np_dtype = _NIFTI1_DTYPES.get(datatype)
    if np_dtype is None:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dt = np.dtype(np_dtype).newbyteorder(bo)
    f.seek(offset)
    count = int(np.prod(shape))
    raw = f.read(count * dt.itemsize)
    if len(raw) < count * dt.itemsize:
        raise ValueError(f"{path}: truncated voxel data")
    # NIfTI voxel data is Fortran-ordered: X fastest
    return np.frombuffer(raw, dtype=dt, count=count).reshape(shape, order="F")


def read_nifti_raw(path: str) -> Tuple[np.ndarray, float, float]:
    """Read a .nii / .nii.gz volume -> (voxels in the stored type and byte
    order, shaped (X, Y, Z[, ...]), scl_slope, scl_inter)."""
    with _open(path) as f:
        header = f.read(348)
        if len(header) < 348:
            raise ValueError(f"{path}: truncated NIfTI header")
        le, be = (struct.unpack(o + "i", header[:4])[0] for o in "<>")
        if 540 in (le, be):
            header += f.read(540 - 348)
            return _read_nifti2(f, header, path)
        if le == 348:
            bo = "<"
        elif be == 348:
            bo = ">"
        else:
            raise ValueError(f"{path}: not a NIfTI file (sizeof_hdr={le})")
        magic = header[344:348]
        if magic[:2] not in (b"n+", b"ni"):
            raise ValueError(f"{path}: bad NIfTI magic {magic!r}")
        dim = struct.unpack(bo + "8h", header[40:56])
        shape = tuple(max(1, d) for d in dim[1:1 + dim[0]])
        datatype = struct.unpack(bo + "h", header[70:72])[0]
        vox_offset = struct.unpack(bo + "f", header[108:112])[0]
        slope = struct.unpack(bo + "f", header[112:116])[0]
        inter = struct.unpack(bo + "f", header[116:120])[0]
        data = _voxels(f, path, bo, datatype, shape,
                       int(vox_offset) if vox_offset else 352)
    return data, float(slope), float(inter)


def _read_nifti2(f, header: bytes, path: str):
    if len(header) < 540:
        raise ValueError(f"{path}: truncated NIfTI-2 header")
    bo = "<" if struct.unpack("<i", header[:4])[0] == 540 else ">"
    magic = header[4:8]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"{path}: bad NIfTI-2 magic {magic!r}")
    datatype = struct.unpack(bo + "h", header[12:14])[0]
    dim = struct.unpack(bo + "8q", header[16:80])
    shape = tuple(max(1, d) for d in dim[1:1 + dim[0]])
    vox_offset = struct.unpack(bo + "q", header[168:176])[0]
    slope = struct.unpack(bo + "d", header[176:184])[0]
    inter = struct.unpack(bo + "d", header[184:192])[0]
    data = _voxels(f, path, bo, datatype, shape, int(vox_offset))
    return data, float(slope), float(inter)


def scaling_applies(slope: float, inter: float) -> bool:
    """Whether the header's scaling changes the stored values (a slope of 0
    or 1 with no intercept does not)."""
    return slope not in (0.0, 1.0) or inter != 0.0


def read_nifti(path: str) -> np.ndarray:
    """Read a .nii / .nii.gz volume -> float64 array shaped (X, Y, Z[, ...])
    with the header's scaling applied."""
    raw, slope, inter = read_nifti_raw(path)
    data = raw.astype(np.float64)
    if scaling_applies(slope, inter):
        data = data * (slope if slope != 0.0 else 1.0) + inter
    return data


def write_nifti(path: str, data: np.ndarray, scl_slope: float = 1.0,
                scl_inter: float = 0.0) -> None:
    """Write a little-endian NIfTI-1 file (identity voxel size) holding
    ``data`` in its own type, which must be one NIfTI names, with the
    given scaling; ``.gz`` paths are compressed."""
    data = np.asarray(data)
    code = _NIFTI_CODES.get(data.dtype.newbyteorder("="))
    if code is None or data.ndim > 7:
        raise ValueError(f"cannot write {data.dtype} data of {data.ndim} "
                         "dims as NIfTI-1")
    header = bytearray(348)
    struct.pack_into("<i", header, 0, 348)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", header, 40, *dim)
    struct.pack_into("<h", header, 70, code)
    struct.pack_into("<h", header, 72, 8 * data.dtype.itemsize)  # bitpix
    struct.pack_into("<8f", header, 76, *([1.0] * 8))  # pixdim
    struct.pack_into("<f", header, 108, 352.0)  # vox_offset
    struct.pack_into("<f", header, 112, scl_slope)
    struct.pack_into("<f", header, 116, scl_inter)
    header[344:348] = b"n+1\x00"
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(bytes(header) + b"\x00" * 4)
        f.write(data.astype(data.dtype.newbyteorder("<")).tobytes(order="F"))
