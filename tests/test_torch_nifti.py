"""The port's NIfTI reader and writer against the JAX package's.

Files written by one package are read by both, bit for bit: the port
writes int16, uint8 and float32 volumes, .nii and .nii.gz, with and without
a non-unit scl_slope; the JAX package writes float32; and hand-built
headers cover a big-endian NIfTI-1 file and a NIfTI-2 file.
"""

import gzip
import struct

import numpy as np
import pytest

from u2tokenizer_torch.data import nifti as t_nifti
from u2tokenizer_tpu.data import nifti as j_nifti

pytestmark = pytest.mark.fast

CODES = {np.dtype(np.int16): 4, np.dtype(np.uint8): 2,
         np.dtype(np.float32): 16}


def _volume(dtype, shape=(7, 6, 5), seed=0):
    rs = np.random.RandomState(seed)
    if np.dtype(dtype).kind == "f":
        return rs.randn(*shape).astype(dtype)
    info = np.iinfo(dtype)
    return rs.randint(info.min, info.max, shape).astype(dtype)


def _both(path):
    ours, theirs = t_nifti.read_nifti(str(path)), j_nifti.read_nifti(str(path))
    assert ours.dtype == theirs.dtype == np.float64
    np.testing.assert_array_equal(ours, theirs)
    return ours


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.float32])
@pytest.mark.parametrize("slope,inter", [(1.0, 0.0), (0.5, -1024.0)])
def test_port_writes_both_read(tmp_path, dtype, suffix, slope, inter):
    vol = _volume(dtype)
    path = tmp_path / f"v{suffix}"
    t_nifti.write_nifti(str(path), vol, scl_slope=slope, scl_inter=inter)
    got = _both(path)
    np.testing.assert_array_equal(got, vol.astype(np.float64) * slope + inter)
    raw, s, i = t_nifti.read_nifti_raw(str(path))
    assert raw.dtype == vol.dtype and (s, i) == (slope, inter)
    np.testing.assert_array_equal(raw, vol)


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_jax_writes_both_read(tmp_path, suffix):
    vol = _volume(np.float32, (9, 4, 3, 2))
    path = tmp_path / f"v{suffix}"
    j_nifti.write_nifti(str(path), vol)
    np.testing.assert_array_equal(_both(path), vol.astype(np.float64))


def _nifti1_big_endian(vol, slope):
    header = bytearray(348)
    struct.pack_into(">i", header, 0, 348)
    dim = [vol.ndim] + list(vol.shape) + [1] * (7 - vol.ndim)
    struct.pack_into(">8h", header, 40, *dim)
    struct.pack_into(">h", header, 70, CODES[vol.dtype])
    struct.pack_into(">f", header, 108, 352.0)
    struct.pack_into(">f", header, 112, slope)
    header[344:348] = b"n+1\x00"
    data = vol.astype(vol.dtype.newbyteorder(">")).tobytes(order="F")
    return bytes(header) + b"\x00" * 4 + data


def _nifti2(vol, slope, inter):
    header = bytearray(540)
    struct.pack_into("<i", header, 0, 540)
    header[4:8] = b"n+2\x00"
    struct.pack_into("<h", header, 12, CODES[vol.dtype])
    dim = [vol.ndim] + list(vol.shape) + [1] * (7 - vol.ndim)
    struct.pack_into("<8q", header, 16, *dim)
    struct.pack_into("<q", header, 168, 544)
    struct.pack_into("<d", header, 176, slope)
    struct.pack_into("<d", header, 184, inter)
    return bytes(header) + b"\x00" * 4 + vol.tobytes(order="F")


@pytest.mark.parametrize("kind", ["big_endian", "nifti2"])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("gz", [False, True])
def test_hand_built_headers(tmp_path, kind, dtype, gz):
    vol = _volume(dtype, seed=1)
    payload = (_nifti1_big_endian(vol, 2.0) if kind == "big_endian"
               else _nifti2(vol, 0.25, 3.0))
    path = tmp_path / ("v.nii.gz" if gz else "v.nii")
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(payload)
    scale = (2.0, 0.0) if kind == "big_endian" else (0.25, 3.0)
    np.testing.assert_array_equal(
        _both(path), vol.astype(np.float64) * scale[0] + scale[1])


def test_rejects_what_it_cannot_read(tmp_path):
    path = tmp_path / "bad.nii"
    path.write_bytes(b"\x00" * 400)
    with pytest.raises(ValueError, match="not a NIfTI"):
        t_nifti.read_nifti(str(path))
    with pytest.raises(ValueError, match="cannot write"):
        t_nifti.write_nifti(str(tmp_path / "c.nii"),
                            np.zeros(3, np.complex64))
