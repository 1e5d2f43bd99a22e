"""The port's volume transform against the JAX package's Python path.

``U2VolumeTransform(use_native=False)`` of the JAX package computes in
float64 with numpy and scipy; the port computes in fp32 with torch on the
CPU here (on the GPU in the chip run). Outputs lie in [0, 1], and fp32
rounding of the percentile scaling, the Gaussian taps and the
interpolation weights stays near 1e-6 of that: the tests hold 1e-4
absolute. Cases: volumes that need anti-aliasing on every axis, on some,
and on none (upsampling); a foreground crop; an all-air volume (no crop);
an axis resized to 1; and a volume deeper than the chunks hold.
"""

import numpy as np
import pytest
import torch

from u2tokenizer_torch.data import nifti as t_nifti
from u2tokenizer_torch.data import transforms as t_tf
from u2tokenizer_tpu.data import transforms as j_tf

pytestmark = pytest.mark.fast

ATOL = 1e-4


def _ct(shape, seed=0, air_border=True):
    rs = np.random.RandomState(seed)
    vol = rs.normal(40.0, 120.0, shape)
    if air_border:
        vol[:3], vol[:, -2:], vol[..., :1] = -1000.0, -1000.0, -1000.0
    return vol.astype(np.int16).astype(np.float64)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("shape,qs", [((37, 20, 11), (0.5, 99.5)),
                                      ((5,), (0.0, 50.0, 100.0)),
                                      ((4, 4), (12.5, 87.5))])
def test_percentiles(shape, qs):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    np.testing.assert_allclose(t_tf.percentiles(_t(x), qs),
                               np.percentile(x.astype(np.float64), qs),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["windowed", "flat"])
def test_scale_intensity_range_percentiles(case):
    x = _ct((12, 10, 9))[None]
    if case == "flat":
        x = np.full_like(x, 7.0)
    ref = j_tf.scale_intensity_range_percentiles(x)
    out = t_tf.scale_intensity_range_percentiles(_t(x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", ["crop", "all_air", "margin"])
def test_crop_foreground(case):
    x = np.zeros((1, 9, 8, 7), np.float32)
    if case != "all_air":
        x[0, 2:5, 3, 1:6] = 0.5
    margin = 1 if case == "margin" else 0
    ref = j_tf.crop_foreground(x, margin)
    out = t_tf.crop_foreground(_t(x), margin)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("in_size,out_size", [
    ((40, 30, 20), (17, 12, 20)),  # blur on two axes, one kept
    ((9, 8, 7), (20, 16, 7)),      # upsampling: no blur
    ((30, 6, 5), (4, 1, 5)),       # a wide kernel (sigma 3.25 > 6/2) and 1
    ((6, 7, 5), (6, 7, 5)),        # equal sizes: returned as it is
])
def test_resize_trilinear(in_size, out_size):
    x = np.random.RandomState(2).rand(*in_size)
    ref = j_tf.resize_trilinear(x, out_size)
    out = t_tf.resize_trilinear(_t(x), out_size)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape,geometry", [
    ((40, 36, 14), (32, 4, 4)),     # crop, blur in X and Y, depth kept
    ((20, 24, 40), (32, 4, 4)),     # upsampled in X/Y, depth cut to 16
    ((70, 30, 9), (16, 2, 4)),      # ratio set by X, depth kept
])
def test_volume_transform_from_array(shape, geometry):
    target, depth, chunks = geometry
    vol = _ct(shape)
    ref = j_tf.U2VolumeTransform(target_size=target, chunk_depth=depth,
                                 num_chunks=chunks,
                                 use_native=False).from_array(vol)
    out = t_tf.U2VolumeTransform(target_size=target, chunk_depth=depth,
                                 num_chunks=chunks,
                                 device="cpu").from_array(vol)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


def test_volume_transform_all_air(tmp_path):
    """No voxel above the window's floor: nothing is cropped."""
    vol = np.full((10, 12, 6), -1000, np.int16)
    path = str(tmp_path / "air.nii.gz")
    t_nifti.write_nifti(path, vol)
    kw = dict(target_size=16, chunk_depth=4, num_chunks=2)
    ref = j_tf.U2VolumeTransform(use_native=False, **kw)(path)
    out = t_tf.U2VolumeTransform(device="cpu", **kw)(path)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


def test_volume_transform_reads_scaled_nifti(tmp_path):
    """From a file: stored int16 with a slope and intercept, scaled on the
    port's device in fp32, against the JAX package's float64 read."""
    vol = _ct((30, 26, 12), seed=3).astype(np.int16)
    path = str(tmp_path / "ct.nii")
    t_nifti.write_nifti(path, vol, scl_slope=0.5, scl_inter=-24.0)
    kw = dict(target_size=16, chunk_depth=4, num_chunks=4)
    ref = j_tf.U2VolumeTransform(use_native=False, **kw)(path)
    out = t_tf.U2VolumeTransform(device="cpu", **kw)(path)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


def test_training_mode_is_refused():
    with pytest.raises(NotImplementedError):
        t_tf.U2VolumeTransform("training", device="cpu")
