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
    """The training mode is no longer refused: with every probability at
    0 it draws gates only and equals the validation mode."""
    off = t_tf.AugmentConfig(rotate90_prob=0.0, flip_prob=0.0,
                             scale_prob=0.0, shift_prob=0.0)
    vol = _ct((40, 36, 14))
    kw = dict(target_size=32, chunk_depth=4, num_chunks=4, device="cpu")
    train = t_tf.U2VolumeTransform("training", augment=off, seed=3, **kw)
    val = t_tf.U2VolumeTransform("validation", **kw)
    assert train.training and not val.training
    assert torch.equal(train.from_array(vol), val.from_array(vol))


class Script:
    """Scripted draws with numpy Generator's names: each call must be the
    next one in ``calls`` ((name, value) pairs) and returns its value, so
    that the JAX function and the port's take the same draws."""

    def __init__(self, calls):
        self.calls = list(calls)

    def _next(self, name):
        want, value = self.calls.pop(0)
        assert want == name, f"drew {name}, the script has {want}"
        return value

    def random(self):
        return self._next("random")

    def integers(self, low, high):
        assert (low, high) == (1, 4)
        return self._next("integers")

    def uniform(self, low, high):
        value = self._next("uniform")
        assert low <= value <= high
        return value


def _script(k, flips, scale, shift):
    """Draws that rotate by k (none for k 0), flip the axes in ``flips``,
    and scale by 1 + ``scale`` and shift by ``shift`` (None: not drawn)."""
    calls = [("random", 0.1)] + [("integers", k)] if k else [("random", 0.9)]
    calls += [("random", 0.05 if ax in flips else 0.5) for ax in (1, 2, 3)]
    for value in (scale, shift):
        calls += ([("random", 0.9)] if value is None
                  else [("random", 0.2), ("uniform", value)])
    return calls


# every k of rot90 (and none) with every pattern of the three flips; the
# port computes in fp32 where numpy takes float64: 1e-6 on values of ~1
@pytest.mark.parametrize("flips", [(), (1,), (2,), (3,), (1, 2), (1, 3),
                                   (2, 3), (1, 2, 3)])
@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_apply_augmentations_scripted(k, flips):
    x = np.random.RandomState(k).rand(1, 5, 7, 6)
    draws = _script(k, flips, 0.07, -0.03)
    cfg = j_tf.AugmentConfig()
    ref = j_tf.apply_augmentations(x, Script(draws), cfg)
    script = Script(draws)
    out = t_tf.apply_augmentations(_t(x), script, t_tf.AugmentConfig())
    assert not script.calls
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_augment_config_copies_jax():
    import dataclasses

    assert (dataclasses.asdict(t_tf.AugmentConfig())
            == dataclasses.asdict(j_tf.AugmentConfig()))


def test_torch_draws_order_and_ranges():
    """TorchDraws: one seed, one stream; values in numpy's ranges."""
    a, b = t_tf.TorchDraws(5), t_tf.TorchDraws(5)
    seq = [(a.random(), a.integers(1, 4), a.uniform(-0.1, 0.1))
           for _ in range(50)]
    assert seq == [(b.random(), b.integers(1, 4), b.uniform(-0.1, 0.1))
                   for _ in range(50)]
    assert all(0 <= r < 1 and 1 <= k < 4 and -0.1 <= u <= 0.1
               for r, k, u in seq)
    assert {k for _, k, _ in seq} == {1, 2, 3}


@pytest.mark.parametrize("k,flips", [(1, (2,)), (3, (1, 3))])
def test_training_transform_scripted(k, flips):
    """U2VolumeTransform('training') with the same draws as the JAX
    package's: augmented after the crop, before the resize (a rotation
    swaps X and Y, so the aspect ratio changes)."""
    vol = _ct((40, 28, 14), seed=4)
    draws = _script(k, flips, -0.05, 0.08)
    kw = dict(target_size=16, chunk_depth=4, num_chunks=4)
    jt = j_tf.U2VolumeTransform("training", **kw)
    jt.rng = Script(draws)
    tt = t_tf.U2VolumeTransform("training", device="cpu", **kw)
    tt.draws = Script(draws)
    np.testing.assert_allclose(tt.from_array(vol).numpy(), jt.from_array(vol),
                               rtol=0, atol=ATOL)


def test_normalize_ct():
    vol = _ct((20, 18, 9), seed=5)
    np.testing.assert_allclose(t_tf.normalize_ct(_t(vol)).numpy(),
                               j_tf.normalize_ct(vol), rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["validation", "training"])
def test_linear_volume_transform(tmp_path, mode):
    """LinearVolumeTransform from a file, (1, D, H, W) at a small
    out_shape; training with scripted draws."""
    vol = _ct((26, 22, 12), seed=6).astype(np.int16)
    path = str(tmp_path / "ct.nii")
    t_nifti.write_nifti(path, vol)
    shape = (8, 16, 16)
    jt = j_tf.LinearVolumeTransform(mode, out_shape=shape)
    tt = t_tf.LinearVolumeTransform(mode, out_shape=shape, device="cpu")
    if mode == "training":
        draws = _script(2, (1,), 0.04, 0.02)
        jt.rng, tt.draws = Script(draws), Script(draws)
    ref = jt(path)
    out = tt(path)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
