"""The port's SegVol head (``u2tokenizer_torch/models/seg.py``) against the
JAX package's, module by module, on ``SegConfig.tiny()`` in fp32 on the
CPU.

One set of flax parameters, its zero biases re-drawn from a numpy seed so
that every parameter matters, goes into both, the port's through
``load_flax_params``. Inputs come from numpy seeds. Tolerance: 2e-5
absolute and relative on every output (fp32, one encoder and one decoder
layer). The same tolerance rejects the three likely faults of a port: the
transposed convolution's kernel taken without its spatial flip, the exact
GELU in place of flax's tanh form, and a downsampling resize without
antialiasing (``F.interpolate``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import traverse_util

from u2tokenizer_torch.config import SegConfig as TSeg
from u2tokenizer_torch.models import seg as t_seg
from u2tokenizer_torch.weights import flax_params, flatten, load_flax_params
from u2tokenizer_tpu.config import SegConfig as JSeg
from u2tokenizer_tpu.models import seg as j_seg

pytestmark = pytest.mark.fast

TOL = dict(rtol=2e-5, atol=2e-5)
B = 2


def _close(out, ref):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


def _far(out, ref):
    """The fault shows: some element lies outside the tolerance."""
    assert not np.allclose(out.detach().numpy(), np.asarray(ref), **TOL)


def _redraw(params, rs):
    flat = {k: np.array(v) for k, v in
            traverse_util.flatten_dict(params["params"], sep="/").items()}
    for k in flat:
        if k.endswith("bias"):
            flat[k] = (rs.randn(*flat[k].shape) * 0.1).astype(np.float32)
    tree = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
    return tree, flat


@pytest.fixture(scope="module")
def segvol():
    jcfg = JSeg.tiny()
    tcfg = TSeg(**dataclasses.asdict(jcfg))
    rs = np.random.RandomState(0)
    image = rs.randn(B, 1, *jcfg.image_size).astype(np.float32)
    prompt = rs.randn(B, jcfg.prompt_dim).astype(np.float32)
    jm = j_seg.SegVol3D(jcfg, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(image),
                     jnp.asarray(prompt))
    params, flat = _redraw(params, rs)
    tm = t_seg.SegVol3D(tcfg, dtype=torch.float32, device="cpu")
    load_flax_params(tm, flat)
    return jm, params, tm, flat, image, prompt


def test_config_copy():
    j, t = JSeg.tiny(), TSeg.tiny()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.feat_shape == j.feat_shape
    assert TSeg().feat_shape == JSeg().feat_shape == (8, 16, 16)


def test_image_encoder(segvol):
    jm, params, tm, _, image, _ = segvol
    ref = jm.apply(params, jnp.asarray(image),
                   method=lambda m, x: m.image_encoder(x))
    with torch.no_grad():
        out = tm.image_encoder(torch.from_numpy(image))
    assert out.shape == ref.shape
    _close(out, ref)


@pytest.mark.parametrize("with_prompt", [True, False],
                         ids=["prompt", "no_prompt"])
def test_prompt_encoder(segvol, with_prompt):
    jm, params, tm, _, _, prompt = segvol
    arg = jnp.asarray(prompt) if with_prompt else None
    (s_ref, d_ref), pe_ref = jm.apply(
        params, method=lambda m: (m.prompt_encoder(arg, B),
                                  m.prompt_encoder.dense_pe()))
    with torch.no_grad():
        sparse, dense = tm.prompt_encoder(
            torch.from_numpy(prompt) if with_prompt else None, B)
        pe = tm.prompt_encoder.dense_pe()
    assert sparse.shape == s_ref.shape
    for out, ref in ((sparse, s_ref), (dense, d_ref), (pe, pe_ref)):
        _close(out, ref)


def _decoder_inputs(cfg, seed):
    rs = np.random.RandomState(seed)
    n = int(np.prod(cfg.feat_shape))
    return [rs.randn(*shape).astype(np.float32) for shape in
            ((B, n, cfg.prompt_dim), (1, n, cfg.prompt_dim),
             (B, 1, cfg.prompt_dim), (B, n, cfg.prompt_dim))]


def test_mask_decoder(segvol):
    jm, params, tm, _, _, _ = segvol
    args = _decoder_inputs(tm.cfg, 3)
    ref_logits, ref_iou = jm.apply(
        params, *map(jnp.asarray, args),
        method=lambda m, *a: m.mask_decoder(*a))
    with torch.no_grad():
        logits, iou = tm.mask_decoder(*map(torch.from_numpy, args))
    assert logits.shape == ref_logits.shape == (B, 1, 16, 16, 16)
    _close(logits, ref_logits)
    _close(iou, ref_iou)


def test_mask_decoder_rejects_unflipped_transposed_conv(segvol, monkeypatch):
    """Torch's ``conv_transpose3d`` layout (tap a to output 2i + a) is not
    flax's (tap 1 - a): the kernel without its flip misses the reference."""
    jm, params, tm, _, _, _ = segvol
    args = _decoder_inputs(tm.cfg, 3)
    ref_logits, _ = jm.apply(params, *map(jnp.asarray, args),
                             method=lambda m, *a: m.mask_decoder(*a))

    def unflipped(self, x):
        b, d, h, w, _ = x.shape
        k = self.kernel.permute(3, 4, 0, 1, 2)  # (in, out, 2, 2, 2)
        y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), k, self.bias,
                               stride=2)
        return y.permute(0, 2, 3, 4, 1)

    with torch.no_grad():
        right, _ = tm.mask_decoder(*map(torch.from_numpy, args))
        monkeypatch.setattr(t_seg.ConvTranspose3d, "forward", unflipped)
        wrong, _ = tm.mask_decoder(*map(torch.from_numpy, args))
    _close(right, ref_logits)
    _far(wrong, ref_logits)


def test_conv_transpose_is_flax_conv_transpose():
    """One layer alone against ``flax.linen.ConvTranspose``, bias zero."""
    from flax import linen as nn

    rs = np.random.RandomState(4)
    x = rs.randn(2, 3, 2, 4, 6).astype(np.float32)
    layer = nn.ConvTranspose(5, (2, 2, 2), (2, 2, 2))
    p = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = layer.apply(p, jnp.asarray(x))
    tm = t_seg.ConvTranspose3d(6, 5, device="cpu")
    load_flax_params(tm, flatten(jax.tree_util.tree_map(np.asarray, p)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.shape == ref.shape == (2, 6, 4, 8, 5)
    _close(out, ref)


@pytest.mark.parametrize("with_prompt", [True, False],
                         ids=["prompt", "no_prompt"])
def test_segvol(segvol, with_prompt):
    jm, params, tm, _, image, prompt = segvol
    ref = jm.apply(params, jnp.asarray(image),
                   jnp.asarray(prompt) if with_prompt else None)
    with torch.no_grad():
        out = tm(torch.from_numpy(image),
                 torch.from_numpy(prompt) if with_prompt else None)
    assert out.shape == image.shape
    _close(out, ref)


def test_segvol_rejects_exact_gelu(segvol, monkeypatch):
    """flax's ``nn.gelu`` is the tanh form; the exact GELU misses."""
    jm, params, tm, _, image, prompt = segvol
    ref = jm.apply(params, jnp.asarray(image), jnp.asarray(prompt))
    monkeypatch.setattr(t_seg, "gelu",
                        lambda x: F.gelu(x, approximate="none"))
    with torch.no_grad():
        wrong = tm(torch.from_numpy(image), torch.from_numpy(prompt))
    _far(wrong, ref)


def test_seg_projector():
    rs = np.random.RandomState(5)
    hidden = rs.randn(B, 48).astype(np.float32)
    jm = j_seg.SegProjector(32, dtype=jnp.float32)
    params, flat = _redraw(jm.init(jax.random.PRNGKey(2),
                                   jnp.asarray(hidden)), rs)
    tm = t_seg.SegProjector(48, 32, device="cpu")
    load_flax_params(tm, flat)
    with torch.no_grad():
        out = tm(torch.from_numpy(hidden))
    _close(out, jm.apply(params, jnp.asarray(hidden)))


def test_flax_params_round_trip(segvol):
    """``flax_params`` gives the head back in flax's layout, bit for bit."""
    _, _, tm, flat, _, _ = segvol
    back = flatten(flax_params(tm))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
    assert back["mask_decoder/up1/kernel"].shape == (2, 2, 2, 32, 8)


@pytest.mark.parametrize("src,dst", [
    ((8, 12, 10), (16, 24, 20)),   # upsample, the head's own resize
    ((8, 12, 10), (4, 6, 5)),      # downsample: antialiased
    ((16, 32, 32), (16, 20, 44)),  # one axis kept, one shrunk, one grown
    ((5, 7, 9), (3, 11, 4)),       # odd factors
], ids=["up", "down", "mixed", "odd"])
def test_trilinear_resize(src, dst):
    x = np.random.RandomState(6).randn(2, 1, *src).astype(np.float32)
    ref = np.asarray(j_seg.trilinear_resize(jnp.asarray(x), dst))
    out = t_seg.trilinear_resize(torch.from_numpy(x), dst)
    assert out.shape == ref.shape
    _close(out, ref)


def test_trilinear_resize_rejects_plain_interpolate():
    """``F.interpolate`` matches upsampling, not a shrinking resize."""
    x = np.random.RandomState(7).randn(1, 1, 8, 12, 10).astype(np.float32)
    for dst, agree in (((16, 24, 20), True), ((4, 6, 5), False)):
        ref = np.asarray(j_seg.trilinear_resize(jnp.asarray(x), dst))
        plain = F.interpolate(torch.from_numpy(x), size=dst,
                              mode="trilinear", align_corners=False)
        (_close if agree else _far)(plain, ref)


def _sphere(shape):
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, n) for n in shape],
                          indexing="ij")
    return (z ** 2 + y ** 2 + x ** 2 < 0.4).astype(np.float32)


@pytest.mark.parametrize("name", ["dice_loss", "bce_loss", "seg_loss"])
def test_losses_and_gradients(name):
    rs = np.random.RandomState(8)
    logits = (rs.randn(B, 1, 4, 8, 8) * 3).astype(np.float32)
    target = np.broadcast_to(_sphere((4, 8, 8)), logits.shape).copy()
    target[1] *= 0.0  # one row with an empty mask
    jfn, tfn = getattr(j_seg, name), getattr(t_seg, name)
    ref, ref_grad = jax.value_and_grad(jfn)(jnp.asarray(logits),
                                            jnp.asarray(target))
    z = torch.from_numpy(logits).requires_grad_(True)
    out = tfn(z, torch.from_numpy(target))
    (grad,) = torch.autograd.grad(out, z)
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)
    _close(grad, ref_grad)
