"""Parity of the PyTorch port's plain ops with the JAX package's.

The same numpy inputs, made from a seed, go through each JAX function and
its port counterpart, in fp32 on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2tokenizer_torch.ops import attention as t_attn
from u2tokenizer_torch.ops import pooling as t_pool
from u2tokenizer_torch.ops import rotary as t_rot
from u2tokenizer_torch.ops import sampling as t_samp
from u2tokenizer_torch.ops import topk as t_topk
from u2tokenizer_tpu.ops import attention as j_attn
from u2tokenizer_tpu.ops import pooling as j_pool
from u2tokenizer_tpu.ops import rotary as j_rot
from u2tokenizer_tpu.ops import sampling as j_samp
from u2tokenizer_tpu.ops import topk as j_topk

pytestmark = pytest.mark.fast

# fp32 on both sides; sums run in different orders
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(out, ref, **tol):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               **(tol or TOL))


@pytest.mark.parametrize("scaling", [
    None,
    ("llama3", 32.0, 1.0, 4.0, 8192),
])
def test_rope_cos_sin(scaling):
    pos = np.arange(0, 4070, 37, dtype=np.int32).reshape(2, -1)
    jc, js = j_rot.rope_cos_sin(jnp.asarray(pos), 64, 500_000.0,
                                scaling=scaling)
    tc, ts = t_rot.rope_cos_sin(_t(pos), 64, 500_000.0, scaling=scaling)
    # cos/sin of arguments up to ~4000 rad: float32 argument rounding
    _close(tc, jc, rtol=0, atol=2e-4)
    _close(ts, js, rtol=0, atol=2e-4)


def test_apply_rope_and_rotate_half():
    x = _rand((2, 5, 3, 8), 0)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    jc, js = j_rot.rope_cos_sin(jnp.asarray(pos), 8, 10_000.0)
    tc, ts = t_rot.rope_cos_sin(_t(pos), 8, 10_000.0)
    _close(t_rot.rotate_half(_t(x)), j_rot.rotate_half(jnp.asarray(x)))
    _close(t_rot.apply_rope(_t(x), tc, ts),
           j_rot.apply_rope(jnp.asarray(x), jc, js))


@pytest.mark.parametrize("with_bias,with_mask", [(False, False), (True, False),
                                                 (False, True), (True, True)])
def test_sdpa(with_bias, with_mask):
    q, k, v = _rand((2, 6, 3, 8), 1), _rand((2, 7, 3, 8), 2), _rand(
        (2, 7, 3, 8), 3)
    bias = _rand((1, 3, 6, 7), 4) if with_bias else None
    mask = (np.random.RandomState(5).rand(2, 1, 6, 7) > 0.3) if with_mask \
        else None
    if mask is not None:
        mask[..., 0] = True
    j = j_attn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    bias=None if bias is None else jnp.asarray(bias),
                    mask=None if mask is None else jnp.asarray(mask))
    t = t_attn.sdpa(_t(q), _t(k), _t(v),
                    bias=None if bias is None else _t(bias),
                    mask=None if mask is None else _t(mask))
    _close(t, j)


@pytest.mark.parametrize("head_major", [False, True])
def test_gqa_sdpa(head_major):
    q = _rand((2, 5, 4, 8), 6)
    k, v = _rand((2, 9, 2, 8), 7), _rand((2, 9, 2, 8), 8)
    mask = np.arange(9)[None, None, None, :] <= (
        np.arange(5)[None, None, :, None] + 4)
    if head_major:
        kh, vh = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
        j = j_attn.gqa_sdpa_headmajor(jnp.asarray(q), jnp.asarray(kh),
                                      jnp.asarray(vh), mask=jnp.asarray(mask))
        t = t_attn.gqa_sdpa_headmajor(_t(q), _t(kh), _t(vh), mask=_t(mask))
    else:
        j = j_attn.gqa_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            mask=jnp.asarray(mask))
        t = t_attn.gqa_sdpa(_t(q), _t(k), _t(v), mask=_t(mask))
    _close(t, j)


def test_relative_position_bias():
    table = _rand((2 * 16 - 1, 3), 9)
    _close(t_attn.relative_position_bias(_t(table), 10, 16),
           j_attn.relative_position_bias(jnp.asarray(table), 10, 16))


def test_quantize_kv():
    x = _rand((2, 7, 3, 16), 10, scale=3.0)
    x[0, 0, 0] = 0.0  # an all-zero row takes the eps floor
    x[1, 2, 1, :2] = [127.0 * 0.5, -127.0 * 0.5]  # exact half-way values
    jq, js = j_attn.quantize_kv(jnp.asarray(x))
    tq, ts = t_attn.quantize_kv(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js.astype(jnp.float32)))


def test_gqa_sdpa_quantized():
    q = _rand((2, 3, 4, 16), 11)
    kq, ks = j_attn.quantize_kv(jnp.asarray(_rand((2, 10, 2, 16), 12)))
    vq, vs = j_attn.quantize_kv(jnp.asarray(_rand((2, 10, 2, 16), 13)))
    hm = lambda a: np.asarray(a).transpose(0, 2, 1, 3)
    kh, vh = hm(kq), hm(vq)
    ksh = np.asarray(ks.astype(jnp.float32))[..., 0].transpose(0, 2, 1)
    vsh = np.asarray(vs.astype(jnp.float32))[..., 0].transpose(0, 2, 1)
    mask = (np.arange(10)[None, :] < np.array([10, 6])[:, None])[
        :, None, None, :]
    j = j_attn.gqa_sdpa_quantized(
        jnp.asarray(q), jnp.asarray(kh), jnp.asarray(ksh), jnp.asarray(vh),
        jnp.asarray(vsh), mask=jnp.asarray(mask))
    t = t_attn.gqa_sdpa_quantized(_t(q), _t(kh), _t(ksh), _t(vh), _t(vsh),
                                  mask=_t(mask))
    _close(t, j, rtol=1e-5, atol=1e-4)  # int-valued operands up to 127


@pytest.mark.parametrize("scale", [1, 2, 4, 3])
def test_avg_pool_tokens(scale):
    x = _rand((2, 11, 5), 14)
    _close(t_pool.avg_pool_tokens(_t(x), scale),
           j_pool.avg_pool_tokens(jnp.asarray(x), scale))


def test_multi_scale_pool():
    x = _rand((2, 16, 5), 15)
    out = t_pool.multi_scale_pool(_t(x), (1, 2, 4))
    assert out.shape == (2, 16 + 8 + 4, 5)
    _close(out, j_pool.multi_scale_pool(jnp.asarray(x), (1, 2, 4)))


@pytest.mark.parametrize("grid,pool", [((8, 4, 2), 2), ((6, 4, 4), 2),
                                       ((4, 4, 4), 4)])
def test_spatial_pool_3d(grid, pool):
    x = _rand((2, int(np.prod(grid)), 3), 16)
    _close(t_pool.spatial_pool_3d(_t(x), grid, pool),
           j_pool.spatial_pool_3d(jnp.asarray(x), grid, pool))


def test_hard_topk_select():
    x = _rand((2, 20, 4), 17)
    # a permutation of distinct values: no ties for the two sorts to order
    scores = np.stack([np.random.RandomState(s).permutation(20)
                       for s in (18, 19)]).astype(np.float32)
    _close(t_topk.hard_topk_select(_t(x), _t(scores), 7),
           j_topk.hard_topk_select(jnp.asarray(x), jnp.asarray(scores), 7))


def test_greedy_and_sample():
    logits = _rand((3, 50), 20)
    ref = np.asarray(j_samp.greedy(jnp.asarray(logits)))
    got = t_samp.greedy(_t(logits))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        t_samp.sample(_t(logits), do_sample=False).numpy(), ref)
    with pytest.raises(ValueError, match="Generator"):
        t_samp.sample(_t(logits), do_sample=True)  # draws need a generator
    drawn = t_samp.sample(_t(logits), do_sample=True, top_p=0.5,
                          generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (3,) and drawn.dtype == torch.int64
