"""The plain versions of the port's flash-backward kernels against the JAX
package's Pallas backward, run in interpret mode on the CPU:

  K4a ``flash_bwd_lse``  <- ``flash_attention.py:_lse_kernel``
  K4b ``flash_bwd_dq``   <- ``flash_attention.py:_dq_kernel``
  K4c ``flash_bwd_dkv``  <- ``flash_attention.py:_dkv_kernel``

and the gradient of the port's ``flash_attention`` against ``jax.grad``
through the JAX package's. Inputs come from a numpy seed; the CUDA kernels
themselves are held against these plain versions by ``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from u2tokenizer_torch.ops import flash_attention as t_flash
from u2tokenizer_tpu.ops import flash_attention as j_flash

pytestmark = pytest.mark.fast

# fp32 on both sides; sums of up to 129 terms taken in another order
TOL = dict(rtol=2e-5, atol=2e-5)
BQ = 128  # the Pallas q block: 129 rows leave a ragged tail of 1

CASES = [
    # causal, b, s, h, hkv, d, lens
    (False, 1, 129, 2, 2, 32, None),           # ragged 129-row tail
    (False, 2, 129, 4, 2, 32, [129, 70]),      # GQA 2, padded query rows
    (True, 1, 129, 2, 2, 32, None),
    (True, 2, 129, 4, 2, 32, [129, 100]),      # GQA 2, ragged lens
    # the edges of the CUDA kernels' 64-row tiles: 193 = 3*64 + 1 rows end
    # one row into a tile and 191 one row before one; lens one past, one
    # short of and at a tile boundary (128), as chip_smoke.py's EDGE_CALLS
    (False, 3, 193, 2, 2, 32, [65, 63, 128]),
    (False, 3, 191, 4, 2, 32, [129, 127, 191]),
    (True, 3, 193, 4, 2, 32, [65, 63, 128]),
    (True, 3, 191, 2, 2, 32, [129, 127, 191]),
]
IDS = ["noncausal", "noncausal-gqa-lens", "causal", "causal-gqa-lens",
       "noncausal-tile-edge", "noncausal-gqa-tile-edge",
       "causal-gqa-tile-edge", "causal-tile-edge"]


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _inputs(b, s, h, hkv, d, lens):
    q = _rand((b, s, h, d), 0)
    k, v = _rand((b, s, hkv, d), 1), _rand((b, s, hkv, d), 2)
    do = _rand((b, s, h, d), 3)
    lens = np.full((b,), s, np.int32) if lens is None else np.array(
        lens, np.int32)
    return q, k, v, do, lens


def _heads_first(x):
    return jnp.transpose(jnp.asarray(x), (0, 2, 1, 3))


def _jax_lse(q, k, lens, causal, scale):
    """(B, H, Sq) from the Pallas ``_lse_kernel`` in interpret mode, called
    as ``_flash_bwd_raw`` calls it."""
    qh, kh = _heads_first(q), _heads_first(k)
    b, h, sq, d = qh.shape
    group = h // kh.shape[1]
    bk = 512
    sq_pad = (sq + BQ - 1) // BQ * BQ
    sk_pad = (kh.shape[2] + bk - 1) // bk * bk
    qh = jnp.pad(qh, ((0, 0), (0, 0), (0, sq_pad - sq), (0, 0)))
    kh = jnp.pad(kh, ((0, 0), (0, 0), (0, sk_pad - kh.shape[2]), (0, 0)))
    lse = pl.pallas_call(
        functools.partial(j_flash._lse_kernel, bq=BQ, bk=bk, causal=causal,
                          scale=scale),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(b, h, sq_pad // BQ),
            in_specs=[
                pl.BlockSpec((1, 1, BQ, d),
                             lambda bi, hi, qi, lens: (bi, hi, qi, 0)),
                pl.BlockSpec((1, 1, sk_pad, d),
                             lambda bi, hi, qi, lens: (bi, hi // group, 0,
                                                       0))],
            out_specs=pl.BlockSpec((1, 1, BQ, 1),
                                   lambda bi, hi, qi, lens: (bi, hi, qi, 0))),
        out_shape=jax.ShapeDtypeStruct((b, h, sq_pad, 1), jnp.float32),
        interpret=True,
    )(jnp.asarray(lens), qh, kh)
    return np.asarray(lse[:, :, :sq, 0])


def _torch_stats(q, k, v, do, lens, causal, scale):
    t = torch.from_numpy
    out = t_flash.flash_attention_reference(t(q), t(k), t(v), t(lens),
                                            causal=causal, scale=scale)
    dd = (t(do) * out).sum(-1).transpose(1, 2).contiguous()
    lse = t_flash.flash_bwd_lse_reference(t(q), t(k), t(lens), causal=causal,
                                          scale=scale)
    return out, dd, lse


@pytest.mark.parametrize("causal,b,s,h,hkv,d,lens", CASES, ids=IDS)
def test_plain_kernels_match_pallas(causal, b, s, h, hkv, d, lens):
    """lse against ``_lse_kernel``; dq, dk and dv against
    ``_flash_bwd_raw(..., interpret=True)`` on the same output."""
    q, k, v, do, lens = _inputs(b, s, h, hkv, d, lens)
    scale = 1.0 / d ** 0.5
    t = torch.from_numpy
    out, dd, lse = _torch_stats(q, k, v, do, lens, causal, scale)
    np.testing.assert_allclose(lse.numpy(),
                               _jax_lse(q, k, lens, causal, scale), **TOL)

    dq_ref, dk_ref, dv_ref = j_flash._flash_bwd_raw(
        _heads_first(q), _heads_first(k), _heads_first(v), jnp.asarray(lens),
        _heads_first(out.numpy()), _heads_first(do), causal, scale, BQ, True)
    args = (t(q), t(k), t(v), t(do), lse, dd, t(lens))
    dq = t_flash.flash_bwd_dq_reference(*args, causal=causal, scale=scale)
    dk, dv = t_flash.flash_bwd_dkv_reference(*args, causal=causal,
                                             scale=scale)
    for got, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jnp.transpose(ref, (0, 2, 1, 3))),
                                   **TOL)


@pytest.mark.parametrize("causal,b,s,h,hkv,d,lens", CASES, ids=IDS)
def test_plain_kernels_match_reference_vjp(causal, b, s, h, hkv, d, lens):
    """The three plain versions chained give ``jax.vjp`` of the JAX
    package's XLA reference."""
    q, k, v, do, lens = _inputs(b, s, h, hkv, d, lens)
    scale = 1.0 / d ** 0.5
    t = torch.from_numpy
    _, vjp = jax.vjp(lambda a, b_, c: j_flash._reference(
        a, b_, c, jnp.asarray(lens), causal, scale),
        _heads_first(q), _heads_first(k), _heads_first(v))
    refs = vjp(_heads_first(do))
    out, dd, lse = _torch_stats(q, k, v, do, lens, causal, scale)
    args = (t(q), t(k), t(v), t(do), lse, dd, t(lens))
    dq = t_flash.flash_bwd_dq_reference(*args, causal=causal, scale=scale)
    dk, dv = t_flash.flash_bwd_dkv_reference(*args, causal=causal,
                                             scale=scale)
    for got, ref in zip((dq, dk, dv), refs):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jnp.transpose(ref, (0, 2, 1, 3))),
                                   **TOL)


@pytest.mark.parametrize("causal,b,s,h,hkv,d,lens", CASES, ids=IDS)
def test_flash_gradient_matches_jax_grad(causal, b, s, h, hkv, d, lens):
    """``flash_attention(...).backward()`` in the port against ``jax.grad``
    through the JAX package's ``flash_attention(interpret=True)``; the CPU
    path launches no kernel."""
    q, k, v, do, lens = _inputs(b, s, h, hkv, d, lens)

    def loss(a, b_, c):
        o = j_flash.flash_attention(a, b_, c, jnp.asarray(lens),
                                    causal=causal, block_q=BQ, interpret=True)
        return jnp.sum(o * jnp.asarray(do))

    refs = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = dict(t_flash.launches)
    out = t_flash.flash_attention(tq, tk, tv, torch.from_numpy(lens),
                                  causal=causal)
    out.backward(torch.from_numpy(do))
    assert t_flash.launches == before  # the CPU path launches no kernel
    for got, ref in zip((tq.grad, tk.grad, tv.grad), refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_masked_keys_get_no_gradient():
    """Keys at or past a row's ``lens`` get dk = dv = 0, whatever attends."""
    q, k, v, do, lens = _inputs(2, 129, 4, 2, 32, [129, 70])
    tk, tv = (torch.from_numpy(x).requires_grad_() for x in (k, v))
    out = t_flash.flash_attention(torch.from_numpy(q), tk, tv,
                                  torch.from_numpy(lens))
    out.backward(torch.from_numpy(do))
    assert tk.grad[1, 70:].abs().max() == 0
    assert tv.grad[1, 70:].abs().max() == 0
    assert tk.grad[1, :70].abs().max() > 0
