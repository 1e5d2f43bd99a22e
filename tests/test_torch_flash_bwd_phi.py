"""The plain versions of the flash-backward kernels K4a-c at the Phi head
dims, 80 (Phi-2) and 96 (Phi-3), against the JAX package's Pallas backward
in interpret mode on the CPU (``_lse_kernel`` and ``_flash_bwd_raw``),
causal and not, GQA and MHA, at small shapes on the edges of the CUDA
kernels' 64-row tiles; and the port's ``flash_attention`` gradient at
D=96 against ``jax.grad``. The CUDA forms at these head dims (D=128's
tiles, ``csrc/flash_bwd.cu``) are held against the same plain versions on
the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_flash_bwd import (BQ, TOL, _heads_first, _inputs, _jax_lse,
                                  _torch_stats)
from u2tokenizer_torch.ops import flash_attention as t_flash
from u2tokenizer_tpu.ops import flash_attention as j_flash

pytestmark = pytest.mark.fast

CASES = [
    # causal, b, s, h, hkv, lens
    (False, 1, 129, 2, 2, None),            # MHA, a ragged 129-row tail
    (True, 2, 129, 4, 2, [129, 100]),       # GQA 2, ragged lens
    (False, 3, 193, 4, 2, [65, 63, 128]),   # tile edges, GQA 2
    (True, 3, 193, 2, 2, [65, 63, 128]),    # tile edges, MHA
]
IDS = ["noncausal-mha", "causal-gqa-lens", "noncausal-gqa-tile-edge",
       "causal-mha-tile-edge"]


@pytest.mark.parametrize("d", [80, 96])
@pytest.mark.parametrize("causal,b,s,h,hkv,lens", CASES, ids=IDS)
def test_plain_kernels_match_pallas_at_phi_head_dims(causal, b, s, h, hkv,
                                                     lens, d):
    """lse against ``_lse_kernel``; dq, dk and dv against
    ``_flash_bwd_raw(..., interpret=True)`` on the same output; fp32 on
    both sides (TOL of ``test_torch_flash_bwd.py``: sums of up to 193
    terms in another order)."""
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
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jnp.transpose(ref, (0, 2, 1, 3))), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_gradient_at_d96_matches_jax_grad(causal):
    """``flash_attention(...).backward()`` at Phi-3's head dim against
    ``jax.grad`` through the JAX package's ``flash_attention(interpret=
    True)``, GQA 2 with ragged lens; the CPU path launches no kernel, at
    any head dim."""
    q, k, v, do, lens = _inputs(2, 129, 4, 2, 96, [129, 70])

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
    assert t_flash.launches == before
    for got, ref in zip((tq.grad, tk.grad, tv.grad), refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_launch_counters_by_head_dim():
    """Every kernel has one counter at each head dim it takes, and the
    backward takes the forward's head dims."""
    assert t_flash.BWD_HEAD_DIMS == t_flash.FWD_HEAD_DIMS == (64, 80, 96, 128)
    assert set(t_flash.launches) == {
        f"{name}_d{d}" for name in t_flash.KERNELS + t_flash.BWD_KERNELS
        for d in t_flash.FWD_HEAD_DIMS}
