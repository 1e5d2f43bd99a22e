"""The plain versions of the port's three attention kernels against the JAX
package's Pallas kernels, run in interpret mode on the CPU:

  K1 ``flash_fwd_noncausal``   <- ``flash_attention.py:_kernel``
  K2 ``flash_fwd_causal``      <- ``flash_attention.py:_kernel_causal_chunked``
  K3 ``decode_attention_int8`` <- ``decode_attention.py:_decode_kernel``

On a CPU tensor each wrapper computes its plain version; the CUDA kernels
themselves are checked against those plain versions by ``chip_smoke.py`` on
the GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2tokenizer_torch.ops import decode_attention as t_dec
from u2tokenizer_torch.ops import flash_attention as t_flash
from u2tokenizer_tpu.ops import attention as j_attn
from u2tokenizer_tpu.ops import decode_attention as j_dec
from u2tokenizer_tpu.ops.flash_attention import flash_attention as j_flash

pytestmark = pytest.mark.fast

# fp32 on both sides, the repo's flash-kernel tolerance
TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("causal,b,s,h,hkv,d,lens", [
    # ragged tail: 129 = 128 + 1 queries and keys, block_q 128
    (False, 1, 129, 2, 2, 32, None),
    (False, 2, 129, 4, 2, 32, [129, 70]),
    (True, 1, 129, 2, 2, 32, None),
    # GQA with per-row lens; rows past a row's length are compared too
    (True, 2, 128, 8, 2, 32, [100, 64]),
    # the CUDA kernels' head dims and the edges of their 64-row tiles:
    # 193 = 3*64 + 1 tokens, lens one past, one short of and at a tile
    # boundary; K1's D=64 on 129 tokens, the ragged tail of the ViT's 2049
    (False, 3, 193, 2, 2, 64, [65, 63, 128]),
    (True, 3, 193, 4, 2, 128, [65, 63, 128]),
    (False, 1, 129, 2, 2, 64, None),
])
def test_flash_plain_matches_pallas(causal, b, s, h, hkv, d, lens):
    q = _rand((b, s, h, d), 0)
    k, v = _rand((b, s, hkv, d), 1), _rand((b, s, hkv, d), 2)
    lens_np = None if lens is None else np.array(lens, np.int32)
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  None if lens is None else jnp.asarray(lens_np),
                  causal=causal, block_q=128, interpret=True)
    before = dict(t_flash.launches)
    out = t_flash.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if lens is None else torch.from_numpy(lens_np), causal=causal)
    assert t_flash.launches == before  # the CPU path launches no kernel
    assert out.shape == (b, s, h, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _decode_inputs(seed=3):
    b, h, hkv, d, s_prompt, s_total = 2, 4, 2, 16, 16, 24
    # q*scale (scale = 1/4) is exact in bf16, as the Pallas kernel rounds it
    q = torch.from_numpy(_rand((b, 1, h, d), seed)).bfloat16().float().numpy()
    kq, ks = j_attn.quantize_kv(jnp.asarray(_rand((b, s_total, hkv, d), 4)))
    vq, vs = j_attn.quantize_kv(jnp.asarray(_rand((b, s_total, hkv, d), 5)))
    hm = lambda a: np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1, 3))
    sc = lambda a: np.ascontiguousarray(
        np.asarray(a.astype(jnp.float32))[..., 0].transpose(0, 2, 1))
    # row 0: full prompt; row 1: prompt of 11 (pad gap 11..15); both have
    # generated slots 16..19 and unwritten slots 20..23
    plen = np.array([16, 11], np.int32)
    end = np.array([20, 20], np.int32)
    return q, hm(kq), sc(ks), hm(vq), sc(vs), plen, end, s_prompt


def _torch_decode(q, kh, ksh, vh, vsh, plen, end, s_prompt):
    t = torch.from_numpy
    return t_dec.decode_attention_quantized(
        t(q), t(kh), t(ksh).bfloat16(), t(vh), t(vsh).bfloat16(), t(plen),
        t(end), s_prompt)


def test_decode_plain_matches_reference():
    """Against the JAX package's XLA version of the same function."""
    q, kh, ksh, vh, vsh, plen, end, s_prompt = _decode_inputs()
    ref = j_dec._reference(jnp.asarray(q), jnp.asarray(kh), jnp.asarray(ksh),
                           jnp.asarray(vh), jnp.asarray(vsh),
                           jnp.asarray(plen), jnp.asarray(end), s_prompt,
                           1.0 / 4.0)
    before = dict(t_dec.launches)
    out = _torch_decode(q, kh, ksh, vh, vsh, plen, end, s_prompt)
    assert t_dec.launches == before
    # int-valued operands up to 127 in fp32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)


def test_decode_plain_matches_pallas():
    """Against the Pallas kernel itself, which rounds the probabilities to
    bf16 before the value product: a bf16 tolerance (2^-8 relative)."""
    q, kh, ksh, vh, vsh, plen, end, s_prompt = _decode_inputs()
    ref = j_dec.decode_attention_quantized(
        jnp.asarray(q), jnp.asarray(kh), jnp.asarray(ksh), jnp.asarray(vh),
        jnp.asarray(vsh), jnp.asarray(plen), jnp.asarray(end), s_prompt,
        interpret=True)
    out = _torch_decode(q, kh, ksh, vh, vsh, plen, end, s_prompt)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-2,
                               atol=1e-2)


def test_decode_visible_keys_two_intervals():
    plen = torch.tensor([16, 11], dtype=torch.int32)
    end = torch.tensor([20, 17], dtype=torch.int32)
    vis = t_dec.visible_keys(plen, end, 16, 24)
    want = np.zeros((2, 24), bool)
    want[0, :20] = True
    want[1, :11] = True
    want[1, 16:17] = True
    np.testing.assert_array_equal(vis.numpy(), want)


def test_wrappers_refuse_other_devices():
    """A wrapper computes its plain version only for CPU tensors; any other
    non-CUDA device is refused rather than computed some other way."""
    q = torch.empty(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError):
        t_flash.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        t_dec.decode_attention_quantized(q[:, :1], q, q[..., 0], q, q[..., 0],
                                         q[0, 0, 0, :1], q[0, 0, 0, :1], 2)


def test_flash_operand_checks():
    """The CUDA path's operand checks run before any launch."""
    x = torch.zeros(1, 8, 2, 64)
    with pytest.raises(TypeError):
        t_flash._check_operand(x, "q")  # fp32: the kernel takes bf16
    y = torch.zeros(1, 8, 2, 68, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        t_flash._check_operand(y, "q")  # head stride 68: no 16-byte rows
    t_flash._check_operand(y[..., :64].contiguous(), "q")
