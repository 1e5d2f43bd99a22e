"""The PyTorch port's int4 KV cache against the JAX package's, on the CPU.

torch has no int4 dtype, so the port packs the cache: k/v (B, Hkv, S, D/2)
int8, two values a byte along D, the low nibble the even d
(``ops.attention.pack_nibbles``). The JAX package stores ``jnp.int4``.
Inputs come from numpy seeds; each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from u2tokenizer_torch.config import LLMConfig as TLLM
from u2tokenizer_torch.models.llm.decoder import CausalLM as TLM
from u2tokenizer_torch.models.llm.decoder import KVCache as TCache
from u2tokenizer_torch.ops import attention as t_attn
from u2tokenizer_torch.ops import decode_attention as t_dec
from u2tokenizer_torch.weights import load_flax_params
from u2tokenizer_tpu.config import LLMConfig as JLLM
from u2tokenizer_tpu.models.llm.decoder import CausalLM as JLM
from u2tokenizer_tpu.models.llm.decoder import KVCache as JCache
from u2tokenizer_tpu.ops import attention as j_attn
from u2tokenizer_tpu.ops import decode_attention as j_dec

pytestmark = pytest.mark.fast


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_int4_bit_equal(dtype):
    """7 levels, round half to even, bf16 scales: integers and scales
    bit-equal to JAX's for fp32 and bf16 rows."""
    x = _rand((2, 9, 3, 32), 20, scale=3.0)
    x[0, 0, 0] = 0.0  # an all-zero row takes the eps floor
    x[1, 2, 1, :2] = [7.0 * 0.5, -7.0 * 1.5]  # half-way values at scale 1
    x[1, 2, 1, 2] = 7.0
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = j_attn.quantize_kv(jx, dtype=jnp.int4)
    tq, ts = t_attn.quantize_kv(tx, dtype="int4")
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert int(tq.abs().max()) <= 7
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).astype(np.int8))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js.astype(jnp.float32)))


def test_nibble_pack_round_trip():
    """Every byte unpacks to its two sign-extended nibbles, low nibble
    first, and packs back; values in [-8, 7] survive a round trip."""
    every = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    pairs = t_attn.unpack_nibbles(every)
    assert pairs.shape == (512,)
    lo, hi = pairs[0::2].int(), pairs[1::2].int()
    raw = every.int() & 0xFF
    np.testing.assert_array_equal(lo.numpy(),
                                  ((raw & 0xF) ^ 8).numpy() - 8)
    np.testing.assert_array_equal(hi.numpy(), ((raw >> 4) ^ 8).numpy() - 8)
    np.testing.assert_array_equal(t_attn.pack_nibbles(pairs).numpy(),
                                  every.numpy())
    vals = torch.from_numpy(np.random.RandomState(21).randint(
        -8, 8, (2, 3, 5, 32)).astype(np.int8))
    packed = t_attn.pack_nibbles(vals)
    assert packed.shape == (2, 3, 5, 16) and packed.dtype == torch.int8
    torch.testing.assert_close(t_attn.unpack_nibbles(packed), vals,
                               rtol=0, atol=0)
    assert t_attn.pack_nibbles(torch.tensor([1, 2, -1, -8])).tolist() == [
        0x21, -128 | 0x0F]


def _cache_pair():
    jcfg = JLLM.tiny()
    tcfg = TLLM(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    b, s = 2, 12
    jm = JLM(jcfg, dtype=jnp.float32)
    emb = _rand((b, s, jcfg.hidden_size), 22)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(emb),
                     jnp.zeros((b, s), jnp.int32),
                     jnp.ones((b, 1, s, s), bool))
    flat = {k: np.array(v) for k, v in
            traverse_util.flatten_dict(params["params"], sep="/").items()}
    tm = TLM(tcfg, dtype=torch.float32, device="cpu")
    load_flax_params(tm, flat)
    return jcfg, jm, params, tm, emb


def test_int4_cache_contents_match_jax():
    """Prefill of a right-padded batch and 3 decode steps of a tiny decoder
    with the int4 cache: the port's packed cache, unpacked, holds the JAX
    package's int4 values, and its scales are bitwise JAX's."""
    jcfg, jm, params, tm, emb = _cache_pair()
    b, s, steps = emb.shape[0], emb.shape[1], 3
    total = s + steps
    plen = np.array([s, 9], np.int32)
    tokens = np.random.RandomState(23).randint(0, jcfg.vocab_size,
                                               (steps, b)).astype(np.int32)
    att = np.arange(s)[None, :] < plen[:, None]
    mask = att[:, None, None, :] & np.tril(np.ones((s, s), bool))[None, None]
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))

    jc = JCache.create(jcfg, b, total, "int4")
    _, _, jc = jm.apply(params, jnp.asarray(emb), jnp.asarray(pos),
                        jnp.asarray(mask), jc, jnp.int32(0),
                        jnp.asarray(plen), compute_logits=False)
    tc = TCache.create(tm.cfg, b, total, "int4")
    assert tc.k[0].shape == (b, jcfg.num_kv_heads, total,
                             jcfg.head_dim // 2)
    t = torch.from_numpy
    with torch.no_grad():
        tm(t(emb), t(pos), t(mask), tc, 0, t(plen), compute_logits=False)
        kv = np.arange(total)
        for i in range(steps):
            key_ok = (kv[None, :] < plen[:, None]) | (
                (kv >= s) & (kv <= s + i))[None, :]
            step_pos = (plen + i)[:, None].astype(np.int32)
            m = key_ok[:, None, None, :]
            jemb = jm.apply(params, jnp.asarray(tokens[i][:, None]),
                            method="embed_tokens")
            _, _, jc = jm.apply(params, jemb, jnp.asarray(step_pos),
                                jnp.asarray(m), jc, jnp.int32(s + i),
                                method="decode_step")
            temb = tm.embed_tokens(t(tokens[i][:, None]).long())
            tm(temb, t(step_pos), t(m), tc, s + i,
               decode_bounds=(t(plen), t(np.full(b, s + i + 1, np.int32)),
                              s))
    for i in range(jcfg.num_layers):
        for tbuf, jbuf in ((tc.k[i], jc.k[i]), (tc.v[i], jc.v[i])):
            np.testing.assert_array_equal(
                t_attn.unpack_nibbles(tbuf).numpy(),
                np.asarray(jbuf).astype(np.int8))
        for tbuf, jbuf in ((tc.k_scale[i], jc.k_scale[i]),
                           (tc.v_scale[i], jc.v_scale[i])):
            np.testing.assert_array_equal(
                tbuf.float().numpy(), np.asarray(jbuf.astype(jnp.float32)))


def _decode_inputs(seed=24):
    """A decode step over an int4 cache: JAX's int4 arrays and the port's
    packed bytes of the same values. Row 0 has a full prompt; row 1 a
    prompt of 11 (pad gap 11..15); both have generated slots 16..19 and
    unwritten slots 20..23."""
    b, h, hkv, d, s_prompt, s_total = 2, 4, 2, 16, 16, 24
    # q*scale (scale = 1/4) is exact in bf16, as the Pallas kernel rounds it
    q = torch.from_numpy(_rand((b, 1, h, d), seed)).bfloat16().float().numpy()
    kq, ks = j_attn.quantize_kv(jnp.asarray(_rand((b, s_total, hkv, d), 25)),
                                dtype=jnp.int4)
    vq, vs = j_attn.quantize_kv(jnp.asarray(_rand((b, s_total, hkv, d), 26)),
                                dtype=jnp.int4)
    hm = lambda a: jnp.transpose(a, (0, 2, 1, 3))
    sc = lambda a: np.ascontiguousarray(
        np.asarray(a.astype(jnp.float32))[..., 0].transpose(0, 2, 1))
    jk, jv = hm(kq), hm(vq)
    packed = lambda a: t_attn.pack_nibbles(
        torch.from_numpy(np.asarray(a).astype(np.int8)))
    plen = np.array([16, 11], np.int32)
    end = np.array([20, 20], np.int32)
    jax_args = (jnp.asarray(q), jk, jnp.asarray(sc(ks)), jv,
                jnp.asarray(sc(vs)), jnp.asarray(plen), jnp.asarray(end))
    t = torch.from_numpy
    torch_args = (t(q), packed(jk), t(sc(ks)).bfloat16(), packed(jv),
                  t(sc(vs)).bfloat16(), t(plen), t(end))
    return jax_args, torch_args, s_prompt


def test_plain_int4_decode_matches_reference():
    """The port's plain K3 on the packed cache against the JAX package's
    XLA version on its int4 cache: fp32 sums of int-valued operands."""
    jax_args, torch_args, s_prompt = _decode_inputs()
    ref = j_dec._reference(*jax_args, s_prompt, 1.0 / 4.0)
    before = dict(t_dec.launches)
    out = t_dec.decode_attention_quantized(*torch_args, s_prompt)
    assert t_dec.launches == before  # the CPU path launches no kernel
    assert out.shape == (2, 1, 4, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_plain_int4_decode_matches_pallas():
    """Against the Pallas kernel on int4 inputs in interpret mode, which
    rounds the probabilities to bf16 before the value product: a bf16
    tolerance (2^-8 relative and more), as tests/test_flash_attention.py
    holds it to its XLA version."""
    jax_args, torch_args, s_prompt = _decode_inputs()
    ref = j_dec.decode_attention_quantized(*jax_args, s_prompt,
                                           interpret=True)
    out = t_dec.decode_attention_quantized(*torch_args, s_prompt)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-2,
                               atol=1e-2)


def test_int4_wrapper_refuses_devices_and_operands():
    """Only CPU tensors take the plain version; the CUDA path's operand
    checks name the int4 entry for a packed cache and refuse what the
    kernel does not take, before any launch."""
    b, h, hkv, d, sk = 2, 4, 2, 64, 32
    q = torch.zeros(b, 1, h, d, dtype=torch.bfloat16)
    k = torch.zeros(b, hkv, sk, d // 2, dtype=torch.int8)
    sc = torch.zeros(b, hkv, sk, dtype=torch.bfloat16)
    n = torch.zeros(b, dtype=torch.int32)
    meta = lambda x: x.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        t_dec.decode_attention_quantized(*map(meta, (q, k, sc, k, sc, n, n)),
                                         16)
    assert t_dec.check_operands(q, k, sc, k, sc, n, n) == \
        "decode_attention_int4"
    assert t_dec.check_operands(
        q, torch.zeros(b, hkv, sk, d, dtype=torch.int8), sc,
        torch.zeros(b, hkv, sk, d, dtype=torch.int8), sc, n, n) == \
        "decode_attention_int8"
    bad = {
        "odd row": dict(k=torch.zeros(b, hkv, sk, 24, dtype=torch.int8)),
        "uint8 cache": dict(k=k.to(torch.uint8)),
        "v not packed": dict(v=torch.zeros(b, hkv, sk, d, dtype=torch.int8)),
        "fp32 q": dict(q=q.float()),
        "fp32 scales": dict(ks=sc.float()),
        "int64 lengths": dict(plen=n.long()),
        "strided cache": dict(k=torch.zeros(b, sk, hkv, d // 2,
                                            dtype=torch.int8).transpose(1, 2)),
        "D=96": dict(q=torch.zeros(b, 1, h, 96, dtype=torch.bfloat16),
                     k=torch.zeros(b, hkv, sk, 48, dtype=torch.int8),
                     v=torch.zeros(b, hkv, sk, 48, dtype=torch.int8)),
        "group 3": dict(q=torch.zeros(b, 1, 6, d, dtype=torch.bfloat16)),
    }
    for label, change in bad.items():
        args = dict(q=q, k=k, ks=sc, v=k, vs=sc, plen=n, end=n)
        args.update(change)
        with pytest.raises(ValueError):
            t_dec.check_operands(args["q"], args["k"], args["ks"], args["v"],
                                 args["vs"], args["plen"], args["end"])
            pytest.fail(label)
