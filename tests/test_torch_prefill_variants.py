"""Per-row cache writes and the prefill variants of the port against the
JAX package's, on the CPU in fp32, on a tiny decoder whose JAX parameters
go into the port through ``load_flax_params``; inputs from numpy seeds.

* A block written per row (``write_index`` a (B,) tensor, each row at its
  own offset, S = 1 and S = 4) after a right-padded prefill: the block
  changes the port's cache at exactly the slots write_index[b] + [0, S)
  of row b; the fp32, int8 and packed int4 caches hold the JAX package's
  values (int4 unpacked), and the block's logits are within 1e-5 of the
  JAX ``CausalLM``'s with the same (B,) ``write_index``. The k/v
  projections are fp32 sums in another order, so the fp32 cache (values
  up to ~2) agrees within 1e-5, and a quantized value whose fp32 input lies within an ulp
  of a rounding boundary may round to the next level in one of the two:
  at most one element in a thousand may differ, by one level (a bf16
  scale by one ulp). One int4 level of one value moves the tiny model's
  logits by up to ~5e-3 (seen: a value of the int4 prefill), so where a
  value differs the logits are held within 1e-2, else within 1e-5.
* ``prefill_chunk`` and ``shared_prefix``: with a float cache the tokens
  equal the one-shot prefill's and the last prompt position's hidden
  states are within 1e-5 of it; with the int8 cache the tokens equal the
  JAX package's with the same option. ``decode_chunk`` gives the tokens
  of the unsplit decode, greedy and sampled from one seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from u2tokenizer_torch.config import GenerationConfig as TGen
from u2tokenizer_torch.config import LLMConfig as TLLM
from u2tokenizer_torch.models import generate as t_generate
from u2tokenizer_torch.models.llm.decoder import CausalLM as TLM
from u2tokenizer_torch.models.llm.decoder import KVCache as TCache
from u2tokenizer_torch.ops.attention import unpack_nibbles
from u2tokenizer_torch.weights import load_flax_params
from u2tokenizer_tpu.config import GenerationConfig as JGen
from u2tokenizer_tpu.config import LLMConfig as JLLM
from u2tokenizer_tpu.models import generate as j_generate
from u2tokenizer_tpu.models.llm.decoder import CausalLM as JLM
from u2tokenizer_tpu.models.llm.decoder import KVCache as JCache

pytestmark = pytest.mark.fast

t = torch.from_numpy
B, S = 4, 16
GREEDY = dict(max_new_tokens=8, do_sample=False, eos_token_id=-2,
              pad_token_id=0)


@pytest.fixture(scope="module")
def tiny():
    """Four rows in two groups of two sharing their first 6 tokens; prompt
    lengths 16, 12, 16, 9."""
    jcfg = JLLM.tiny()
    jm = JLM(jcfg, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 8, jcfg.hidden_size)),
                     jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 1, 8, 8), bool))
    flat = {k: np.array(v) for k, v in
            traverse_util.flatten_dict(params["params"], sep="/").items()}
    tm = TLM(TLLM(**dataclasses.asdict(jcfg)), dtype=torch.float32,
             device="cpu")
    load_flax_params(tm, flat)
    rs = np.random.RandomState(3)
    ids = rs.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    ids[1, :6], ids[3, :6] = ids[0, :6], ids[2, :6]
    plen = np.array([16, 12, 16, 9], np.int32)
    emb = np.array(jm.apply(params, jnp.asarray(ids), method="embed_tokens"))
    return jcfg, jm, params, tm, emb, plen


def _values(buf):
    """A cache buffer as numpy values: the port's packed int4 unpacked."""
    if isinstance(buf, torch.Tensor):
        return buf.float().numpy() if buf.dtype != torch.int8 else \
            buf.numpy()
    return np.asarray(buf.astype(jnp.float32)) if buf.dtype not in (
        jnp.int8, jnp.int4) else np.asarray(buf).astype(np.int8)


@pytest.mark.parametrize("s_block", [1, 4])
@pytest.mark.parametrize("cache", ["fp32", "int8", "int4"])
def test_per_row_write_matches_jax(tiny, cache, s_block):
    jcfg, jm, params, tm, emb, plen = tiny
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "int8": ("int8", "int8"), "int4": ("int4", "int4")}[cache]
    total = S + 8
    att = np.arange(S)[None, :] < plen[:, None]
    mask = att[:, None, None, :] & np.tril(np.ones((S, S), bool))[None, None]
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jc = JCache.create(jcfg, B, total, jdt)
    _, _, jc = jm.apply(params, jnp.asarray(emb), jnp.asarray(pos),
                        jnp.asarray(mask), jc, jnp.int32(0),
                        jnp.asarray(plen), compute_logits=False)
    tc = TCache.create(tm.cfg, B, total, tdt)
    with torch.no_grad():
        tm(t(emb), t(pos), t(mask), tc, 0, t(plen), compute_logits=False)

    # each row's block at its own slot: 16, 17, 19, 16
    widx = np.array([16, 17, 19, 16], np.int32)
    rs = np.random.RandomState(7)
    block = rs.randn(B, s_block, jcfg.hidden_size).astype(np.float32)
    bpos = (plen[:, None] + widx[:, None] - S
            + np.arange(s_block)[None, :]).astype(np.int32)
    kv = np.arange(total)
    last = widx[:, None, None] + np.arange(s_block)[None, :, None]
    key_ok = (kv[None, None, :] < plen[:, None, None]) | (
        (kv[None, None, :] >= S) & (kv[None, None, :] <= last))
    ref, _, jc = jm.apply(params, jnp.asarray(block), jnp.asarray(bpos),
                          jnp.asarray(key_ok[:, None]), jc,
                          jnp.asarray(widx), method="decode_step")
    before = [x.clone() for x in tc.k]
    with torch.no_grad():
        out, _, tc = tm.decode_step(t(block), t(bpos), t(key_ok[:, None]), tc,
                                    t(widx))
    written = np.zeros((B, total), bool)
    written[np.arange(B)[:, None], last[:, :, 0]] = True
    for old, new in zip(before, tc.k):
        changed = (old != new).any(-1).any(1)  # (B, Hkv, L, D) -> (B, L)
        np.testing.assert_array_equal(changed.numpy(), written)

    flips = 0
    for i in range(jcfg.num_layers):
        bufs = [(tc.k[i], jc.k[i]), (tc.v[i], jc.v[i])]
        if cache != "fp32":
            bufs += [(tc.k_scale[i], jc.k_scale[i]),
                     (tc.v_scale[i], jc.v_scale[i])]
        for tb, jb in bufs:
            if cache == "int4" and tb.dim() == 4:
                tb = unpack_nibbles(tb)
            ours, theirs = _values(tb), _values(jb)
            if cache == "fp32":
                np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
            elif tb.dtype != torch.int8:  # bf16 scales: one ulp
                np.testing.assert_allclose(ours, theirs, rtol=2 ** -7, atol=0)
            else:
                diff = np.abs(ours.astype(np.int32) - theirs)
                assert diff.max() <= 1 and diff.sum() <= diff.size // 1000
                flips += int(diff.sum())
    atol = 1e-2 if flips else 1e-5
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=atol)


def _tokens(tm, emb, plen, cache=torch.float32, **kw):
    fn = t_generate.make_generate_fn(tm, TGen(**GREEDY), cache, **kw)
    cache_, tok0, done0, last = fn.prefill_stage(t(emb), t(plen))
    return fn(t(emb), t(plen)).numpy(), last.numpy()


@pytest.mark.parametrize("option", [dict(prefill_chunk=4),
                                    dict(shared_prefix=(2, 6))],
                         ids=["prefill_chunk", "shared_prefix"])
def test_prefill_variant_equals_one_shot(tiny, option):
    _, _, _, tm, emb, plen = tiny
    ref, ref_last = _tokens(tm, emb, plen)
    out, last = _tokens(tm, emb, plen, **option)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_allclose(last, ref_last, rtol=0, atol=1e-5)


@pytest.mark.parametrize("option", [dict(prefill_chunk=4),
                                    dict(shared_prefix=(2, 6))],
                         ids=["prefill_chunk", "shared_prefix"])
def test_prefill_variant_int8_matches_jax(tiny, option):
    _, jm, params, tm, emb, plen = tiny
    ref = j_generate.make_generate_fn(jm, JGen(**GREEDY), "int8", **option)(
        params, jnp.asarray(emb), jnp.asarray(plen), jax.random.PRNGKey(0))
    out, _ = _tokens(tm, emb, plen, "int8", **option)
    np.testing.assert_array_equal(out, np.asarray(ref))


@pytest.mark.parametrize("do_sample", [False, True])
def test_decode_chunk_gives_the_same_tokens(tiny, do_sample):
    _, _, _, tm, emb, plen = tiny
    gen = TGen(**dict(GREEDY, do_sample=do_sample, top_p=0.9))
    outs = [t_generate.make_generate_fn(tm, gen, torch.float32,
                                        decode_chunk=chunk)(
        t(emb), t(plen), torch.Generator().manual_seed(4)).numpy()
        for chunk in (None, 3, 1)]
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[2], outs[0])
