"""Fan-out decoding of the port against the JAX package's, on the CPU in
fp32: n sample rows a case decode against the case's prompt cache, shared
and read once a case, plus a per-row suffix cache.

* ``gqa_sdpa_fanout`` within 1e-5 of the JAX package's on the same
  seeded inputs, with float, int8 and packed int4 caches (scales folded
  in), and equal to attending the concatenated [prefix ; suffix] cache.
* ``make_fanout_generate_fn`` greedy tokens equal the JAX package's and
  the plain loop's on the prompt tiled n times (fp32 and int8 caches); the
  speculative ``fanout=`` and ``fanout_split=`` modes give the JAX
  package's greedy tokens and verify-step counts.
* The multimodal entry points on a tiny μ² model: fan-out tokens equal the
  tiled plain ones, and the prompt prefill runs at the case batch.
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
from u2tokenizer_torch.config import U2ModelConfig as TCfg
from u2tokenizer_torch.models import generate as t_generate
from u2tokenizer_torch.models import speculative as t_spec
from u2tokenizer_torch.models.llm.decoder import CausalLM as TLM
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.ops import attention as t_attn
from u2tokenizer_torch.ops import flash_attention as t_fa
from u2tokenizer_torch.weights import load_flax_params
from u2tokenizer_tpu.config import GenerationConfig as JGen
from u2tokenizer_tpu.config import LLMConfig as JLLM
from u2tokenizer_tpu.models import generate as j_generate
from u2tokenizer_tpu.models import speculative as j_spec
from u2tokenizer_tpu.models.llm.decoder import CausalLM as JLM
from u2tokenizer_tpu.ops import attention as j_attn

pytestmark = pytest.mark.fast

t = torch.from_numpy
C, N, S = 2, 3, 16
GREEDY = dict(max_new_tokens=10, do_sample=False, eos_token_id=-2,
              pad_token_id=0)
CACHES = {"fp32": (jnp.float32, torch.float32), "int8": ("int8", "int8"),
          "int4": ("int4", "int4")}


def _quantized(x, kind):
    """(B, S, H, D) values -> the JAX package's head-major quantized cache
    and scales, and the port's (int4 packed)."""
    q, sc = j_attn.quantize_kv(jnp.asarray(x),
                               dtype=jnp.int4 if kind == "int4" else jnp.int8)
    jq = jnp.transpose(q, (0, 2, 1, 3))
    js = jnp.transpose(sc[..., 0], (0, 2, 1))
    tq = t(np.asarray(jq).astype(np.int8))
    if kind == "int4":
        tq = t_attn.pack_nibbles(tq)
    return jq, js, tq, t(np.asarray(js.astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize("cache", ["fp32", "int8", "int4"])
def test_gqa_sdpa_fanout_matches_jax(cache):
    rs = np.random.RandomState(0)
    c, n, sq, h, hkv, d, sp, st = 2, 3, 4, 4, 2, 16, 10, 7
    b = c * n
    q = rs.randn(b, sq, h, d).astype(np.float32)
    pre = rs.randn(2, c, sp, hkv, d).astype(np.float32)
    suf = rs.randn(2, b, st, hkv, d).astype(np.float32)
    pmask = np.arange(sp)[None, :] < np.array([[10], [6]])
    smask = (np.arange(st)[None, None, None, :]
             <= rs.randint(0, st, (b, 1, sq, 1)))
    kw = dict(prefix_mask=pmask, suffix_mask=smask)
    hm = lambda x: np.ascontiguousarray(x.transpose(0, 2, 1, 3))
    if cache == "fp32":
        jargs = [jnp.asarray(hm(x)) for x in (*pre, *suf)]
        targs = [t(hm(x)) for x in (*pre, *suf)]
        jsc = tsc = {}
    else:
        qs = [_quantized(x, cache) for x in (*pre, *suf)]
        jargs, targs = [x[0] for x in qs], [x[2] for x in qs]
        names = ("pk_scale", "pv_scale", "sk_scale", "sv_scale")
        jsc = dict(zip(names, (x[1] for x in qs)))
        tsc = dict(zip(names, (x[3] for x in qs)))
    ref = j_attn.gqa_sdpa_fanout(
        jnp.asarray(q), *jargs, **jsc,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    out = t_attn.gqa_sdpa_fanout(t(q), *targs, **tsc,
                                 **{k: t(v) for k, v in kw.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    if cache == "fp32":  # the same as the concatenated cache, tiled
        rep = lambda x: x.repeat_interleave(n, 0)
        k = torch.cat([rep(targs[0]), targs[2]], dim=2)
        v = torch.cat([rep(targs[1]), targs[3]], dim=2)
        m = torch.cat([rep(t(pmask))[:, None, None, :].expand(b, 1, sq, sp),
                       t(smask).expand(b, 1, sq, st)], dim=-1)
        cat = t_attn.gqa_sdpa_headmajor(t(q), k, v, mask=m)
        torch.testing.assert_close(out, cat, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    """Two cases; in the per-row layout rows c*3 + j share their first 6
    tokens. Prompt lengths 16 and 11 a case."""
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
    rs = np.random.RandomState(2)
    ids = rs.randint(0, jcfg.vocab_size, (C, S)).astype(np.int32)
    ids[0, 8:] = ids[0, :8]  # a repeat for the drafter
    plen = np.array([16, 11], np.int32)
    att = np.arange(S)[None, :] < plen[:, None]
    emb = np.array(jm.apply(params, jnp.asarray(ids * att),
                            method="embed_tokens"))
    return jm, params, tm, ids, plen, emb


@pytest.mark.parametrize("cache", ["fp32", "int8"])
def test_fanout_matches_jax_and_tiled(tiny, cache):
    jm, params, tm, ids, plen, emb = tiny
    jdt, tdt = CACHES[cache]
    ref = j_generate.make_fanout_generate_fn(jm, JGen(**GREEDY), N, jdt)(
        params, jnp.asarray(emb), jnp.asarray(plen), jax.random.PRNGKey(0))
    out = t_generate.make_fanout_generate_fn(tm, TGen(**GREEDY), N, tdt)(
        t(emb), t(plen))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    tiled = t_generate.make_generate_fn(tm, TGen(**GREEDY), tdt)(
        t(emb).repeat_interleave(N, 0), t(plen).repeat_interleave(N, 0))
    torch.testing.assert_close(out, tiled, rtol=0, atol=0)


@pytest.mark.parametrize("cache", ["fp32", "int8", "int4"])
def test_spec_fanout_matches_jax(tiny, cache):
    jm, params, tm, ids, plen, emb = tiny
    jdt, tdt = CACHES[cache]
    ref, ref_steps = j_spec.make_spec_generate_fn(
        jm, JGen(**GREEDY), jdt, block_len=4, return_stats=True, fanout=N)(
        params, jnp.asarray(emb), jnp.asarray(ids), jnp.asarray(plen),
        jax.random.PRNGKey(0))
    out, steps = t_spec.make_spec_generate_fn(
        tm, TGen(**GREEDY), tdt, block_len=4, return_stats=True, fanout=N)(
        t(emb), t(ids), t(plen))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert steps == int(ref_steps)
    if cache == "fp32":
        plain = t_generate.make_fanout_generate_fn(tm, TGen(**GREEDY), N)(
            t(emb), t(plen))
        torch.testing.assert_close(out, plain, rtol=0, atol=0)


@pytest.mark.parametrize("cache", ["fp32", "int8"])
def test_spec_fanout_split_matches_jax(tiny, cache):
    """Rows c*3 + j share 6 tokens; tails 10 and 5 (chunked as one)."""
    jm, params, tm, ids, plen, emb = tiny
    jdt, tdt = CACHES[cache]
    rs = np.random.RandomState(4)
    rows = np.repeat(ids, N, 0)
    rows[:, 6:] = rs.randint(0, 512, (C * N, S - 6))
    prow = np.array([16, 14, 12, 11, 9, 7], np.int32)
    att = np.arange(S)[None, :] < prow[:, None]
    emb_rows = np.array(jm.apply(params, jnp.asarray(rows * att),
                                 method="embed_tokens"))
    ref, ref_steps = j_spec.make_spec_generate_fn(
        jm, JGen(**GREEDY), jdt, block_len=4, return_stats=True,
        fanout_split=(N, 6))(params, jnp.asarray(emb_rows),
                             jnp.asarray(rows), jnp.asarray(prow),
                             jax.random.PRNGKey(0))
    out, steps = t_spec.make_spec_generate_fn(
        tm, TGen(**GREEDY), tdt, block_len=4, return_stats=True,
        fanout_split=(N, 6))(t(emb_rows), t(rows), t(prow))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert steps == int(ref_steps)
    if cache == "fp32":
        plain = t_generate.make_generate_fn(tm, TGen(**GREEDY))(
            t(emb_rows), t(prow))
        torch.testing.assert_close(out, plain.to(out.dtype), rtol=0, atol=0)


def test_fanout_multimodal_prefills_once_a_case(monkeypatch):
    """Tiny μ² model: the fan-out entry points give the tiled plain
    tokens, and their prompt prefill attends at the case batch."""
    cfg = TCfg.tiny()
    model = TModel(cfg, dtype=torch.float32, device="cpu", seed=0)
    g = torch.Generator().manual_seed(0)
    d, h, w = cfg.vision.input_spatial
    images = torch.randn(1, cfg.num_chunks, d, h, w, generator=g)
    ids = torch.randint(0, cfg.llm.vocab_size, (1, 20), generator=g)
    qids = torch.randint(0, cfg.llm.vocab_size, (1, 6), generator=g)
    plen = torch.tensor([17], dtype=torch.int32)
    gen = TGen(**GREEDY)
    batches = []
    reference = t_fa.flash_attention_reference

    def spy(q, *args, **kw):
        if kw.get("causal"):
            batches.append(q.shape[0])
        return reference(q, *args, **kw)

    monkeypatch.setattr(t_fa, "flash_attention_reference", spy)
    fan = t_generate.make_fanout_multimodal_generate_fn(model, gen, 4)(
        ids, images, qids, plen)
    spec = t_spec.make_spec_multimodal_generate_fn(model, gen, torch.float32,
                                                   fanout=4)(
        ids, images, qids, plen)
    assert batches == [1] * (2 * cfg.llm.num_layers)
    rep = lambda x: x.repeat_interleave(4, 0)
    plain = t_generate.make_multimodal_generate_fn(model, gen, torch.float32)(
        rep(ids), rep(images), rep(qids), rep(plen))
    torch.testing.assert_close(fan, plain, rtol=0, atol=0)
    torch.testing.assert_close(spec, plain, rtol=0, atol=0)
