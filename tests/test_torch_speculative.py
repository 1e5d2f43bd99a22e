"""Speculative decoding of the port against the JAX package's, on the CPU
in fp32, on a tiny decoder whose JAX parameters go into the port through
``load_flax_params``; inputs from numpy seeds.

* ``ngram_draft`` equals the JAX package's id for id: bigram and trigram
  (``c00``) matches, no match, a self match, unwritten continuations.
* Greedy speculative tokens equal the port's plain greedy and the JAX
  package's speculative greedy, for fp32, int8 and int4 caches and block
  lengths 2, 4 and 8, with the JAX package's verify-step count; EOS stops
  a row and pads it after.
* Forced content emits the script, with the JAX package's verify-step
  count, which equals the host replay ``forced_content_replay`` (the
  largest row's), on prompts with and without padding; the port's
  ``ngram_acceptance_estimate`` equals the JAX package's.
* The speculative sampling ops against the JAX package's on the same
  logits within 1e-6: ``nucleus_membership_bounds``, ``nucleus_p_draft``
  and the p_draft of ``nucleus_accept_residual``, at every level of the
  k-space cascade; the residual draw lies in the nucleus without the
  draft.
* Sampled speculative decoding against plain sampling on a 12-token
  vocabulary: the torch generator's draws are taken in another order, so
  trajectories differ and each position's token frequencies over 4,000
  rows are compared by Pearson's two-sample chi-square (homogeneity),
  held under df + 6 sqrt(2 df), which two samples of one distribution
  exceed with probability far below 1e-6.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from u2tokenizer_torch.config import GenerationConfig as TGen
from u2tokenizer_torch.config import LLMConfig as TLLM
from u2tokenizer_torch.data import synthetic_reports as t_reports
from u2tokenizer_torch.models import generate as t_generate
from u2tokenizer_torch.models import speculative as t_spec
from u2tokenizer_torch.models.llm.decoder import CausalLM as TLM
from u2tokenizer_torch.ops import sampling as t_samp
from u2tokenizer_torch.weights import load_flax_params
from u2tokenizer_tpu.config import GenerationConfig as JGen
from u2tokenizer_tpu.config import LLMConfig as JLLM
from u2tokenizer_tpu.data import synthetic_reports as j_reports
from u2tokenizer_tpu.models import speculative as j_spec
from u2tokenizer_tpu.models.llm.decoder import CausalLM as JLM
from u2tokenizer_tpu.ops import sampling as j_samp

pytestmark = pytest.mark.fast

S = 24
GREEDY = dict(max_new_tokens=16, do_sample=False, eos_token_id=-2,
              pad_token_id=0)
t = torch.from_numpy


def lm_pair(vocab=512, seed=0):
    """The JAX tiny decoder, its parameters, and the port's on them."""
    jcfg = JLLM.tiny(vocab_size=vocab)
    jm = JLM(jcfg, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 8, jcfg.hidden_size)),
                     jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 1, 8, 8), bool))
    flat = {k: np.array(v) for k, v in
            traverse_util.flatten_dict(params["params"], sep="/").items()}
    tm = TLM(TLLM(**dataclasses.asdict(jcfg)), dtype=torch.float32,
             device="cpu")
    load_flax_params(tm, flat)
    return jm, params, tm


@pytest.fixture(scope="module")
def tiny():
    """Row 0 a periodic prompt (drafts accepted), row 1 random, 5 pads."""
    jm, params, tm = lm_pair()
    rs = np.random.RandomState(1)
    ids = np.stack([np.tile([7, 11, 13, 17], S // 4),
                    rs.randint(0, 512, S)]).astype(np.int32)
    plen = np.array([S, S - 5], np.int32)
    att = np.arange(S)[None, :] < plen[:, None]
    emb = np.array(jm.apply(params, jnp.asarray(ids * att),
                            method="embed_tokens"))
    return jm, params, tm, ids, plen, emb


def _cache(name):
    return {"fp32": (jnp.float32, torch.float32), "int8": ("int8", "int8"),
            "int4": ("int4", "int4")}[name]


# --- ngram_draft ---

def _histories():
    rs = np.random.RandomState(5)
    hist = rs.randint(0, 6, (6, 40)).astype(np.int32)  # small alphabet
    hist[:, 30:] = -1
    hist[2, 20:30] = -1                 # a row with unwritten history
    hist[3] = np.r_[np.arange(20), [50, 51], -np.ones(18)]  # self match only
    hist[4, :29] = 9                    # no (c0, c1) match
    idx_last = np.array([29, 29, 19, 21, 29, 25], np.int32)
    c0 = hist[np.arange(6), idx_last - 1]
    c1 = hist[np.arange(6), idx_last]
    c1[4] = 8
    c00 = hist[np.arange(6), idx_last - 2]
    c00[5] = -1
    return hist, idx_last, c0, c1, c00


@pytest.mark.parametrize("trigram", [False, True])
@pytest.mark.parametrize("n_drafts", [1, 3, 7])
def test_ngram_draft_matches_jax(trigram, n_drafts):
    hist, idx_last, c0, c1, c00 = _histories()
    ref = j_spec.ngram_draft(jnp.asarray(hist), jnp.asarray(idx_last),
                             jnp.asarray(c0), jnp.asarray(c1), n_drafts,
                             c00=jnp.asarray(c00) if trigram else None)
    out = t_spec.ngram_draft(t(hist).long(), t(idx_last), t(c0).long(),
                             t(c1).long(), n_drafts,
                             c00=t(c00).long() if trigram else None)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (out[3] == 51).all() and (out[4] == 8).all()  # fallback to c1


# --- greedy ---

@pytest.fixture(scope="module")
def plain_greedy(tiny):
    jm, params, tm, ids, plen, emb = tiny
    return {name: t_generate.make_generate_fn(tm, TGen(**GREEDY),
                                              _cache(name)[1])(
        t(emb), t(plen)).numpy() for name in ("fp32", "int8", "int4")}


@pytest.mark.parametrize("block_len", [2, 4, 8])
@pytest.mark.parametrize("cache", ["fp32", "int8", "int4"])
def test_spec_greedy_matches_jax(tiny, plain_greedy, cache, block_len):
    jm, params, tm, ids, plen, emb = tiny
    jdt, tdt = _cache(cache)
    ref, ref_steps = j_spec.make_spec_generate_fn(
        jm, JGen(**GREEDY), jdt, block_len=block_len, return_stats=True)(
        params, jnp.asarray(emb), jnp.asarray(ids), jnp.asarray(plen),
        jax.random.PRNGKey(3))
    out, steps = t_spec.make_spec_generate_fn(
        tm, TGen(**GREEDY), tdt, block_len=block_len, return_stats=True)(
        t(emb), t(ids), t(plen))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out.numpy(), plain_greedy[cache])
    assert steps == int(ref_steps)


def test_spec_eos_stops_and_pads(tiny, plain_greedy):
    """An EOS the plain loop emits mid-stream: the speculative tokens are
    the plain loop's and the JAX package's, pads after the EOS."""
    jm, params, tm, ids, plen, emb = tiny
    eos = int(plain_greedy["fp32"][0, 4])
    kw = dict(GREEDY, eos_token_id=eos, pad_token_id=3)
    plain = t_generate.make_generate_fn(tm, TGen(**kw), torch.float32)(
        t(emb), t(plen)).numpy()
    out = t_spec.make_spec_generate_fn(tm, TGen(**kw), torch.float32,
                                       block_len=4)(t(emb), t(ids), t(plen))
    ref = j_spec.make_spec_generate_fn(jm, JGen(**kw), jnp.float32,
                                       block_len=4)(
        params, jnp.asarray(emb), jnp.asarray(ids), jnp.asarray(plen),
        jax.random.PRNGKey(3))
    np.testing.assert_array_equal(out.numpy(), plain)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    first = int(np.argmax(plain[0] == eos))
    assert first <= 4 and (plain[0, first + 1:] == 3).all()


# --- forced content ---

@pytest.mark.parametrize("padded", [False, True])
def test_forced_content_matches_jax_and_replay(tiny, padded):
    jm, params, tm, ids, plen, emb = tiny
    max_new, kb = 96, 8
    b = 2
    script = t_reports.report_token_scripts(b, max_new + kb, 512, seed=1)
    plen_case = plen if padded else np.full(b, S, np.int32)
    kw = dict(GREEDY, max_new_tokens=max_new)
    ref, ref_steps = j_spec.make_spec_generate_fn(
        jm, JGen(**kw), jnp.float32, block_len=kb, return_stats=True,
        forced_content=True)(params, jnp.asarray(emb), jnp.asarray(ids),
                             jnp.asarray(plen_case), jax.random.PRNGKey(0),
                             jnp.asarray(script))
    out, steps = t_spec.make_spec_generate_fn(
        tm, TGen(**kw), torch.float32, block_len=kb, return_stats=True,
        forced_content=True)(t(emb), t(ids), t(plen_case), script=t(script))
    np.testing.assert_array_equal(out.numpy(), script[:, :max_new])
    np.testing.assert_array_equal(np.asarray(ref), script[:, :max_new])
    replay = t_reports.forced_content_replay(script[:, :max_new], ids,
                                             plen_case, kb)
    assert steps == int(ref_steps) == replay.max()
    assert steps < max_new - 1  # the scripts' repeats were drafted


def test_acceptance_estimate_matches_jax():
    script = j_reports.report_token_scripts(3, 160, 5000, seed=4)
    np.testing.assert_array_equal(
        t_reports.report_token_scripts(3, 160, 5000, seed=4), script)
    prompt = np.random.RandomState(2).randint(16, 5000, (3, 10))
    for kw in (dict(block_len=8), dict(block_len=4, prompt=prompt)):
        assert (t_reports.ngram_acceptance_estimate(script, **kw)
                == j_reports.ngram_acceptance_estimate(script, **kw))


# --- the sampling ops ---

def _peaked(v, rows, seed, width):
    rs = np.random.RandomState(seed)
    logits = rs.randn(rows, v).astype(np.float32) * 0.5
    for r in range(rows):
        logits[r, rs.choice(v, width, replace=False)] += 12.0
    return logits


OP_CASES = {
    "small_vocab": np.random.RandomState(1).randn(5, 100).astype(np.float32),
    "inside_top128": _peaked(8192, 5, 2, 20),
    "spills_past_128": _peaked(8192, 5, 3, 600),
    "spills_past_2048": np.random.RandomState(4).randn(5, 8192).astype(
        np.float32) * 0.3,
    "mixed_levels": np.concatenate([_peaked(8192, 2, 5, 20),
                                    _peaked(8192, 2, 6, 600)]),
}


def _drafts(logits):
    """A draft a row: the top token, a kept one, one outside, none."""
    order = np.argsort(-logits, axis=1)
    return np.array([[o[0], o[3], o[-1], -1][r % 4]
                     for r, o in enumerate(order)], np.int32)


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_sampling_ops_match_jax(case):
    logits = OP_CASES[case]
    draft = _drafts(logits)
    top_p = 0.9
    jl, jd = jnp.asarray(logits), jnp.asarray(draft)
    member, lo, hi = j_samp.nucleus_membership_bounds(jl, jd, top_p)
    t_member, t_lo, t_hi = t_samp.nucleus_membership_bounds(
        t(logits), t(draft).long(), top_p)
    np.testing.assert_array_equal(t_member.numpy(), np.asarray(member))
    np.testing.assert_allclose(t_lo.numpy(), np.asarray(lo), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(t_hi.numpy(), np.asarray(hi), rtol=0,
                               atol=1e-6)
    p = j_samp.nucleus_p_draft(jl, jd, top_p)
    t_p = t_samp.nucleus_p_draft(t(logits), t(draft).long(), top_p)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(p), rtol=0, atol=1e-6)
    assert (t_lo <= t_p + 1e-7).all() and (t_p <= t_hi + 1e-7).all()
    p_res, _ = j_samp.nucleus_accept_residual(jax.random.PRNGKey(0), jl, jd,
                                              top_p)
    gen = torch.Generator().manual_seed(0)
    t_pres, fresh = t_samp.nucleus_accept_residual(t(logits),
                                                   t(draft).long(), top_p,
                                                   gen)
    np.testing.assert_allclose(t_pres.numpy(), np.asarray(p_res), rtol=0,
                               atol=1e-6)
    kept = torch.isfinite(t_samp.top_p_filter(t(logits), top_p))
    rows = torch.arange(len(logits))
    assert kept[rows, fresh].all()
    only = kept.sum(-1) == 1  # a draft that is the whole nucleus keeps it
    assert ((fresh != t(draft).long()) | only).all()


# --- sampled speculative decoding: distribution ---

def _homogeneity(a, b):
    """Pearson's two-sample chi-square over the categories either sample
    hit, its df and the bound df + 6 sqrt(2 df)."""
    keep = (a + b) > 0
    a, b = a[keep].astype(np.float64), b[keep].astype(np.float64)
    n_a, n_b = a.sum(), b.sum()
    tot = a + b
    e_a, e_b = tot * n_a / (n_a + n_b), tot * n_b / (n_a + n_b)
    stat = float((((a - e_a) ** 2) / e_a + ((b - e_b) ** 2) / e_b).sum())
    df = int(keep.sum()) - 1
    return stat, df, df + 6 * math.sqrt(2 * df)


def test_spec_sampling_distribution_matches_plain():
    jm, params, tm = lm_pair(vocab=12)
    rows, s, max_new = 4000, 8, 4
    ids = np.random.RandomState(1).randint(0, 12, (1, s))
    emb = tm.embed_tokens(t(ids)).detach().expand(rows, -1, -1)
    plen = torch.full((rows,), s, dtype=torch.int32)
    gen = TGen(max_new_tokens=max_new, do_sample=True, temperature=1.3,
               top_p=0.8, eos_token_id=-2, pad_token_id=0)
    plain = t_generate.make_generate_fn(tm, gen, torch.float32)(
        emb, plen, torch.Generator().manual_seed(1)).numpy()
    spec, steps = t_spec.make_spec_generate_fn(
        tm, gen, torch.float32, block_len=3, return_stats=True)(
        emb, t(ids).expand(rows, -1), plen, torch.Generator().manual_seed(2))
    spec = spec.numpy()
    for pos in range(max_new):
        counts = [np.bincount(x[:, pos], minlength=12) for x in (plain, spec)]
        stat, df, bound = _homogeneity(*counts)
        assert df >= 2 and stat <= bound, (pos, stat, bound, counts)


def test_spec_sampling_pads_after_eos(tiny):
    """A sampled EOS stops its row: pads after it."""
    jm, params, tm, ids, plen, emb = tiny
    kw = dict(max_new_tokens=10, do_sample=True, top_p=0.9, pad_token_id=-3)
    args = (t(emb[:1]), t(ids[:1]), t(plen[:1]))
    probe = t_spec.make_spec_generate_fn(
        tm, TGen(eos_token_id=-2, **kw), torch.float32, block_len=4)(
        *args, torch.Generator().manual_seed(5))[0].numpy()
    eos = int(probe[2])
    first = int(np.argmax(probe == eos))
    toks = t_spec.make_spec_generate_fn(
        tm, TGen(eos_token_id=eos, **kw), torch.float32, block_len=4)(
        *args, torch.Generator().manual_seed(5))[0].numpy()
    np.testing.assert_array_equal(toks[:first + 1], probe[:first + 1])
    assert (toks[first + 1:] == -3).all(), toks
