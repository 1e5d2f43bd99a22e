"""Top-p sampling of the port against the JAX package's.

* ``top_p_filter``'s nucleus equals the JAX package's on fixed logits:
  ties at the threshold (all kept), a small vocabulary (the JAX package
  sorts), and large ones whose nucleus lies inside the top 128, spills past
  128, or spills past 2048 (the JAX package's cascade levels).
* ``nucleus_sample``'s frequencies over a seeded batch of draws against the
  exact renormalised nucleus, by Pearson's chi-square: the torch and jax
  generators give other numbers, so distributions are compared. The bound
  is the statistic's mean plus 6 standard deviations, df + 6 sqrt(2 df),
  which a sound sampler exceeds with probability far below 1e-6; a draw
  outside the nucleus fails at once.
* The ``do_sample`` path of generate at tiny size: every sampled token
  lies in the nucleus of its step's logits, and a seed repeats its tokens.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2tokenizer_torch.config import GenerationConfig, U2ModelConfig
from u2tokenizer_torch.models import generate as t_generate
from u2tokenizer_torch.models.u2_model import U2CausalLM
from u2tokenizer_torch.ops import sampling as t_samp
from u2tokenizer_tpu.ops import sampling as j_samp

pytestmark = pytest.mark.fast


def _peaked(v, rows, seed, width):
    """Rows of logits whose nucleus at p=0.9 spans about ``width`` tokens."""
    rs = np.random.RandomState(seed)
    logits = rs.randn(rows, v).astype(np.float32) * 0.5
    for r in range(rows):
        logits[r, rs.choice(v, width, replace=False)] += 12.0
    return logits


def _ties(v=40):
    """Logits with runs of equal values, the threshold on one of them."""
    base = np.repeat(np.array([3.0, 2.0, 2.0, 2.0, 1.0], np.float32), v // 5)
    return np.stack([base, np.roll(base, 3),
                     np.linspace(2, -2, v).astype(np.float32).round(1)])


def _flat(v, rows, seed):
    return np.random.RandomState(seed).randn(rows, v).astype(np.float32) * 0.3


CASES = {
    "ties_small_vocab": (_ties(), 0.5),
    "small_vocab": (np.random.RandomState(1).randn(4, 50).astype(np.float32)
                    * 2, 0.9),
    "inside_top128": (_peaked(8192, 3, 2, 20), 0.9),
    "spills_past_128": (_peaked(8192, 3, 3, 600), 0.9),
    "spills_past_2048": (_flat(8192, 3, 4), 0.9),
    "tie_at_large_vocab": (np.repeat(np.array([[1.0, 0.0]], np.float32), 2048,
                                     axis=1), 0.9),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_top_p_filter_matches_jax(case):
    logits, top_p = CASES[case]
    ref = np.isfinite(np.asarray(j_samp.top_p_filter(jnp.asarray(logits),
                                                     top_p)))
    kept = torch.isfinite(t_samp.top_p_filter(torch.from_numpy(logits),
                                              top_p)).numpy()
    np.testing.assert_array_equal(kept, ref)
    if case.startswith(("spills", "inside")):
        sizes = kept.sum(-1)
        assert {"inside_top128": sizes.max() <= 128,
                "spills_past_128": 128 < sizes.min() <= 2048,
                "spills_past_2048": sizes.min() > 2048}[case], sizes
    if case == "ties_small_vocab":  # the threshold lies on a run of ties
        assert kept[0].sum() == 32 and kept[1].sum() == 32


def _exact_nucleus(logits, top_p):
    kept = np.isfinite(np.asarray(j_samp.top_p_filter(jnp.asarray(logits),
                                                      top_p)))[0]
    p = np.exp(logits[0].astype(np.float64) - logits[0].max())
    p = np.where(kept, p, 0.0)
    return p / p.sum()


def _chi_square(counts, probs):
    keep = probs > 0
    n = counts.sum()
    expected = n * probs[keep]
    stat = ((counts[keep] - expected) ** 2 / expected).sum()
    df = keep.sum() - 1
    return stat, df + 6 * np.sqrt(2 * df)


@pytest.mark.parametrize("v,top_p,temperature", [(4096, 0.9, 1.0),
                                                 (300, 0.8, 0.7)])
def test_nucleus_sample_frequencies(v, top_p, temperature):
    rows = 8192
    logits = _flat(v, 1, 5)
    logits[0, :12] = np.linspace(12.0, 10.0, 12)  # a graded nucleus
    probs = _exact_nucleus(logits / temperature, top_p)
    draws = t_samp.sample(torch.from_numpy(np.repeat(logits, rows, axis=0)),
                          do_sample=True, temperature=temperature,
                          top_p=top_p,
                          generator=torch.Generator().manual_seed(0)).numpy()
    assert (probs[draws] > 0).all(), "a draw outside the nucleus"
    stat, bound = _chi_square(np.bincount(draws, minlength=v), probs)
    assert stat <= bound, (stat, bound)


def test_generate_samples_inside_the_nucleus(monkeypatch):
    cfg = U2ModelConfig.tiny()
    model = U2CausalLM(cfg, dtype=torch.float32, device="cpu", seed=0)
    gen = GenerationConfig(max_new_tokens=6, do_sample=True, top_p=0.6,
                           eos_token_id=-2)
    steps = []

    def recorded(logits, **kw):
        tok = t_samp.sample(logits, **kw)
        steps.append((logits.clone(), tok.clone()))
        return tok

    monkeypatch.setattr(t_generate, "sample", recorded)
    rs = np.random.RandomState(0)
    d, h, w = cfg.vision.input_spatial
    args = (torch.from_numpy(rs.randint(0, 512, (2, 20))),
            torch.from_numpy(rs.randn(2, cfg.num_chunks, d, h, w)
                             .astype(np.float32)),
            torch.from_numpy(rs.randint(0, 512, (2, 5))),
            torch.tensor([20, 15], dtype=torch.int32))
    fn = t_generate.make_multimodal_generate_fn(model, gen, torch.float32)
    tokens = fn(*args, generator=torch.Generator().manual_seed(7))
    assert tokens.shape == (2, 6) and len(steps) == 6
    for logits, tok in steps:
        kept = np.isfinite(np.asarray(j_samp.top_p_filter(
            jnp.asarray(logits.numpy()), gen.top_p)))
        assert kept[np.arange(2), tok.numpy()].all()
    sizes = [torch.isfinite(t_samp.top_p_filter(lg, gen.top_p)).sum(-1)
             for lg, _ in steps]
    assert max(int(n.max()) for n in sizes) > 1, "every nucleus was 1 token"
    again = fn(*args, generator=torch.Generator().manual_seed(7))
    assert torch.equal(tokens, again)
    greedy = t_generate.make_multimodal_generate_fn(
        model, dataclasses.replace(gen, do_sample=False), torch.float32)
    with pytest.raises(ValueError, match="Generator"):
        fn(*args)  # a sampled decode needs a generator; greedy does not
    assert greedy(*args).shape == (2, 6)
