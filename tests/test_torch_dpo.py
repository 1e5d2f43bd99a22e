"""The port's DPO (``u2tokenizer_torch/train/dpo.py``) against the JAX
package's, in fp32 on the CPU.

One configuration: ``U2ModelConfig.tiny()`` cut to one layer per stack.
Its parameters are drawn by the JAX package (``model.init``) and carried
into the port by ``weights.load_flax_params``; the preference samples
(volumes and question ids from a numpy seed) and the tokenizer are the
same for both. Compared: the collators and the segment mask bit for bit;
the completion log-probs (plain, chunked, packed), the WPO weights and the
chosen NLL within 1e-5 relative (fp32 sums through one ViT, one
μ²tokenizer and one decoder layer in another order, as
``tests/test_torch_train.py`` holds its losses to 1e-4); the loss variants
within 1e-6 on given log-probs; and two train steps with AdamW.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2tokenizer_torch.config import DPOConfig as TDPO
from u2tokenizer_torch.config import TrainConfig as TTrain
from u2tokenizer_torch.config import U2ModelConfig as TCfg
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.train import dpo as t_dpo
from u2tokenizer_torch.train import sft as t_sft
from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer
from u2tokenizer_torch.weights import flatten, flax_params, load_flax_params
from u2tokenizer_tpu.config import DPOConfig as JDPO
from u2tokenizer_tpu.config import TrainConfig as JTrain
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.models.u2_model import U2CausalLM as JModel
from u2tokenizer_tpu.train import dpo as j_dpo
from u2tokenizer_tpu.train import sft as j_sft

pytestmark = pytest.mark.fast

PROMPT, COMPLETION = 16, 8
RTOL = 1e-5


def _cfg(cls):
    base = cls.tiny()
    return dataclasses.replace(
        base, vision=dataclasses.replace(base.vision, num_layers=1),
        u2t=dataclasses.replace(base.u2t, num_layers=1),
        llm=dataclasses.replace(base.llm, num_layers=1))


def _samples(n=2):
    cfg = _cfg(JCfg)
    d, h, w = cfg.vision.input_spatial
    rs = np.random.RandomState(0)
    texts = [("clear lungs no pleural effusion seen", "bad"),
             ("small nodule right upper lobe", "normal study no nodule at all "
              "whatsoever in this chest study of the patient")]
    return [{
        "prompt": (f"<user> {'<im_patch>' * cfg.proj_out_num}describe case "
                   f"{i} <assistant>"),
        "chosen": texts[i % 2][0], "rejected": texts[i % 2][1],
        "image": rs.randn(cfg.num_chunks, d, h, w).astype(np.float32),
        "prompt_question_ids": rs.randint(3, 60, 6).astype(np.int32),
    } for i in range(n)]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def models():
    samples = _samples()
    tok = MockTokenizer()
    jb = j_dpo.collate_preference_batch(samples, tok, PROMPT, COMPLETION)
    jm = JModel(_cfg(JCfg), dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.asarray(jb["input_ids"][:1]),
                              jnp.asarray(jb["images"][:1]),
                              jnp.asarray(jb["question_ids"][:1]))
    tm = TModel(_cfg(TCfg), dtype=torch.float32, device="cpu", remat=True)
    load_flax_params(tm, flatten(jax.device_get(params)))
    return jm, params, tm, samples, tok


def _batches(samples, tok, packed=False):
    name = ("collate_packed_preference_batch" if packed
            else "collate_preference_batch")
    jb = getattr(j_dpo, name)(samples, tok, PROMPT, COMPLETION)
    tb = getattr(t_dpo, name)(samples, tok, PROMPT, COMPLETION)
    return {k: jnp.asarray(v) for k, v in jb.items()}, tb


@pytest.mark.parametrize("packed", [False, True])
def test_collation_matches_jax(packed):
    """Every array of both layouts, bit for bit; images given as paths go
    through the transform."""
    samples = _samples(3)
    tok = MockTokenizer()
    name = ("collate_packed_preference_batch" if packed
            else "collate_preference_batch")
    jb = getattr(j_dpo, name)(samples, tok, PROMPT, COMPLETION)
    tb = getattr(t_dpo, name)(samples, tok, PROMPT, COMPLETION)
    assert set(tb) == set(jb)
    for key in jb:
        np.testing.assert_array_equal(_np(tb[key]), jb[key], err_msg=key)
    paths = [dict(s, image=f"case{i}") for i, s in enumerate(samples)]
    volumes = {f"case{i}": s["image"] for i, s in enumerate(samples)}
    tp = getattr(t_dpo, name)(paths, tok, PROMPT, COMPLETION,
                              lambda p: torch.from_numpy(volumes[p]))
    np.testing.assert_array_equal(_np(tp["images"]), jb["images"])
    with pytest.raises(ValueError, match="no transform"):
        getattr(t_dpo, name)(paths, tok, PROMPT, COMPLETION)
    assert getattr(t_dpo, name)([None], tok, PROMPT, COMPLETION) is None


def test_packed_segment_mask_matches_jax():
    rs = np.random.RandomState(4)
    seg = rs.randint(0, 4, (3, 17)).astype(np.int32)
    ref = j_dpo.packed_segment_mask(jnp.asarray(seg))
    out = t_dpo.packed_segment_mask(torch.from_numpy(seg))
    assert out.dtype == torch.bool and tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _assert_close(out, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(_np(out.detach()), np.asarray(ref),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("average", [False, True])
@pytest.mark.parametrize("ce_chunk", [0, 3, 8])
def test_completion_logps_match_jax(models, average, ce_chunk):
    """Summed or averaged completion log-probs, WPO weights and chosen
    NLL, plain and chunked (3 does not divide S - 1 = 23, 8 leaves a
    short last chunk), within 1e-5 relative of the JAX package's plain
    form."""
    jm, params, tm, samples, tok = models
    jb, tb = _batches(samples, tok)
    ref, w_ref, nll_ref = jax.jit(lambda p, b: j_dpo._completion_logps(
        jm, p, b, average, aux=True))(params, jb)
    with torch.no_grad():
        out, w, nll = t_dpo._completion_logps(tm, tb, average, aux=True,
                                              ce_chunk=ce_chunk)
        plain = t_dpo._completion_logps(tm, tb, average, ce_chunk=ce_chunk)
    _assert_close(out, ref)
    _assert_close(plain, ref)
    _assert_close(w, w_ref)
    _assert_close(nll, nll_ref)


@pytest.mark.parametrize("average", [False, True])
def test_packed_completion_logps_match_jax_and_concatenated(models, average):
    """The packed forward against the JAX package's packed forward
    (1e-5), and against the port's concatenated forward (2e-5, as
    tests/test_dpo.py:96 holds the JAX package's two layouts)."""
    jm, params, tm, samples, tok = models
    jp, tp = _batches(samples, tok, packed=True)
    _, tb = _batches(samples, tok)
    ref, w_ref, nll_ref = jax.jit(lambda p, b: j_dpo._packed_completion_logps(
        jm, p, b, average, aux=True))(params, jp)
    with torch.no_grad():
        out, w, nll = t_dpo._packed_completion_logps(tm, tp, average,
                                                     aux=True)
        cat, w_cat, nll_cat = t_dpo._completion_logps(tm, tb, average,
                                                      aux=True)
    _assert_close(out, ref)
    _assert_close(w, w_ref)
    _assert_close(nll, nll_ref)
    for a, b in ((out, cat), (w, w_cat), (nll, nll_cat)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-5, atol=2e-5)


LOSS_CASES = {
    "sigmoid": dict(),
    "label_smoothing": dict(label_smoothing=0.1),
    "ipo": dict(loss_type="ipo"),
    "wpo": dict(use_weighting=True),
    "rpo": dict(rpo_alpha=0.5),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_dpo_loss_matches_jax(case):
    rs = np.random.RandomState(5)
    pc, pr, rc, rr = (rs.randn(4).astype(np.float32) * 3 for _ in range(4))
    weights = rs.uniform(0.2, 1.0, 4).astype(np.float32)
    nll = np.float32(1.7)
    kw = LOSS_CASES[case]
    w = weights if case == "wpo" else None
    n = nll if case == "rpo" else None
    ref, ref_logits = j_dpo.dpo_loss(
        *map(jnp.asarray, (pc, pr, rc, rr)), JDPO(**kw),
        weights=None if w is None else jnp.asarray(w),
        nll=None if n is None else jnp.asarray(n))
    out, logits = t_dpo.dpo_loss(
        *map(torch.from_numpy, (pc, pr, rc, rr)), TDPO(**kw),
        weights=None if w is None else torch.from_numpy(w),
        nll=None if n is None else torch.tensor(n))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        t_dpo.dpo_loss(*map(torch.from_numpy, (pc, pr, rc, rr)),
                       TDPO(loss_type="hinge"))


@pytest.mark.parametrize("case", ["sigmoid", "wpo_rpo", "packed",
                                  "ce_chunk"])
def test_loss_fn_metrics_match_jax(models, case):
    """make_dpo_loss_fn with a reference that differs from the policy: the
    loss and every metric within 1e-5; the reference gets no gradient."""
    jm, params, tm, samples, tok = models
    kw = {"sigmoid": {}, "wpo_rpo": dict(use_weighting=True, rpo_alpha=0.5),
          "packed": dict(packed=True), "ce_chunk": dict(ce_chunk=5)}[case]
    jb, tb = _batches(samples, tok, packed=case == "packed")
    ref_params = jax.tree_util.tree_map(lambda x: x * 0.9, params)
    ref_model = t_dpo.frozen_reference(tm)
    load_flax_params(ref_model, flatten(jax.device_get(ref_params)))
    ref_model.requires_grad_(False)
    loss_ref, m_ref = jax.jit(j_dpo.make_dpo_loss_fn(jm, JDPO(**kw)))(
        params, ref_params, jb)
    loss, m = t_dpo.make_dpo_loss_fn(TDPO(**kw))(tm, ref_model, tb)
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                               rtol=RTOL)
    assert set(m) == set(m_ref)
    for key in m_ref:
        np.testing.assert_allclose(float(m[key]), float(m_ref[key]),
                                   rtol=RTOL, atol=1e-6, err_msg=key)
    loss.backward()
    assert all(p.grad is None for p in ref_model.parameters())
    tm.zero_grad(set_to_none=True)


LR = 4e-6  # the DPO default; two steps, the first at lr 0 (warmup)


def test_train_step_matches_jax(models):
    """Two make_dpo_train_step steps against the JAX package's step with
    optax AdamW: loss, metrics and grad_norm within 1e-5 relative, every
    updated parameter within 1e-5, and the update itself (new - old over
    all parameters) within 1e-2 of the JAX update's norm (AdamW divides
    each element by its own scale, so elements whose fp32 gradient is
    rounding noise may step either way in either package)."""
    jm, params, _, samples, tok = models
    jb, tb = _batches(samples, tok)
    tm = TModel(_cfg(TCfg), dtype=torch.float32, device="cpu", remat=True)
    load_flax_params(tm, flatten(jax.device_get(params)))
    # a reference off the policy, so that no reward is a tie of rounding
    ref_params = jax.tree_util.tree_map(lambda x: x * 0.9, params)
    ref_model = t_dpo.frozen_reference(tm)
    load_flax_params(ref_model, flatten(jax.device_get(ref_params)))
    ref_model.requires_grad_(False)
    dcfg = dict(beta=0.1, use_weighting=True, rpo_alpha=0.2)

    tx = j_sft.make_optimizer(JTrain(learning_rate=LR), 10)
    jstate = j_sft.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=tx.init(params))
    jstep = jax.jit(j_dpo.make_dpo_train_step(jm, tx, JDPO(**dcfg)))
    state = t_sft.TrainState(step=0, model=tm, optimizer=t_sft.make_optimizer(
        TTrain(learning_rate=LR), tm.parameters(), 10))
    step = t_dpo.make_dpo_train_step(tm, TDPO(**dcfg))
    for _ in range(2):
        jstate, m_ref = jstep(jstate, ref_params, jb)
        state, m = step(state, ref_model, tb)
        assert set(m) == set(m_ref)
        for key in m_ref:
            np.testing.assert_allclose(float(m[key]), float(m_ref[key]),
                                       rtol=RTOL, atol=1e-6, err_msg=key)
    assert state.step == 2
    old = flatten(jax.device_get(params))
    new_ref = flatten(jax.device_get(jstate.params))
    new = flatten(flax_params(tm))
    assert set(new) == set(new_ref)
    d_ref, d_out = [], []
    for key in new_ref:
        np.testing.assert_allclose(new[key], new_ref[key], rtol=0, atol=1e-5,
                                   err_msg=key)
        d_ref.append((np.asarray(new_ref[key]) - old[key]).ravel())
        d_out.append((new[key] - old[key]).ravel())
    d_ref, d_out = np.concatenate(d_ref), np.concatenate(d_out)
    assert np.linalg.norm(d_ref) > 0
    assert (np.linalg.norm(d_out - d_ref)
            <= 1e-2 * np.linalg.norm(d_ref))


def test_step_zero_is_an_identity(models):
    """Policy equal to reference: every DPO logit is 0, the sigmoid loss
    ln 2 and every reward exactly 0 (the check chip_smoke.py makes on the
    card)."""
    _, _, tm, samples, tok = models
    _, tb = _batches(samples, tok)
    loss, m = t_dpo.make_dpo_loss_fn(TDPO())(tm, t_dpo.frozen_reference(tm),
                                             tb)
    assert abs(float(loss.detach()) - np.log(2)) <= 1e-6
    for key in ("rewards_chosen", "rewards_rejected", "rewards_margin"):
        assert float(m[key]) == 0.0
    tm.zero_grad(set_to_none=True)


def test_generate_from_model_and_ref(models):
    """Policy and reference sampled in turn from one generator; the
    reference's tokens are the policy's when they are the same model and
    the generator is reseeded."""
    from u2tokenizer_torch.config import GenerationConfig

    _, _, tm, _, _ = models
    cfg = _cfg(TCfg)
    d, h, w = cfg.vision.input_spatial
    b, s = 2, 12
    batch = {"prompt_input_ids": torch.ones(b, s, dtype=torch.int64),
             "prompt_attention_mask": torch.cat(
                 [torch.ones(b, 8, dtype=torch.int32),
                  torch.zeros(b, 4, dtype=torch.int32)], 1),
             "images": torch.zeros(b, cfg.num_chunks, d, h, w),
             "question_ids": torch.ones(b, 4, dtype=torch.int64)}
    gen = GenerationConfig(max_new_tokens=4, do_sample=True, top_p=0.9,
                           eos_token_id=-2)
    pol, ref = t_dpo.generate_from_model_and_ref(
        tm, gen, tm, batch, torch.Generator().manual_seed(1))
    assert pol.shape == (b, 4) and ref.shape == (b, 4)
    again = t_dpo.generate_from_model_and_ref(
        tm, gen, tm, batch, torch.Generator().manual_seed(1))[0]
    assert torch.equal(pol, again)
