"""The port's quantization-quality report (``eval/quant_report.py``)
against the JAX package's, on the CPU, on ``U2ModelConfig.tiny()`` with the
JAX parameters carried across by ``load_flax_params``.

  * ``layer_quant_report``: the same leaves under the same paths; SNR
    within 1e-3 dB (both round to 0.01 dB from fp64 sums taken in another
    order) and ``max_scaled_err`` within 1e-6 (rounded to 1e-6 from the
    same fp32 errors);
  * ``forward_agreement`` and ``greedy_agreement`` at fp32: top-1 and
    top-5 agreement equal, mean KL within 1e-6 absolute (the fp32 logits
    of the two packages agree to ~1e-6), the first divergence and the
    match fraction equal;
  * ``synthetic_batches`` bit for bit, and ``decide`` on the JAX test's
    cases.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_phi import _flat, _redraw, _tree
from u2tokenizer_torch.config import U2ModelConfig as TCfg
from u2tokenizer_torch.eval import quant_report as t_qr
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.weights import load_flax_params
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.eval import quant_report as j_qr
from u2tokenizer_tpu.models.u2_model import U2CausalLM as JModel

pytestmark = pytest.mark.fast

SNR_TOL, ERR_TOL, KL_TOL = 1e-3, 1e-6, 1e-6


def _port_batches(batches):
    return [{k: torch.from_numpy(np.array(v)) for k, v in b.items()}
            for b in batches]


@pytest.fixture(scope="module")
def pair():
    """The JAX tiny config, its parameters (biases re-drawn so that they
    matter), the port's fp32 model holding the same, and the probe
    batches of both packages."""
    jcfg = JCfg.tiny()
    jbatches = j_qr.synthetic_batches(jcfg, num_batches=2, seq_extra=12)
    b = jbatches[0]
    params = jax.jit(JModel(jcfg, dtype=jnp.float32).init)(
        jax.random.PRNGKey(0), b["input_ids"], b["images"],
        b["question_ids"])
    flat = _redraw(_flat(params), 2)
    model = TModel(TCfg.from_dict(dataclasses.asdict(jcfg)),
                   dtype=torch.float32, device="cpu")
    load_flax_params(model, flat)
    return jcfg, _tree(flat), model, jbatches


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_layer_report_matches_jax(pair, mode):
    _, params, model, _ = pair
    got = t_qr.layer_quant_report(model, mode)
    want = j_qr.layer_quant_report(params, mode)
    assert list(got["layers"]) == list(want["layers"])
    assert got["num_layers"] == want["num_layers"] > 0
    for path, w in want["layers"].items():
        g = got["layers"][path]
        assert g["shape"] == w["shape"], path
        assert abs(g["snr_db"] - w["snr_db"]) <= SNR_TOL, path
        assert abs(g["max_scaled_err"] - w["max_scaled_err"]) <= ERR_TOL, \
            path
    for key in ("snr_db_min", "snr_db_mean"):
        assert abs(got[key] - want[key]) <= SNR_TOL
    assert got["mode"] == mode


def test_layer_report_untied_head_and_bare_decoder():
    """An untied ``lm_head`` stays int8 in int4 mode, and a bare
    ``CausalLM`` reports its leaves without the ``llm/`` prefix, as the
    JAX report of a bare decoder tree does."""
    from u2tokenizer_torch.config import LLMConfig as TLLM
    from u2tokenizer_torch.models.layers import init_weights
    from u2tokenizer_torch.models.llm.decoder import CausalLM as TLM
    from u2tokenizer_torch.weights import flax_params
    from u2tokenizer_tpu.config import LLMConfig as JLLM

    jcfg = dataclasses.replace(JLLM.tiny(), tie_word_embeddings=False)
    model = TLM(TLLM(**dataclasses.asdict(jcfg)), dtype=torch.float32,
                device="cpu")
    init_weights(model, 0)
    tree = flax_params(model)
    for mode in ("int8", "int4"):
        got = t_qr.layer_quant_report(model, mode)
        want = j_qr.layer_quant_report(tree, mode)
        assert list(got["layers"]) == list(want["layers"])
        assert "lm_head" in got["layers"]
        for path, w in want["layers"].items():
            assert abs(got["layers"][path]["snr_db"] - w["snr_db"]) \
                <= SNR_TOL, path


def test_synthetic_batches_bit_for_bit(pair):
    jcfg = pair[0]
    cfg = TCfg.from_dict(dataclasses.asdict(jcfg))
    for kw in ({}, {"num_batches": 3, "batch": 2, "seq_extra": 5,
                    "seed": 4}):
        got = t_qr.synthetic_batches(cfg, **kw)
        want = j_qr.synthetic_batches(jcfg, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for key in w:
                wa = np.asarray(w[key])
                ga = g[key].numpy()
                assert ga.dtype == wa.dtype, key
                np.testing.assert_array_equal(ga, wa, err_msg=key)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_forward_agreement_matches_jax(pair, mode):
    jcfg, params, model, jbatches = pair
    qmodel = t_qr.quantized_copy(model, mode)
    got = t_qr.forward_agreement(model, _port_batches(jbatches), mode,
                                 qmodel=qmodel)
    want = j_qr.forward_agreement(jcfg, params, jbatches, mode,
                                  dtype=jnp.float32)
    for key in ("mode", "num_batches", "top1_match",
                "float_top5_contains_q_top1"):
        assert got[key] == want[key], key
    assert abs(got["mean_kl"] - want["mean_kl"]) <= KL_TOL
    assert got["mean_kl"] > 0
    assert abs(got["max_scaled_logit_err"]
               - want["max_scaled_logit_err"]) <= 1e-5
    # the float model is left float; the copy is the serving transform's
    assert not model.llm.model.quantized
    assert qmodel.llm.model.quantized
    assert qmodel.cfg.llm.quantized_weights == mode


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_greedy_agreement_matches_jax(pair, mode):
    jcfg, params, model, jbatches = pair
    got = t_qr.greedy_agreement(model, _port_batches(jbatches)[0], mode,
                                max_new_tokens=8)
    want = j_qr.greedy_agreement(jcfg, params, jbatches[0], mode,
                                 max_new_tokens=8, dtype=jnp.float32)
    assert got == want


def test_logit_agreement_metrics_match_jax():
    rs = np.random.RandomState(0)
    lf = rs.randn(2, 5, 40).astype(np.float32) * 3
    lq = lf + rs.randn(2, 5, 40).astype(np.float32) * 0.3
    got = t_qr.logit_agreement_metrics(torch.from_numpy(lf),
                                       torch.from_numpy(lq))
    want = jax.device_get(j_qr._logit_agreement_metrics(jnp.asarray(lf),
                                                        jnp.asarray(lq)))
    for key in ("top1", "top5", "max_err"):
        assert got[key] == pytest.approx(float(want[key]), abs=1e-7), key
    assert got["kl"] == pytest.approx(float(want["kl"]), abs=1e-6)


GOOD = {"weights": {"snr_db_min": 22.0},
        "forward": {"top1_match": 0.99, "mean_kl": 0.002},
        "greedy": {"match_fraction": 0.97}}
DECIDE_CASES = {
    "int4_go": (GOOD, "int4", True),
    "int4_kl_fails": (dict(GOOD, forward={"top1_match": 0.99,
                                          "mean_kl": 0.05}), "int4", True),
    "int8_stricter": (GOOD, "int8", True),
    "weights_only": ({"weights": {"snr_db_min": 40.0}}, "int8", True),
    "weights_only_fails": ({"weights": {"snr_db_min": 5.0}}, "int8", True),
    "nothing_evaluable": ({"weights": {}}, "int8", True),
    "not_decision_grade": (GOOD, "int4", False),
    "weights_only_rehearsal": ({"weights": {"snr_db_min": 40.0}}, "int8",
                               False),
    "unknown_mode": (GOOD, "fp8", True),
}


@pytest.mark.parametrize("case", list(DECIDE_CASES))
def test_decide_matches_jax(case):
    entry, mode, grade = DECIDE_CASES[case]
    assert (t_qr.decide(entry, mode, decision_grade=grade)
            == j_qr.decide(entry, mode, decision_grade=grade))
    assert t_qr.DECISION_THRESHOLDS == j_qr.DECISION_THRESHOLDS
