"""The port's evaluators (``u2tokenizer_torch/eval/evaluators.py``)
against the JAX package's, on the CPU.

Every evaluator runs in both packages with the same stub report generator,
the same stub GREEN judge (each package's ``GreenScorer`` over it) and the
same stub LLM-judge backend, and the two ``EvalResult`` JSON texts (or
metric dicts) must be equal: the metrics are the same arithmetic in the
same order (``tests/test_torch_metrics.py``). ``nltk`` and ``bert_score``
are blocked, so the JAX package takes the fallbacks the port copies.
``ReportGenerator`` itself runs a tiny model on a ``FusedDataset`` sample:
its text is the port's ``MultimodalGenerate`` tokens decoded, and equals
the JAX package's ``ReportGenerator`` on the same sample and weights.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_green import RESPONSE_LETTERS, RESPONSE_NO_ERRORS, RESPONSE_NUMBERS
from test_torch_phi import _flat, _redraw, _tree
from u2tokenizer_torch.config import GenerationConfig as TGen
from u2tokenizer_torch.config import U2ModelConfig as TCfg
from u2tokenizer_torch.data.datasets import FusedDataset
from u2tokenizer_torch.data.nifti import write_nifti
from u2tokenizer_torch.eval import evaluators as t_ev
from u2tokenizer_torch.eval import green as t_green
from u2tokenizer_torch.models import generate as t_generate
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer
from u2tokenizer_torch.weights import load_flax_params
from u2tokenizer_tpu.config import GenerationConfig as JGen
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.eval import evaluators as j_ev
from u2tokenizer_tpu.eval import green as j_green
from u2tokenizer_tpu.models import generate as j_generate
from u2tokenizer_tpu.models.u2_model import U2CausalLM as JModel

pytestmark = pytest.mark.fast

PACKAGES = {"port": (t_ev, t_green), "jax": (j_ev, j_green)}
REFERENCES = ["the lungs are clear without focal consolidation",
              "small left pleural effusion . no pneumothorax",
              "mild degenerative change of the thoracic spine",
              "hypodense lesion in segment 4 of the liver"]


@pytest.fixture(autouse=True)
def no_optional_packages(monkeypatch):
    for name in ("nltk", "nltk.translate", "nltk.translate.bleu_score",
                 "nltk.translate.meteor_score", "bert_score",
                 "sentence_transformers"):
        monkeypatch.setitem(sys.modules, name, None)


class StubDataset:
    """Cases with the keys the evaluators read; case 2 is missing (None)."""

    def __len__(self):
        return len(REFERENCES)

    def __getitem__(self, i):
        if i == 2:
            return None
        return {"question": f"describe case {i}",
                "prompt_question": f"<user> describe case {i}",
                "answer": REFERENCES[i],
                "answer_choice": "ABCD"[i] if i != 1 else None}


def stub_generator(sample, rng):
    """A report from the sample alone (the evaluators' rng is each
    package's own and is not read)."""
    words = sample["answer"].split()
    return " ".join(words[::2]) + " heart normal"


def stub_judge(prompts):
    responses = (RESPONSE_LETTERS, RESPONSE_NUMBERS, RESPONSE_NO_ERRORS)
    return [responses[i % 3] for i in range(len(prompts))]


def _scorer(green):
    return green.GreenScorer(stub_judge, compute_summary_stats=False)


@pytest.mark.parametrize("judged", [False, True])
@pytest.mark.parametrize("max_cases", [2, 100])
def test_evaluate_mrg_matches_jax(judged, max_cases):
    out = {name: ev.evaluate_mrg(StubDataset(), stub_generator,
                                 _scorer(green) if judged else None,
                                 max_cases=max_cases).to_json()
           for name, (ev, green) in PACKAGES.items()}
    assert out["port"] == out["jax"]
    assert ("green_mean" in json.loads(out["port"])["metrics"]) == judged


@pytest.mark.parametrize("max_cases", [1, 10**9])
def test_evaluate_vqa_matches_jax(max_cases):
    out = {name: ev.evaluate_vqa(StubDataset(), stub_generator,
                                 max_cases=max_cases).to_json()
           for name, (ev, _) in PACKAGES.items()}
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("judged", [False, True])
@pytest.mark.parametrize("bertscore", [False, True])
def test_evaluate_benchmark_matches_jax(judged, bertscore):
    hyps = [stub_generator({"answer": r}, None) for r in REFERENCES]
    out = {name: ev.evaluate_benchmark(REFERENCES, hyps,
                                       _scorer(green) if judged else None,
                                       compute_bertscore=bertscore)
           for name, (ev, green) in PACKAGES.items()}
    assert out["port"] == out["jax"]
    assert ("bertscore_f1" in out["port"]) == bertscore


@pytest.mark.parametrize("judged", [False, True])
def test_evaluate_by_body_part_matches_jax(judged):
    cases = [{"body_part": part, "reference": ref}
             for part, ref in zip(("chest", "abdomen", "chest", "head"),
                                  REFERENCES)]
    predict = lambda case: stub_generator({"answer": case["reference"]}, 0)
    out = {name: ev.evaluate_by_body_part(
        cases, predict, green_scorer=_scorer(green) if judged else None)
        for name, (ev, green) in PACKAGES.items()}
    assert out["port"] == out["jax"]
    assert set(out["port"]) == {"chest", "abdomen", "head", "overall"}


PREDICTION_ROWS = [
    {"answer": REFERENCES[0], "prediction": REFERENCES[0],
     "body_part": "chest"},
    {"reference": REFERENCES[1], "predictions": ["small effusion", "x"],
     "body_part": "abdomen"},
    {"answer": REFERENCES[2], "predictions": []},
    {"answer": REFERENCES[3], "prediction": None},
    {"answer": REFERENCES[3], "prediction": "liver lesion", "body_part": ""},
]


@pytest.mark.parametrize("judged", [False, True])
@pytest.mark.parametrize("bertscore", [False, True])
def test_evaluate_predictions_matches_jax(judged, bertscore):
    out = {name: ev.evaluate_predictions(
        PREDICTION_ROWS, _scorer(green) if judged else None,
        compute_bertscore=bertscore).to_json()
        for name, (ev, green) in PACKAGES.items()}
    assert out["port"] == out["jax"]
    assert len(json.loads(out["port"])["rows"]) == 3


@pytest.mark.parametrize("takes_system", [False, True])
@pytest.mark.parametrize("max_rows", [None, 2])
def test_evaluate_with_llm_matches_jax(takes_system, max_rows):
    seen = {"port": [], "jax": []}

    def backend_for(name):
        def reply(prompt):
            return "no score" if "effusion" in prompt else \
                f"Reasoning.\nScore: {len(prompt) % 97}.5"
        if takes_system:
            return lambda prompt, system=None: (
                seen[name].append((prompt, system)) or reply(prompt))
        return lambda prompt: seen[name].append((prompt,)) or reply(prompt)

    out = {name: ev.evaluate_with_llm(PREDICTION_ROWS, backend_for(name),
                                      max_rows=max_rows)
           for name, (ev, _) in PACKAGES.items()}
    assert out["port"] == out["jax"]
    assert seen["port"] == seen["jax"] and seen["port"]
    assert t_ev.LLM_JUDGE_TEMPLATE == j_ev.LLM_JUDGE_TEMPLATE
    assert t_ev.LLM_JUDGE_SYSTEM == j_ev.LLM_JUDGE_SYSTEM


def test_decode_tokens_matches_jax():
    tok = MockTokenizer()
    ids = tok("clear lungs normal heart")["input_ids"]
    for tokens in (ids + [1, 5], [0, 0] + ids, [], [1] + ids):
        assert (t_ev._decode_tokens(tok, tokens, 0, 1)
                == j_ev._decode_tokens(tok, tokens, 0, 1))


def test_report_generator_matches_jax(tmp_path):
    """``ReportGenerator`` on a tiny ``FusedDataset`` sample (greedy, fp32
    model and cache): its text is the port's ``MultimodalGenerate`` tokens
    on the same sample decoded, and the JAX package's ``ReportGenerator``
    gives the same text from the same weights."""
    rs = np.random.default_rng(0)
    write_nifti(str(tmp_path / "case0.nii.gz"),
                rs.uniform(-1000, 400, (40, 48, 36)).astype(np.float32))
    (tmp_path / "cases.jsonl").write_text(json.dumps({
        "image": "case0.nii.gz", "question": "Please describe the findings",
        "answer": "clear lungs"}) + "\n")
    jcfg = JCfg.tiny()
    cfg = TCfg.from_dict(dataclasses.asdict(jcfg))
    tok = MockTokenizer()
    sample = FusedDataset(
        str(tmp_path), "cases.jsonl", tok, max_length=64,
        image_tokens_num=cfg.proj_out_num, data_type="validation",
        num_chunks=cfg.num_chunks, chunk_depth=cfg.vision.input_spatial[0],
        target_size=cfg.vision.input_spatial[1], device="cpu")[0]
    host = {k: np.asarray(v) for k, v in sample.items()
            if k in ("input_id", "image", "question_ids", "attention_mask")}

    jm = JModel(jcfg, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.asarray(host["input_id"][None]),
                     jnp.asarray(host["image"][None]),
                     jnp.asarray(host["question_ids"][None]))
    flat = _redraw(_flat(params), 3)
    model = TModel(cfg, dtype=torch.float32, device="cpu")
    load_flax_params(model, flat)

    jgen = JGen(max_new_tokens=8, eos_token_id=tok.eos_token_id,
                pad_token_id=tok.pad_token_id)
    gen_fn = t_generate.make_multimodal_generate_fn(
        model, TGen(**dataclasses.asdict(jgen)), cache_dtype=torch.float32)
    seen = []

    def spy(*args):
        seen.append(gen_fn(*args))
        return seen[-1]

    text = t_ev.ReportGenerator(model, tok, spy, pad_id=tok.pad_token_id,
                                eos_id=tok.eos_token_id)(sample)
    plen = torch.tensor([int(sample["attention_mask"].sum())],
                        dtype=torch.int32)
    direct = gen_fn(sample["input_id"][None], sample["image"][None],
                    sample["question_ids"][None], plen)
    assert torch.equal(seen[0], direct)
    assert text == t_ev._decode_tokens(tok, direct[0].tolist(),
                                       tok.pad_token_id, tok.eos_token_id)

    jfn = j_generate.make_multimodal_generate_fn(jm, jgen,
                                                 cache_dtype=jnp.float32)
    want = j_ev.ReportGenerator(jm, _tree(flat), tok, jfn,
                                pad_id=tok.pad_token_id,
                                eos_id=tok.eos_token_id)(
        host, jax.random.PRNGKey(0))
    assert text == want
