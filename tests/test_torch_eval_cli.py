"""The port's ``cli eval``, ``eval-predictions`` and ``quant-report``
against the JAX package's CLI, on the CPU at the tiny configuration.

Both CLIs read one HF checkpoint directory (``save_hf_checkpoint`` of a
seeded tiny model) and the same NIfTI cases: ``eval --task mrg`` and
``--task vqa`` write the same rows (greedy, bf16, the held way of
``tests/test_torch_phi_u2.py``'s ``generate``), ``eval-predictions`` the
same JSON, and ``quant-report --weights-only`` the same weights leg (SNR
within 1e-3 dB, ``max_scaled_err`` within 1e-6) and decision. ``nltk``
and ``bert_score`` are blocked, so the JAX package takes the metrics the
port copies. The model subcommands run on the GPU by default and raise
without one; ``eval-predictions`` touches no card unless ``--judge``.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cli_pipeline import judge_dir  # noqa: F401  (fixture)
from test_torch_phi import _flat, _redraw, _run, _tree
from u2tokenizer_torch import cli as t_cli
from u2tokenizer_torch.data.nifti import write_nifti
from u2tokenizer_torch.models import hf_export as t_export
from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer
from u2tokenizer_tpu import cli as j_cli
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.models.u2_model import U2CausalLM as JModel

pytestmark = pytest.mark.fast

ANSWERS = ["The study shows clear lungs and a normal heart size",
           "Small left pleural effusion without pneumothorax", "B"]


@pytest.fixture(autouse=True)
def no_optional_packages(monkeypatch):
    for name in ("nltk", "nltk.translate", "nltk.translate.bleu_score",
                 "nltk.translate.meteor_score", "bert_score",
                 "sentence_transformers"):
        monkeypatch.setitem(sys.modules, name, None)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Three NIfTI cases with their jsonl, and a tiny μ²Qwen3 checkpoint
    written by ``save_hf_checkpoint``."""
    root = tmp_path_factory.mktemp("eval")
    rs = np.random.default_rng(5)
    with open(root / "cases.jsonl", "w") as f:
        for i, answer in enumerate(ANSWERS):
            write_nifti(str(root / f"case{i}.nii.gz"),
                        rs.uniform(-1000, 400, (40, 48, 36)).astype(
                            np.float32))
            f.write(json.dumps({"image": f"case{i}.nii.gz",
                                "question": "Please describe the findings",
                                "answer": answer}) + "\n")
    jcfg = JCfg.tiny()
    d, h, w = jcfg.vision.input_spatial
    params = jax.jit(JModel(jcfg, dtype=jnp.float32).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 24), jnp.int32),
        jnp.asarray(rs.normal(size=(1, jcfg.num_chunks, d, h, w)),
                    jnp.float32), jnp.zeros((1, 6), jnp.int32))
    ckpt = root / "mu2qwen3"
    t_export.save_hf_checkpoint(str(ckpt), _tree(_redraw(_flat(params), 6)),
                                jcfg)
    return root, str(ckpt)


def _both(argv_port, argv_jax):
    """Run the port's subcommand (on the CPU) and then the JAX package's."""
    out = _run(argv_port)
    args = j_cli.build_parser().parse_args(argv_jax)
    args.fn(args)
    return out


@pytest.mark.parametrize("task", ["mrg", "vqa"])
def test_cli_eval_matches_jax(files, tmp_path, task):
    root, ckpt = files
    common = ["eval", "--tiny", "--task", task, "--checkpoint", ckpt,
              "--tokenizer", "mock", "--base-path", str(root),
              "--jsonl-path", "cases.jsonl", "--max-length", "64",
              "--max-new-tokens", "6", "--max-cases", "3"]
    result = _both(common + ["--device", "cpu", "--output",
                             str(tmp_path / "port.json")],
                   common + ["--output", str(tmp_path / "jax.json")])
    port = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert port == ref
    assert len(port["rows"]) == 3
    assert port == json.loads(result.to_json())
    if task == "vqa":
        assert set(port["metrics"]) == {"accuracy"}
        assert all(len(r["prediction"].split()) <= 1 for r in port["rows"])


def test_cli_eval_predictions_matches_jax(tmp_path):
    rows = [{"answer": ANSWERS[0], "predictions": ["clear lungs", "x"],
             "body_part": "chest"},
            {"reference": ANSWERS[1], "prediction": "small effusion",
             "body_part": "abdomen"},
            {"answer": ANSWERS[1], "predictions": []}]
    preds = tmp_path / "preds.jsonl"
    preds.write_text("".join(json.dumps(r) + "\n" for r in rows))
    for extra in ([], ["--no-bertscore"]):
        argv = ["eval-predictions", "--predictions", str(preds), *extra]
        _both(argv + ["--output", str(tmp_path / "port.json")],
              argv + ["--output", str(tmp_path / "jax.json")])
        assert ((tmp_path / "port.json").read_text()
                == (tmp_path / "jax.json").read_text())
        metrics = json.loads((tmp_path / "port.json").read_text())["metrics"]
        assert ("bertscore_f1" in metrics) == (not extra)
        assert "chest_bleu1" in metrics


@pytest.fixture
def jax_compile_cache():
    """The JAX CLI's quant-report points JAX's compile cache at a
    directory of its own; put the tests' one back afterwards."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("rehearsal", [False, True])
def test_cli_quant_report_weights_leg_matches_jax(files, capsys, rehearsal,
                                                  jax_compile_cache):
    _, ckpt = files
    argv = ["quant-report", "--tiny", "--checkpoint", ckpt,
            "--weights-only", "--per-layer"] + \
        (["--rehearsal"] if rehearsal else [])
    got = _run(argv + ["--device", "cpu"])
    capsys.readouterr()
    args = j_cli.build_parser().parse_args(argv)
    args.fn(args)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["checkpoint"] == want["checkpoint"] == ckpt
    for mode in ("int8", "int4"):
        g, w = got[mode]["weights"], want[mode]["weights"]
        assert list(g["layers"]) == list(w["layers"])
        for path, wl in w["layers"].items():
            assert abs(g["layers"][path]["snr_db"] - wl["snr_db"]) <= 1e-3
            assert abs(g["layers"][path]["max_scaled_err"]
                       - wl["max_scaled_err"]) <= 1e-6
        assert got[mode]["decision"] == want[mode]["decision"]
        assert got[mode]["decision"]["decision_grade"] == (not rehearsal)
        assert "forward" not in got[mode]


def test_cli_quant_report_full_legs(files):
    """Without ``--weights-only``: the forward and greedy legs on the
    checkpoint, and a complete battery for ``decide``."""
    _, ckpt = files
    report = _run(["quant-report", "--tiny", "--checkpoint", ckpt,
                   "--device", "cpu", "--modes", "int4", "--num-batches",
                   "1", "--greedy-tokens", "4"])
    entry = report["int4"]
    assert set(entry) == {"weights", "forward", "greedy", "decision"}
    assert "layers" not in entry["weights"]
    assert entry["forward"]["num_batches"] == 1
    assert 0.0 <= entry["forward"]["top1_match"] <= 1.0
    assert entry["greedy"]["new_tokens"] == 4
    assert entry["decision"]["complete"]


def test_cli_eval_with_a_decoder_judge(files, judge_dir, tmp_path):  # noqa: F811
    """``cli eval --judge DIR``: GREEN over the cases' reports by the
    decoder judge of the HF directory, one score a row (random weights
    give replies that parse to none)."""
    root, ckpt = files
    built = []
    build = t_cli._build_judge

    def spy(args, tokenizer=None):
        built.append(build(args, tokenizer))
        built[-1].gen_cfg = dataclasses.replace(built[-1].gen_cfg,
                                                max_new_tokens=6)
        built[-1].max_length = 512
        return built[-1]

    t_cli._build_judge = spy
    try:
        result = _run(["eval", "--tiny", "--checkpoint", ckpt,
                       "--base-path", str(root), "--jsonl-path",
                       "cases.jsonl", "--max-length", "64",
                       "--max-new-tokens", "4", "--max-cases", "2",
                       "--judge", judge_dir, "--device", "cpu", "--output",
                       str(tmp_path / "out.json")],
                      tokenizer=MockTokenizer(),
                      judge_tokenizer=MockTokenizer())
    finally:
        t_cli._build_judge = build
    assert len(built) == 1
    assert {"green_mean", "green_std"} <= set(result.metrics)
    assert len(result.rows) == 2 and all("green" in r for r in result.rows)


SUBCOMMANDS = {
    "eval": ["eval", "--tiny", "--base-path", ".", "--jsonl-path",
             "x.jsonl", "--output", "o.json"],
    "quant-report": ["quant-report", "--tiny"],
    "eval-predictions --judge": ["eval-predictions", "--predictions",
                                 "p.jsonl", "--judge", "judge_dir",
                                 "--output", "o.json"],
}


@pytest.mark.parametrize("name", list(SUBCOMMANDS))
def test_subcommands_need_a_gpu(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "p.jsonl").write_text(json.dumps(
        {"answer": "a", "prediction": "a"}) + "\n")
    monkeypatch.chdir(tmp_path)
    args = t_cli.build_parser().parse_args(SUBCOMMANDS[name])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        args.fn(args)


def test_eval_predictions_needs_no_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    preds = tmp_path / "p.jsonl"
    preds.write_text(json.dumps({"answer": "a b", "prediction": "a"}) + "\n")
    result = _run(["eval-predictions", "--predictions", str(preds),
                   "--output", str(tmp_path / "o.json")])
    assert result.metrics["rouge1_f"] > 0


@pytest.mark.parametrize("name", ["eval", "eval-predictions",
                                  "quant-report"])
def test_help(name, capsys):
    with pytest.raises(SystemExit) as e:
        t_cli.build_parser().parse_args([name, "--help"])
    assert e.value.code == 0
    assert "usage" in capsys.readouterr().out
