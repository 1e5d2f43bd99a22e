"""The port's stage-1 and stage-2 pipeline from files through its CLI, on
the CPU at the tiny configuration (``--tiny --device cpu``):
``train`` (one step) -> ``generate`` (two sampled samples a case) ->
``green`` (the stub judge) -> ``dpo-convert`` -> ``dpo`` (one step). The
``green`` and ``dpo-convert`` files equal the JAX package's commands'
output on the same predictions, byte for byte. Every subcommand that runs
a model runs on the GPU by default and raises without one; meshes (with
``--qlora`` too) raise ``NotImplementedError`` naming their ``ROADMAP.md``
item (``--qlora`` itself runs: ``test_torch_qlora_train.py``); the
msgpack checkpoint form loads.
"""

import argparse
import dataclasses
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from u2tokenizer_torch import cli
from u2tokenizer_torch.data.nifti import write_nifti
from u2tokenizer_torch.train import dpo as t_dpo
from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer
from u2tokenizer_tpu import cli as j_cli

pytestmark = pytest.mark.fast

ANSWERS = ["The study shows clear lungs and a normal heart size",
           "Small left pleural effusion without pneumothorax"]


@pytest.fixture(autouse=True)
def no_sentence_transformers(monkeypatch):
    """The JAX package's GREEN summary embeds with TF-IDF, never a
    download."""
    monkeypatch.setitem(sys.modules, "sentence_transformers", None)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    rs = np.random.default_rng(0)
    for i in range(2):
        write_nifti(str(root / f"case{i}.nii.gz"),
                    rs.uniform(-1000, 400, (40, 48, 36)).astype(np.float32))
    with open(root / "train.jsonl", "w") as f:
        for i, answer in enumerate(ANSWERS):
            f.write(json.dumps({"image": f"case{i}.nii.gz",
                                "question": "Please describe the findings",
                                "answer": answer}) + "\n")
    return str(root)


def _run(argv, **kw):
    args = cli.build_parser().parse_args(argv)
    return args.fn(args, **kw)


def test_pipeline(data, monkeypatch):
    tok = MockTokenizer()
    out = os.path.join(data, "out")
    common = ["--tiny", "--device", "cpu", "--tokenizer", "mock"]
    state = _run(["train", *common, "--train-base-path", data,
                  "--train-jsonl-path", "train.jsonl", "--max-steps", "1",
                  "--batch-size", "2", "--max-length", "64",
                  "--num-workers", "1", "--output-dir", out + "/sft",
                  "--learning-rate", "1e-4"], tokenizer=tok)
    assert state.step == 1
    with open(out + "/sft/metrics.jsonl") as f:
        assert f.read() == ""  # log_steps 10: nothing logged at step 1
    assert os.path.isdir(out + "/sft/checkpoints/1")

    preds = os.path.join(data, "preds.jsonl")
    _run(["generate", *common, "--base-path", data, "--jsonl-path",
          "train.jsonl", "--output", preds, "--max-length", "64",
          "--max-new-tokens", "8", "--do-sample", "--num-samples", "2",
          "--seed", "1"], tokenizer=tok)
    rows = [json.loads(line) for line in open(preds)]
    assert [r["answer"] for r in rows] == ANSWERS
    assert all(1 <= len(r["predictions"]) <= 2 for r in rows)
    assert all(r["image"].endswith(f"case{i}.nii.gz")
               for i, r in enumerate(rows))

    files = {}
    for name, mod in (("port", cli), ("jax", j_cli)):
        green = os.path.join(data, f"greened_{name}.jsonl")
        pairs = os.path.join(data, f"pairs_{name}.jsonl")
        mod.cmd_green(argparse.Namespace(predictions=preds, judge=None,
                                         judge_weights="bf16",
                                         no_summary=False, output=green,
                                         device="cpu"))
        mod.cmd_dpo_convert(argparse.Namespace(greened=green, output=pairs))
        files[name] = [open(green).read(), open(pairs).read()]
    assert files["port"] == files["jax"]
    greened = [json.loads(line) for line in files["port"][0].splitlines()]
    assert all(s == 1.0 for r in greened for s in r["green_scores"])
    pairs = [json.loads(line) for line in files["port"][1].splitlines()]
    assert len(pairs) == 2
    assert [p["chosen"] for p in pairs] == [r["predictions"][0]
                                            for r in greened]
    assert [p["rejected"] for p in pairs] == [r["predictions"][-1]
                                              for r in greened]

    seen = []
    make_step = t_dpo.make_dpo_train_step

    def probed(model, cfg):
        step = make_step(model, cfg)

        def run(state, ref, batch):
            state, metrics = step(state, ref, batch)
            seen.append(metrics)
            return state, metrics

        return run

    monkeypatch.setattr(t_dpo, "make_dpo_train_step", probed)
    state, ref = _run(["dpo", *common, "--train-base-path", data,
                       "--train-jsonl-path", "pairs_port.jsonl",
                       "--max-steps", "1", "--output-dir", out + "/dpo"],
                      tokenizer=tok)
    assert state.step == 1 and len(seen) == 1
    # step 0: policy equals reference
    assert abs(float(seen[0]["loss"]) - math.log(2)) <= 1e-6
    assert float(seen[0]["rewards_margin"]) == 0.0
    assert all(not p.requires_grad for p in ref.parameters())


def test_dpo_convert_drops_zero_and_none_scores(tmp_path):
    rows = [{"image": "a", "question": "q", "answer": "x",
             "predictions": ["p1", "p2"], "green_scores": [0.5, 0.0]},
            {"image": "b", "question": "q", "answer": "y",
             "predictions": ["p1"], "green_scores": [None]},
            {"image": "c", "question": "q", "answer": "z",
             "predictions": ["p1", "p2"], "green_scores": [0.0, 0.0]}]
    src = tmp_path / "g.jsonl"
    src.write_text("".join(json.dumps(r) + "\n" for r in rows))
    outs = []
    for mod in (cli, j_cli):
        dst = tmp_path / f"{mod.__name__}.jsonl"
        mod.cmd_dpo_convert(argparse.Namespace(greened=str(src),
                                               output=str(dst)))
        outs.append(dst.read_text())
    assert outs[0] == outs[1]
    assert [json.loads(l)["image"] for l in outs[0].splitlines()] == ["a"]


def test_report_validity_matches_jax():
    for text in ("short", "a report that is long enough to pass",
                 "一个足够长的报告但是含有中文字符所以不合格的文本内容"):
        assert (cli.check_report_validity(text)
                == j_cli.check_report_validity(text))


SUBCOMMANDS = {
    "train": ["train", "--tiny", "--train-base-path", ".",
              "--train-jsonl-path", "x.jsonl"],
    "dpo": ["dpo", "--tiny", "--train-base-path", ".",
            "--train-jsonl-path", "x.jsonl"],
    "generate": ["generate", "--tiny", "--base-path", ".", "--jsonl-path",
                 "x.jsonl", "--output", "o.jsonl"],
    "green": ["green", "--predictions", "p.jsonl", "--judge", "judge_dir",
              "--output", "o.jsonl"],
}


@pytest.mark.parametrize("name", list(SUBCOMMANDS))
def test_subcommands_need_a_gpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = cli.build_parser().parse_args(SUBCOMMANDS[name])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        args.fn(args, tokenizer=MockTokenizer())


@pytest.mark.parametrize("extra,error,item", [
    # the ids are the cases' names from when meshes were refused. --qlora
    # returns before the mesh, as the JAX CLI's does, and gets as far as
    # reading the (absent) data; a mesh of more than one device without a
    # launcher is refused, naming torchrun (tests/test_torch_parallel.py
    # runs meshes under one)
    pytest.param(["--qlora", "int8", "--mesh-fsdp", "2"], FileNotFoundError,
                 "x.jsonl", id="extra0-LoRA"),
    pytest.param(["--mesh-fsdp", "2"], ValueError, "torchrun",
                 id="extra1-parallel/"),
    pytest.param(["--mesh-data", "4"], ValueError, "torchrun",
                 id="extra2-parallel/")])
def test_train_refuses_what_is_not_ported(extra, error, item):
    args = cli.build_parser().parse_args(
        SUBCOMMANDS["train"] + ["--device", "cpu"] + extra)
    with pytest.raises(error, match=item):
        args.fn(args, tokenizer=MockTokenizer())


def test_msgpack_checkpoint_is_refused(tmp_path):
    """The msgpack checkpoint form (``convert-checkpoint``'s
    ``u2_params.msgpack``) is read now: a model's flax tree written in it
    loads into another model of the config, every parameter equal
    (``test_torch_convert_checkpoint.py`` holds the form to the JAX
    package's)."""
    from u2tokenizer_torch.config import U2ModelConfig
    from u2tokenizer_torch.models.u2_model import U2CausalLM
    from u2tokenizer_torch.train.checkpoint import save_params_msgpack
    from u2tokenizer_torch.weights import flax_params

    cfg = U2ModelConfig.tiny()
    source = U2CausalLM(cfg, dtype=torch.float32, device="cpu", seed=1)
    save_params_msgpack(str(tmp_path / "u2_params.msgpack"),
                        flax_params(source))
    model = U2CausalLM(cfg, dtype=torch.float32, device="cpu", seed=2)
    cli._load_pretrained_into(model, str(tmp_path), model.cfg)
    for (name, a), (_, b) in zip(source.state_dict().items(),
                                 model.state_dict().items()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("name", ["train", "generate", "green",
                                  "dpo-convert", "dpo"])
def test_help(name, capsys):
    with pytest.raises(SystemExit) as e:
        cli.build_parser().parse_args([name, "--help"])
    assert e.value.code == 0
    assert "usage" in capsys.readouterr().out


@pytest.fixture(scope="module")
def judge_dir(tmp_path_factory):
    """A tiny Llama-family decoder as an HF directory: model.safetensors
    (bf16, through export_decoder) and config.json."""
    from u2tokenizer_torch.config import LLMConfig
    from u2tokenizer_torch.models.hf_export import export_decoder
    from u2tokenizer_torch.models.layers import init_weights
    from u2tokenizer_torch.models.llm.decoder import CausalLM
    from u2tokenizer_torch.models.safetensors_io import write_safetensors
    from u2tokenizer_torch.weights import flax_params

    path = tmp_path_factory.mktemp("judge")
    cfg = dataclasses.replace(LLMConfig.tiny(vocab_size=1024),
                              model_type="llama", qk_norm=False,
                              tie_word_embeddings=True)
    model = CausalLM(cfg, dtype=torch.float32, device="cpu")
    init_weights(model, 0)
    sd = {}
    export_decoder(flax_params(model)["params"], cfg, sd)
    write_safetensors(str(path / "model.safetensors"),
                      {k: torch.from_numpy(v).to(torch.bfloat16)
                       for k, v in sd.items()})
    (path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
        "tie_word_embeddings": True,
        "max_position_embeddings": cfg.max_position_embeddings}))
    return str(path)


@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_green_with_a_decoder_judge(judge_dir, tmp_path, weights,
                                    monkeypatch):
    """``cli green --judge DIR`` on the CPU: the judge built from the HF
    directory (bf16, or its weights quantized to int8) scores and sorts
    every sample; random weights give replies that parse to no score."""
    from u2tokenizer_torch.eval.green import TorchJudge

    tok = MockTokenizer()
    preds = tmp_path / "preds.jsonl"
    preds.write_text(json.dumps({
        "image": "a", "question": "q", "answer": ANSWERS[0],
        "predictions": ["clear lungs", "a small effusion",
                        "normal heart"]}) + "\n")
    built = []
    build = cli._build_judge

    def spy(args, tokenizer=None):
        built.append(build(args, tokenizer))
        built[-1].gen_cfg = dataclasses.replace(built[-1].gen_cfg,
                                                max_new_tokens=6)
        built[-1].max_length = 512
        return built[-1]

    out = tmp_path / "greened.jsonl"
    monkeypatch.setattr(cli, "_build_judge", spy)
    _run(["green", "--predictions", str(preds), "--judge", judge_dir,
          "--judge-weights", weights, "--output", str(out),
          "--device", "cpu", "--no-summary"], tokenizer=tok)
    judge = built[0]
    assert isinstance(judge, TorchJudge) and judge.speculative
    assert judge.model.model.quantized == (weights == "int8")
    row = json.loads(out.read_text())
    assert sorted(row["predictions"]) == sorted(
        ["clear lungs", "a small effusion", "normal heart"])
    assert len(row["green_scores"]) == 3
    with pytest.raises(SystemExit):
        build(argparse.Namespace(judge=judge_dir, judge_weights="int4",
                                 device="cpu"))
