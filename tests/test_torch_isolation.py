"""The PyTorch port stands alone: no module of it, nor ``chip_smoke.py``,
imports JAX, flax, optax, the ``msgpack`` package (the port reads and
writes flax's msgpack form itself) or the JAX package; its configs copy the JAX package's
field for field; its entry points refuse to run on a GPU that is absent
unless the caller asks for the CPU."""

import ast
import dataclasses
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

import u2tokenizer_torch
from u2tokenizer_torch import config as t_config
from u2tokenizer_torch.models.u2_model import U2CausalLM, resolve_device
from u2tokenizer_tpu import config as j_config

pytestmark = pytest.mark.fast

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = pathlib.Path(u2tokenizer_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack",
             "u2tokenizer_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# beside torch and numpy the port needs the standard library only (its
# metrics take neither nltk nor bert_score, its attention PNG no
# matplotlib, which the card's machine lacks); the exceptions, imported
# inside U2InferenceModel when no tokenizer is passed and inside the CLI's
# tokenizer loader when a tokenizer directory is named
OTHERS = ("scipy", "safetensors", "transformers", "sklearn",
          "sentence_transformers", "nltk", "bert_score", "matplotlib")
LAZY = {("u2tokenizer_torch/eval/inference.py", "transformers"),
        ("u2tokenizer_torch/cli.py", "transformers")}


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_other_third_party_imports(path):
    rel = str(path.relative_to(ROOT))
    bad = [m for m in _imports(path) if m.split(".")[0] in OTHERS
           and (rel, m.split(".")[0]) not in LAZY]
    assert not bad, f"{rel} imports {bad}"


def test_port_imports_without_jax():
    code = ("import sys, u2tokenizer_torch.models.generate, "
            "u2tokenizer_torch.weights, u2tokenizer_torch.train.loop, "
            "u2tokenizer_torch.eval.inference, "
            "u2tokenizer_torch.models.hf_export, "
            "u2tokenizer_torch.models.vocab, "
            "u2tokenizer_torch.data.transforms, "
            "u2tokenizer_torch.utils.mock_tokenizer, "
            "u2tokenizer_torch.models.slot_serving, u2tokenizer_torch.serve, "
            "u2tokenizer_torch.data.datasets, u2tokenizer_torch.train.dpo, "
            "u2tokenizer_torch.eval.green, u2tokenizer_torch.cli, "
            "u2tokenizer_torch.eval.metrics, "
            "u2tokenizer_torch.eval.evaluators, "
            "u2tokenizer_torch.eval.quant_report, "
            "u2tokenizer_torch.eval.attention_viz, "
            "u2tokenizer_torch.models.llm.decoder, "
            "u2tokenizer_torch.models.u2tok.attention, "
            "u2tokenizer_torch.train.lora, u2tokenizer_torch.train.sft, "
            "u2tokenizer_torch.train.checkpoint, "
            "u2tokenizer_torch.utils.msgpack, u2tokenizer_torch.models.seg, "
            "u2tokenizer_torch.utils.box, "
            "u2tokenizer_torch.data.prompt_templates, "
            "u2tokenizer_torch.data.dataset_info, "
            "u2tokenizer_torch.data.m3d_datasets, "
            "u2tokenizer_torch.eval.m3d_bench, "
            "u2tokenizer_torch.data.term_dictionary, "
            "u2tokenizer_torch.data.synthesis, "
            "u2tokenizer_torch.data.converters, "
            "u2tokenizer_torch.data.amos_ct_datasets, "
            "u2tokenizer_torch.data.preprocess, "
            "u2tokenizer_torch.utils.errors, "
            "u2tokenizer_torch.utils.profiling; "
            "sys.exit(any(m.split('.')[0] in %r for m in sys.modules))"
            % (FORBIDDEN + OTHERS,))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("name,variant", [
    ("U2ModelConfig", "default"), ("U2ModelConfig", "tiny"),
    ("LLMConfig", "tiny"), ("LLMConfig", "qwen3_8b"),
    ("LLMConfig", "llama_3_2_1b"), ("GenerationConfig", "default"),
    ("TrainConfig", "default"), ("DPOConfig", "default"),
    ("SegConfig", "default"), ("SegConfig", "tiny")])
def test_config_copies_match(name, variant):
    jcls, tcls = getattr(j_config, name), getattr(t_config, name)
    jcfg = jcls() if variant == "default" else getattr(jcls, variant)()
    tcfg = tcls() if variant == "default" else getattr(tcls, variant)()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    if name == "U2ModelConfig":
        assert tcfg.proj_out_num == jcfg.proj_out_num
        assert tcfg.vision.patch_grid == jcfg.vision.patch_grid
        back = tcls.from_dict(dataclasses.asdict(jcfg))
        assert back == tcfg


def test_entry_point_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_config.U2ModelConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        U2CausalLM(cfg)
    with pytest.raises(RuntimeError):
        resolve_device()
    model = U2CausalLM(cfg, dtype=torch.float32, device="cpu")
    assert model.device.type == "cpu"


def test_serving_entry_points_need_a_gpu(monkeypatch, tmp_path):
    """The slot engine, the text server and the CLI's build functions run on the
    GPU unless told otherwise, and raise without one."""
    from u2tokenizer_torch import cli
    from u2tokenizer_torch.config import GenerationConfig, LLMConfig
    from u2tokenizer_torch.models.llm.decoder import CausalLM
    from u2tokenizer_torch.models.slot_serving import (Engine,
                                                       EngineInference)
    from u2tokenizer_torch.serve import TextLMServer
    from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_config.U2ModelConfig.tiny()
    model = U2CausalLM(cfg, dtype=torch.float32, device="cpu")
    lm = CausalLM(LLMConfig.tiny(), dtype=torch.float32, device="cpu")
    for build in (
            lambda: Engine(model, GenerationConfig(), 2, 16),
            lambda: EngineInference(model, MockTokenizer(), cfg),
            lambda: TextLMServer(lm, MockTokenizer()),
            lambda: cli.build_llm_server(cli.build_parser().parse_args(
                ["serve-llm"])),
            lambda: cli.build_served_model(cli.build_parser().parse_args(
                ["serve", "--tiny", "--checkpoint", str(tmp_path)]))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_lora_path_and_convert_checkpoint_devices(monkeypatch, tmp_path):
    """Without a GPU, ``U2InferenceModel(lora_path=)`` raises unless told
    the CPU; ``convert-checkpoint`` runs on the host and needs none."""
    from u2tokenizer_torch import cli
    from u2tokenizer_torch.eval.inference import U2InferenceModel
    from u2tokenizer_torch.models.hf_export import save_hf_checkpoint
    from u2tokenizer_torch.train.lora import LoraConfig, save_lora_dir
    from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer
    from u2tokenizer_torch.weights import flax_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_config.U2ModelConfig.tiny()
    ckpt, lora = str(tmp_path / "ckpt"), str(tmp_path / "lora")
    v = cfg.vision  # the tiny sizes that config.json alone must carry
    save_hf_checkpoint(ckpt, flax_params(U2CausalLM(
        cfg, dtype=torch.float32, device="cpu")), cfg, extra_config={
            "vision_num_layers": v.num_layers, "vision_mlp_dim": v.mlp_dim,
            "vision_num_heads": v.num_heads})
    save_lora_dir(lora, {}, LoraConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        U2InferenceModel(ckpt, tokenizer=MockTokenizer(), lora_path=lora)
    U2InferenceModel(ckpt, tokenizer=MockTokenizer(), lora_path=lora,
                     device="cpu")
    args = cli.build_parser().parse_args(
        ["convert-checkpoint", "--hf-dir", ckpt, "--output",
         str(tmp_path / "out"), "--num-chunks", str(cfg.num_chunks)])
    assert not hasattr(args, "device")
    assert args.fn(args)["params"] > 0


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """Without a CUDA device, and alone in a directory without the port,
    chip_smoke.py exits non-zero and prints no result line."""
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", script)
        run = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env={"CUDA_VISIBLE_DEVICES": "",
                                  "PATH": "/usr/bin:/bin"})
        assert run.returncode != 0
        assert '"ok"' not in run.stdout
