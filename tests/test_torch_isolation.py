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


# beside torch and numpy the port needs the standard library only; the
# exceptions, imported inside U2InferenceModel when no tokenizer is passed
# and inside the CLI's tokenizer loader when a tokenizer directory is named
OTHERS = ("scipy", "safetensors", "transformers", "sklearn",
          "sentence_transformers")
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
            "u2tokenizer_torch.eval.green, u2tokenizer_torch.cli; "
            "sys.exit(any(m.split('.')[0] in %r for m in sys.modules))"
            % (FORBIDDEN + OTHERS,))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("name,variant", [
    ("U2ModelConfig", "default"), ("U2ModelConfig", "tiny"),
    ("LLMConfig", "tiny"), ("LLMConfig", "qwen3_8b"),
    ("LLMConfig", "llama_3_2_1b"), ("GenerationConfig", "default"),
    ("TrainConfig", "default"), ("DPOConfig", "default")])
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
