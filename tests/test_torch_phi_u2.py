"""μ²Phi-3 in the PyTorch port against the JAX package, on the CPU: a tiny
``U2CausalLM`` on a Phi-3-shaped decoder (hidden 192 = 2 heads of 96), its
multimodal greedy generate, and ``cli generate --checkpoint`` on a
checkpoint written by ``save_hf_checkpoint``. The decoders, converters and
``cli green`` are in ``tests/test_torch_phi.py``, whose helpers this file
shares.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_phi import B, SHAPES, _flat, _redraw, _run, _tree
from u2tokenizer_torch import cli as t_cli
from u2tokenizer_torch.config import GenerationConfig as TGen
from u2tokenizer_torch.config import U2ModelConfig as TCfg
from u2tokenizer_torch.data.nifti import write_nifti
from u2tokenizer_torch.models import generate as t_generate
from u2tokenizer_torch.models import hf_export as t_export
from u2tokenizer_torch.models import hf_weights as t_hf
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer
from u2tokenizer_torch.weights import flatten, flax_params, load_flax_params
from u2tokenizer_tpu import cli as j_cli
from u2tokenizer_tpu.config import GenerationConfig as JGen
from u2tokenizer_tpu.config import LLMConfig as JLLM
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.models import generate as j_generate
from u2tokenizer_tpu.models import hf_weights as j_hf
from u2tokenizer_tpu.models.u2_model import U2CausalLM as JModel

pytestmark = pytest.mark.fast


def _u2_phi3():
    jcfg = JCfg.tiny()
    return dataclasses.replace(jcfg, llm=SHAPES["phi3"](JLLM))


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_u2_model_phi3_generate(cache):
    """A tiny U2CausalLM on a Phi-3 decoder: greedy tokens of the
    multimodal generate equal the JAX package's."""
    jcfg = _u2_phi3()
    rs = np.random.RandomState(4)
    d, h, w = jcfg.vision.input_spatial
    images = rs.randn(B, jcfg.num_chunks, d, h, w).astype(np.float32)
    ids = rs.randint(0, 512, (B, 24)).astype(np.int32)
    qids = rs.randint(0, 512, (B, 6)).astype(np.int32)
    plen = np.array([24, 19], np.int32)
    jm = JModel(jcfg, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                     jnp.asarray(images), jnp.asarray(qids))
    flat = _redraw(_flat(params), 5)
    tm = TModel(TCfg.from_dict(dataclasses.asdict(jcfg)),
                dtype=torch.float32, device="cpu")
    load_flax_params(tm, flat)
    jgen = JGen(max_new_tokens=5, eos_token_id=-2)
    ref = j_generate.make_multimodal_generate_fn(
        jm, jgen, cache_dtype=jnp.float32 if cache == "float32" else cache)(
        _tree(flat), jnp.asarray(ids), jnp.asarray(images),
        jnp.asarray(qids), jnp.asarray(plen), jax.random.PRNGKey(1))
    out = t_generate.make_multimodal_generate_fn(
        tm, TGen(**dataclasses.asdict(jgen)),
        cache_dtype=torch.float32 if cache == "float32" else cache)(
        *(torch.from_numpy(x).long() for x in (ids,)),
        torch.from_numpy(images), torch.from_numpy(qids).long(),
        torch.from_numpy(plen))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_cli_generate_phi3_checkpoint(tmp_path):
    """``cli generate --checkpoint DIR`` on a tiny μ²Phi-3 checkpoint
    written by ``save_hf_checkpoint``: its config.json reads as the Phi-3
    decoder in both packages, the CLI builds the checkpoint's own config
    and loads the weights the JAX converter reads from the directory, and
    its greedy predictions equal the JAX CLI's (given that config) on the
    same files."""
    jcfg = _u2_phi3()
    rs = np.random.RandomState(7)
    d, h, w = jcfg.vision.input_spatial
    params = JModel(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 24), jnp.int32),
        jnp.asarray(rs.randn(1, jcfg.num_chunks, d, h, w), jnp.float32),
        jnp.zeros((1, 6), jnp.int32))
    flat = _redraw(_flat(params), 8)
    ckpt = tmp_path / "mu2phi3"
    t_export.save_hf_checkpoint(str(ckpt), _tree(flat), jcfg)
    hf = json.loads((ckpt / "config.json").read_text())
    assert hf["model_type"] == "u2Phi3"
    from_hf = t_hf.u2_config_from_hf(hf)
    assert dataclasses.asdict(from_hf) == dataclasses.asdict(
        j_hf.u2_config_from_hf(hf))
    assert dataclasses.asdict(from_hf.llm) == dataclasses.asdict(jcfg.llm)

    for i in range(2):
        write_nifti(str(tmp_path / f"case{i}.nii.gz"),
                    rs.uniform(-1000, 400, (40, 48, 36)).astype(np.float32))
    with open(tmp_path / "cases.jsonl", "w") as f:
        for i in range(2):
            f.write(json.dumps({"image": f"case{i}.nii.gz",
                                "question": "Please describe the findings",
                                "answer": "clear lungs"}) + "\n")
    loaded = []
    init_or_load = t_cli._init_or_load

    def spy(*a, **kw):
        loaded.append(init_or_load(*a, **kw))
        return loaded[-1]

    common = ["--base-path", str(tmp_path), "--jsonl-path", "cases.jsonl",
              "--max-length", "64", "--max-new-tokens", "6",
              "--tokenizer", "mock", "--checkpoint", str(ckpt)]
    t_cli._init_or_load = spy
    try:
        _run(["generate", *common, "--device", "cpu", "--output",
              str(tmp_path / "port.jsonl")], tokenizer=MockTokenizer())
    finally:
        t_cli._init_or_load = init_or_load
    model = loaded[0]
    assert dataclasses.asdict(model.cfg) == dataclasses.asdict(jcfg)
    want = flatten(j_hf.convert_u2_checkpoint(
        j_hf.load_safetensors_dir(str(ckpt)), jcfg))
    got = flatten(flax_params(model))
    assert sorted(got) == sorted(want)
    for k in want:
        w = torch.from_numpy(np.asarray(want[k], np.float32))
        if w.dim() >= 2:
            w = w.bfloat16().float()
        np.testing.assert_array_equal(got[k], w.numpy(), err_msg=k)

    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(dataclasses.asdict(jcfg)))
    args = j_cli.build_parser().parse_args(
        ["generate", *common, "--config", str(cfg_path), "--output",
         str(tmp_path / "jax.jsonl")])
    args.fn(args)
    port = [json.loads(line) for line in open(tmp_path / "port.jsonl")]
    ref = [json.loads(line) for line in open(tmp_path / "jax.jsonl")]
    assert len(port) == 2 and port == ref
