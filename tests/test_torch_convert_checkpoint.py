"""``cli convert-checkpoint`` and the converted checkpoint form in the port
against the JAX package's, on the CPU.

A tiny μ² model (drawn by the port, its biases re-drawn so that every
parameter matters)
exported by ``save_hf_checkpoint`` as a released checkpoint is laid out
(``model.safetensors`` + ``config.json``), converted by each package's
command. Held:

  * the printed line ({params, source_tensors, output}) and
    ``u2_config.json``, equal as JSON;
  * each package's ``u2_params.msgpack`` restores in the other leaf for
    leaf, bit for bit (flax's ``msgpack_restore`` of the port's file, the
    port's ``load_params_msgpack`` of the JAX file), and the trees hold
    the converter's numbers;
  * ``generate --checkpoint <converted>`` (the checkpoint's own config,
    read from ``u2_config.json``) gives the tokens of ``generate
    --checkpoint`` on the HF directory, and those of the JAX CLI on the
    converted directory.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

from u2tokenizer_torch import cli as t_cli
from u2tokenizer_torch.config import U2ModelConfig as TCfg
from u2tokenizer_torch.data.nifti import write_nifti
from u2tokenizer_torch.eval.inference import load_model_config
from u2tokenizer_torch.models import hf_export as t_export
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.train.checkpoint import load_params_msgpack
from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer
from u2tokenizer_torch.weights import flatten, flax_params
from u2tokenizer_tpu import cli as j_cli
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.models import hf_weights as j_hf

pytestmark = pytest.mark.fast


def _run(cli, argv, **kw):
    args = cli.build_parser().parse_args(argv)
    return args.fn(args, **kw)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The HF directory, both packages' converted directories (with their
    printed lines), two CTs and a jsonl of cases."""
    root = tmp_path_factory.mktemp("convert")
    jcfg = JCfg.tiny()
    rs = np.random.RandomState(7)
    flat = flatten(flax_params(TModel(TCfg.tiny(), dtype=torch.float32,
                                      device="cpu", seed=3)))
    for k, v in flat.items():
        if k.endswith(("bias", "relative_bias", "cls_token")):
            flat[k] = (0.1 * rs.randn(*v.shape)).astype(np.float32)
    hf = str(root / "hf")
    # the vision tower's and the μ²tokenizer's sizes in config.json, as
    # the port's emitted configs carry them (convert-checkpoint reads
    # config.json alone; generate on this directory reads the exporter's
    # u2_tpu_config.json)
    v = jcfg.vision
    t_export.save_hf_checkpoint(
        hf, {"params": traverse_util.unflatten_dict(flat, sep="/")}, jcfg,
        extra_config={"vision_num_layers": v.num_layers,
                      "vision_mlp_dim": v.mlp_dim,
                      "vision_num_heads": v.num_heads,
                      "vision_qkv_bias": v.qkv_bias,
                      "u2t_max_seq_len": jcfg.u2t.max_seq_len})
    lines = {}
    for name, cli in (("port", t_cli), ("jax", j_cli)):
        argv = ["convert-checkpoint", "--hf-dir", hf, "--output",
                str(root / name), "--num-chunks", str(jcfg.num_chunks)]
        if cli is t_cli:
            lines[name] = _run(cli, argv)
        else:
            _run(cli, argv)
    for i in range(2):
        write_nifti(str(root / f"case{i}.nii.gz"),
                    rs.uniform(-1000, 400, (40, 48, 36)).astype(np.float32))
    with open(root / "cases.jsonl", "w") as f:
        for i in range(2):
            f.write(json.dumps({"image": f"case{i}.nii.gz",
                                "question": "Please describe the findings",
                                "answer": "clear lungs"}) + "\n")
    return root, jcfg, hf, lines


def test_config_and_line_match_jax(case, capsys):
    """``u2_config.json`` equal as JSON, the config the port reads from it
    the JAX one, and the printed line the JAX command's."""
    root, jcfg, hf, lines = case
    port = json.loads((root / "port" / "u2_config.json").read_text())
    jax_cfg = json.loads((root / "jax" / "u2_config.json").read_text())
    assert port == jax_cfg
    assert dataclasses.asdict(load_model_config(str(root / "port"))) == \
        dataclasses.asdict(jcfg)
    args = j_cli.build_parser().parse_args(
        ["convert-checkpoint", "--hf-dir", hf, "--output",
         str(root / "jax_again"), "--num-chunks", str(jcfg.num_chunks)])
    capsys.readouterr()
    args.fn(args)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert lines["port"] == dict(want, output=str(root / "port"))


def test_params_restore_across_packages(case):
    """Each package's file read by the other package's reader: the same
    paths, dtypes and bits; and the JAX converter's numbers."""
    root, jcfg, hf, _ = case
    with open(root / "port" / "u2_params.msgpack", "rb") as f:
        port_by_flax = flatten(serialization.msgpack_restore(f.read()))
    jax_by_port = flatten(load_params_msgpack(
        str(root / "jax" / "u2_params.msgpack")))
    want = flatten(j_hf.convert_u2_checkpoint(
        j_hf.load_safetensors_dir(hf), jcfg))
    assert sorted(port_by_flax) == sorted(jax_by_port) == sorted(want)
    for k, ref in want.items():
        ref = np.asarray(ref)
        a, b = np.asarray(port_by_flax[k]), jax_by_port[k].numpy()
        assert a.dtype == b.dtype == ref.dtype, k
        np.testing.assert_array_equal(a, ref, err_msg=k)
        np.testing.assert_array_equal(b, ref, err_msg=k)


def test_generate_on_converted_checkpoint(case):
    """The port's ``generate`` on the converted directory (its own
    config) gives the predictions it gives on the HF directory, and the
    JAX CLI's on the converted directory (given the same config)."""
    root, jcfg, hf, _ = case
    common = ["generate", "--base-path", str(root), "--jsonl-path",
              "cases.jsonl", "--max-length", "64", "--max-new-tokens", "6",
              "--num-samples", "1", "--tokenizer", "mock"]
    outs = {}
    for name, ckpt in (("converted", root / "port"), ("hf", hf)):
        outs[name] = str(root / f"port_{name}.jsonl")
        _run(t_cli, [*common, "--checkpoint", str(ckpt), "--device", "cpu",
                     "--output", outs[name]], tokenizer=MockTokenizer())
    cfg_path = root / "cfg.json"
    cfg_path.write_text(json.dumps(dataclasses.asdict(jcfg)))
    outs["jax"] = str(root / "jax.jsonl")
    _run(j_cli, [*common, "--checkpoint", str(root / "port"), "--config",
                 str(cfg_path), "--output", outs["jax"]])
    rows = {name: [json.loads(line) for line in open(path)]
            for name, path in outs.items()}
    assert len(rows["converted"]) == 2
    assert rows["converted"] == rows["hf"] == rows["jax"]
    assert all(r["predictions"][0] for r in rows["converted"])
