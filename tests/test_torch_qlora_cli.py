"""``cli train --qlora int8 --tiny`` from files in the port against the
JAX package's CLI on the same checkpoint and data, on the CPU: the
``qlora_adapters.msgpack`` files (keys, dtypes, values) and a checkpoint
that holds the trainable leaves and the optimizer state and no frozen
leaf. The train step itself is held at fp32 by
``test_torch_qlora_train.py``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from flax.traverse_util import flatten_dict, unflatten_dict

from test_torch_phi import _redraw
from u2tokenizer_torch import cli as t_cli
from u2tokenizer_torch.data.nifti import write_nifti
from u2tokenizer_torch.models import hf_export as t_export
from u2tokenizer_torch.train import lora as t_lora
from u2tokenizer_torch.train.checkpoint import STATE_FILE, load_params_msgpack
from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer
from u2tokenizer_tpu import cli as j_cli
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.models.u2_model import U2CausalLM as JModel
from u2tokenizer_tpu.train import lora as j_lora

pytestmark = pytest.mark.fast

# the CLI run's learning rates: warmup 1 of 3 steps, peak 1e-3, cosine
LR_SUM = 0.0 + 1e-3 + 0.5e-3


def _adapter_leaves(tree) -> dict:
    return flatten_dict(tree, sep="/")


def test_cli_train_qlora_matches_the_jax_cli(tmp_path, monkeypatch):
    """``cli train --qlora int8 --tiny`` from files, port and JAX package,
    on one HF-layout checkpoint (seeded weights written by
    ``save_hf_checkpoint``), one case and the CLI's defaults (rank 16,
    alpha 32, bf16 compute, B=1) at lr 1e-3, 3 steps. The port's
    adapters start from the JAX CLI's draw (``fold_in(PRNGKey(seed),
    1)``); the augmentations are off in both (they draw from different
    generators; ``test_torch_transforms.py`` holds them on scripted
    draws). One case, so that the loaders' orders cannot differ (known
    difference 10). The adapters files have the same keys and dtypes
    (fp32 adapters, the μ²tokenizer and projector in bf16), and values
    within bf16 training's reach. The two runs' bf16 gradients differ in
    their last bits; the optimizers divide each element by its own root
    mean square, so where a gradient is tiny that noise sets the step:
      * adapters: AdamW's first two steps move an element by at most
        1.0015 lr each, in the sign of its gradient, which the noise may
        flip: every element within 2 bf16 ulps of the leaf's largest plus
        2.01 times the sum of the learning rates (LR_SUM), at most 2 %
        beyond 2 ulps and a tenth of that sum (measured 1.9 %);
      * the μ²tokenizer and projector (bf16): at most 0.5 % of the
        elements beyond 2 ulps (measured 0.04 %), and the error's root
        mean square within 2 LR_SUM times the leaf's (Adafactor keeps
        each step's root mean square within lr times the parameter's).
    The port's checkpoint holds the trainable leaves and the optimizer
    state, and no frozen leaf."""
    from u2tokenizer_torch.data import transforms as t_tf
    from u2tokenizer_tpu.data import transforms as j_tf

    jcfg = JCfg.tiny()
    rs = np.random.RandomState(7)
    d, h, w = jcfg.vision.input_spatial
    ids = jnp.zeros((1, 64), jnp.int32)
    images = jnp.asarray(rs.randn(1, jcfg.num_chunks, d, h, w), jnp.float32)
    qids = jnp.zeros((1, 6), jnp.int32)
    params = JModel(jcfg, dtype=jnp.float32).init(jax.random.PRNGKey(3), ids,
                                                   images, qids)
    flat = _redraw({k: np.array(v) for k, v in flatten_dict(
        params["params"], sep="/").items()}, 8)
    ckpt = tmp_path / "ckpt"
    t_export.save_hf_checkpoint(str(ckpt), {"params": unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})},
        jcfg)
    write_nifti(str(tmp_path / "case0.nii.gz"),
                rs.uniform(-1000, 400, (40, 48, 36)).astype(np.float32))
    (tmp_path / "cases.jsonl").write_text(json.dumps(
        {"image": "case0.nii.gz", "question": "Please describe the findings",
         "answer": "the lungs are clear without focal consolidation"}) + "\n")
    monkeypatch.setattr(j_tf, "apply_augmentations", lambda x, rng, cfg: x)
    monkeypatch.setattr(t_tf, "apply_augmentations", lambda x, dr, cfg: x)

    # the JAX CLI's adapters: model.init from fold_in(PRNGKey(seed), 1)
    qcfg = j_lora.qlora_config(jcfg, rank=16, alpha=32.0, mode="int8")
    start = {k: np.array(v) for k, v in flatten_dict(
        JModel(qcfg, dtype=jnp.bfloat16, remat=True).init(
            jax.random.fold_in(jax.random.PRNGKey(42), 1), ids, images,
            qids, attention_mask=jnp.ones((1, 64), jnp.int32)),
        sep="/").items() if k.endswith(("lora_a", "lora_b"))}
    draw = t_lora.init_qlora_from_quantized

    def carried(model, qcfg_, generator):
        draw(model, qcfg_, generator)
        leaves = t_lora.named_leaves(model)
        with torch.no_grad():
            for k, v in start.items():
                leaves[k][1].copy_(torch.from_numpy(v))
        return model

    monkeypatch.setattr(t_lora, "init_qlora_from_quantized", carried)
    common = ["train", "--tiny", "--tokenizer", "mock", "--train-base-path",
              str(tmp_path), "--train-jsonl-path", "cases.jsonl",
              "--pretrained", str(ckpt), "--qlora", "int8", "--max-steps",
              "3", "--batch-size", "1", "--max-length", "64",
              "--num-workers", "1", "--learning-rate", "1e-3"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    args = j_cli.build_parser().parse_args(common + ["--output-dir", jout])
    args.fn(args)
    args = t_cli.build_parser().parse_args(common + ["--output-dir", tout,
                                                     "--device", "cpu"])
    state = args.fn(args, tokenizer=MockTokenizer())
    assert state.step == 3

    with open(os.path.join(jout, "qlora_adapters.msgpack"), "rb") as f:
        want = _adapter_leaves(serialization.msgpack_restore(f.read()))
    got = _adapter_leaves(load_params_msgpack(
        os.path.join(tout, "qlora_adapters.msgpack")))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k]
        adapter = k.endswith(("lora_a", "lora_b"))
        assert str(g.dtype) == ("torch.float32" if adapter
                                else "torch.bfloat16"), k
        assert str(v.dtype) == ("float32" if adapter else "bfloat16"), k
        ref = np.asarray(v, np.float32)
        ulp = np.exp2(np.floor(np.log2(np.abs(ref).max() + 1e-30)) - 7)
        err = np.abs(g.float().numpy() - ref)
        if adapter:
            assert err.max() <= 2 * ulp + 2.01 * LR_SUM, (k, err.max())
            assert np.mean(err > 2 * ulp + 0.1 * LR_SUM) <= 0.02, k
        else:
            assert np.mean(err > 2 * ulp) <= 0.005, k
            rms = np.sqrt(np.mean(ref ** 2))
            assert np.sqrt(np.mean(err ** 2)) <= 2 * LR_SUM * rms, k
    saved = torch.load(os.path.join(tout, "checkpoints", "3", STATE_FILE),
                       map_location="cpu", weights_only=True)
    assert set(saved) == {"step", "train", "optimizer"}
    assert sorted(saved["train"]) == sorted(got)
    assert all(t_lora.qlora_trainable_path(k) for k in saved["train"])
    routed = set(saved["optimizer"]["adapters"]) | set(
        saved["optimizer"]["adafactor"]["v"])
    assert routed == set(saved["train"])


def test_cli_train_qlora_int4_resumes_from_its_checkpoint(tmp_path):
    """``cli train --qlora int4`` in the port: 2 steps, whose checkpoint
    holds the trainable leaves bit for bit (and the optimizer state);
    then the same command to 3 steps resumes from it, onto a base derived
    again from ``--pretrained`` by the same quantization, takes step 3 and
    writes the adapters file with the same leaves."""
    from u2tokenizer_torch.config import U2ModelConfig
    from u2tokenizer_torch.models.u2_model import U2CausalLM
    from u2tokenizer_torch.weights import flax_params

    cfg = U2ModelConfig.tiny()
    ckpt = str(tmp_path / "ckpt")
    t_export.save_hf_checkpoint(ckpt, flax_params(U2CausalLM(
        cfg, device="cpu", seed=3)), cfg)
    rs = np.random.RandomState(1)
    write_nifti(str(tmp_path / "case0.nii.gz"),
                rs.uniform(-1000, 400, (40, 48, 36)).astype(np.float32))
    (tmp_path / "cases.jsonl").write_text(json.dumps(
        {"image": "case0.nii.gz", "question": "What does this CT show",
         "answer": "a small effusion"}) + "\n")
    out = str(tmp_path / "out")

    def run(steps):
        args = t_cli.build_parser().parse_args(
            ["train", "--tiny", "--tokenizer", "mock", "--train-base-path",
             str(tmp_path), "--train-jsonl-path", "cases.jsonl",
             "--pretrained", ckpt, "--qlora", "int4", "--lora-rank", "4",
             "--max-steps", str(steps), "--save-steps", "1",
             "--batch-size", "1", "--max-length", "64", "--num-workers",
             "1", "--learning-rate", "1e-3", "--output-dir", out,
             "--device", "cpu"])
        return args.fn(args, tokenizer=MockTokenizer())

    first = run(2)
    assert first.step == 2 and first.model.cfg.llm.quantized_weights == "int4"
    at2 = {k: p.detach().clone() for k, p in first.train.items()}
    saved = torch.load(os.path.join(out, "checkpoints", "2", STATE_FILE),
                       map_location="cpu", weights_only=True)
    assert sorted(saved["train"]) == sorted(at2)
    for k, v in at2.items():
        assert torch.equal(saved["train"][k], v), k
    resumed = run(3)
    assert resumed.step == 3
    tree = load_params_msgpack(os.path.join(out, "qlora_adapters.msgpack"))
    assert sorted(flatten_dict(tree, sep="/")) == sorted(at2)
    moved = [k for k in at2 if not torch.equal(resumed.train[k], at2[k])]
    assert any(t_lora.is_adapter(k) for k in moved)
