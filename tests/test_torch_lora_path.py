"""LoRA adapters folded in at load, ``U2InferenceModel(lora_path=)``, in the
port against the JAX package's, on the CPU.

A tiny μ² checkpoint written by the port (``test_torch_inference.py``'s
config and CT), and an adapter directory as the JAX package reads it:
``adapter.msgpack`` written with flax's ``msgpack_serialize``, adapters of
rank 4 on every target kernel (the JAX package's ``init_lora_params``)
with B drawn from a numpy seed so that every adapter moves the model, and
``adapter_config.json`` with alpha 8. Held:

  * weights fp32 (computing in fp32), bf16 and int8: the greedy tokens
    equal the JAX package's and, in fp32, the first step's logits within
    1e-4 (sums in other orders); in bf16 both fold the adapters in fp32
    and cast the same sums, and at int8 the quantized weights equal the
    JAX package's op-by-op quantization of the folded weights bit for bit
    (as ``test_torch_inference.test_int8_weights_match_jax``);
  * the adapters move the model (the logits move by over 1e-2 of the
    base's largest);
  * the port's ``save_lora_dir`` writes a directory that flax reads back
    leaf for leaf, bit for bit, and that folds in as the JAX one;
  * a directory without either file raises ``FileNotFoundError`` in both.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

from test_torch_inference import (KW, QUESTION, _config, _prefill_logits,
                                  _tokenizer, _volumes)
from u2tokenizer_torch.config import U2ModelConfig as TCfg
from u2tokenizer_torch.data.nifti import write_nifti
from u2tokenizer_torch.eval import inference as t_inf
from u2tokenizer_torch.models import hf_export as t_export
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.train import lora as t_lora
from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer as TTok
from u2tokenizer_torch.weights import flatten, flax_params
from u2tokenizer_tpu.eval.inference import U2InferenceModel as JInference
from u2tokenizer_tpu.models import generate as j_generate
from u2tokenizer_tpu.models import quantize as j_quant
from u2tokenizer_tpu.models.u2_model import U2CausalLM as JModel
from u2tokenizer_tpu.train import lora as j_lora
from u2tokenizer_tpu.utils.mock_tokenizer import MockTokenizer as JTok

pytestmark = pytest.mark.fast

RANK, ALPHA, B_STD = 4, 8, 0.05


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A checkpoint, a .nii.gz CT and the JAX-written adapter directory."""
    root = tmp_path_factory.mktemp("lora_path")
    jcfg = _config()
    tcfg = TCfg.from_dict(dataclasses.asdict(jcfg))
    ckpt = str(root / "ckpt")
    t_export.save_hf_checkpoint(ckpt, flax_params(TModel(
        tcfg, dtype=torch.float32, device="cpu", seed=3)), tcfg)
    rs = np.random.RandomState(0)
    vol = rs.normal(40.0, 200.0, (44, 40, 30))
    vol[:4], vol[:, :3] = -1000.0, -1000.0
    write_nifti(str(root / "ct.nii.gz"), vol.astype(np.int16))
    base = JInference(ckpt, tokenizer=JTok(), dtype=jnp.float32, **KW)
    lora = j_lora.init_lora_params(base.params,
                                   j_lora.LoraConfig(r=RANK, alpha=ALPHA),
                                   jax.random.PRNGKey(1))
    rs = np.random.RandomState(2)
    lora = {path: {"a": np.asarray(ab["a"]),
                   "b": (B_STD * rs.randn(*ab["b"].shape)).astype(
                       np.float32)}
            for path, ab in lora.items()}
    assert len(lora) == 7 * jcfg.llm.num_layers
    adapter = root / "adapter"
    adapter.mkdir()
    (adapter / "adapter.msgpack").write_bytes(
        serialization.msgpack_serialize(lora))
    (adapter / "adapter_config.json").write_text(
        json.dumps({"r": RANK, "alpha": ALPHA}))
    return root, jcfg, ckpt, str(adapter), lora


def _models(case, lora_path, weights="bf16", dtype="fp32"):
    root, jcfg, ckpt, _, _ = case
    vocab = jcfg.llm.vocab_size
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    jm = JInference(ckpt, tokenizer=_tokenizer(JTok, vocab), dtype=jdt,
                    lora_path=lora_path, **KW)
    tm = t_inf.U2InferenceModel(ckpt, tokenizer=_tokenizer(TTok, vocab),
                                dtype=tdt, device="cpu", weights=weights,
                                lora_path=lora_path, **KW)
    return jm, tm


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_lora_path_matches_jax(case, dtype):
    """weights="bf16" computing in fp32 or in bf16: the same greedy
    tokens as the JAX package's ``U2InferenceModel(lora_path=)``, and in
    fp32 the first step's logits within 1e-4; the adapters move the
    logits away from the base model's."""
    root, jcfg, ckpt, adapter, _ = case
    jm, tm = _models(case, adapter, dtype=dtype)
    jvol, tvol = _volumes(root, jcfg)
    assert tm.inference(tvol, QUESTION) == jm.inference(jvol, QUESTION)
    if dtype == "bf16":
        return
    out, ref = _prefill_logits(jm.model, jm.params, tm, jvol, tvol)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    base = t_inf.U2InferenceModel(ckpt, tokenizer=TTok(), dtype=torch.float32,
                                  device="cpu", **KW)
    plain, _ = _prefill_logits(jm.model, jm.params, base, jvol, tvol)
    assert np.abs(out - plain).max() > 1e-2 * np.abs(plain).max()


def test_lora_path_int8_matches_jax(case):
    """weights="int8": the decoder's weights equal the JAX package's
    op-by-op quantization of its folded, bf16-cast weights bit for bit,
    and the greedy tokens its model's on them."""
    root, jcfg, _, adapter, _ = case
    jm, tm = _models(case, adapter, weights="int8")
    params = j_quant.quantize_llm_weights(
        j_quant.cast_for_inference(jm.params), mode="int8")
    ours = flatten(flax_params(tm.model))
    theirs = traverse_util.flatten_dict(params["params"], sep="/")
    assert sorted(ours) == sorted(theirs)
    for key, value in ours.items():
        np.testing.assert_array_equal(value, np.asarray(theirs[key]),
                                      err_msg=key)
    jmodel = JModel(j_quant.quantized_llm_config(jcfg, "int8"),
                    dtype=jnp.float32)
    jvol, tvol = _volumes(root, jcfg)
    ids, qids, plen = tm._encode_prompt(QUESTION)
    ref = j_generate.make_multimodal_generate_fn(jmodel, jm.gen_cfg)(
        params, jnp.asarray(ids[None], jnp.int32), jnp.asarray(jvol[None]),
        jnp.asarray(qids[None], jnp.int32), jnp.asarray([plen], jnp.int32),
        jax.random.PRNGKey(0))
    np.testing.assert_array_equal(tm.generate_tokens(tvol, QUESTION).numpy(),
                                  np.asarray(ref)[0])


def test_port_writer_reads_back(case, tmp_path):
    """``save_lora_dir`` of the adapters read from the JAX directory:
    flax restores the file leaf for leaf, bit for bit, its config says
    the same r and alpha, and it folds in to the same model."""
    root, jcfg, ckpt, adapter, lora = case
    got, cfg = t_lora.load_lora_dir(adapter)
    assert (cfg.r, cfg.alpha) == (RANK, ALPHA)
    out = str(tmp_path / "adapter")
    t_lora.save_lora_dir(out, got, cfg)
    with open(os.path.join(out, "adapter.msgpack"), "rb") as f:
        back = serialization.msgpack_restore(f.read())
    assert sorted(back) == sorted(lora)
    for path, ab in lora.items():
        for key in ("a", "b"):
            assert back[path][key].dtype == np.float32
            np.testing.assert_array_equal(back[path][key], ab[key])
    with open(os.path.join(out, "adapter_config.json")) as f:
        assert json.load(f) == {"r": RANK, "alpha": ALPHA}
    kw = dict(tokenizer=TTok(), dtype=torch.float32, device="cpu", **KW)
    a = t_inf.U2InferenceModel(ckpt, lora_path=adapter, **kw).model
    b = t_inf.U2InferenceModel(ckpt, lora_path=out, **kw).model
    for (name, x), (_, y) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("missing", ["adapter.msgpack",
                                     "adapter_config.json"])
def test_missing_files_raise(case, tmp_path, missing):
    """A directory without either file raises ``FileNotFoundError`` in the
    port, as ``open`` does in the JAX package's ``_merge_lora``."""
    _, _, ckpt, adapter, _ = case
    broken = tmp_path / "adapter"
    shutil.copytree(adapter, broken)
    os.remove(broken / missing)
    with pytest.raises(FileNotFoundError):
        JInference(ckpt, tokenizer=JTok(), lora_path=str(broken), **KW)
    with pytest.raises(FileNotFoundError):
        t_inf.U2InferenceModel(ckpt, tokenizer=TTok(), device="cpu",
                               lora_path=str(broken), **KW)
