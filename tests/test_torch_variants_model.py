"""Whole models of the μ²tokenizer's ablation variants in the port against
the JAX package, on the tiny configuration in fp32 on the CPU: logits with
the 'rope' and 'vanilla' attentions, without the μ²tokenizer (the
LinVT-style baseline: the chunks' tokens concatenated), with the
'sequence' pooling and with the 'linear' and 'identity' projectors; the
raises where the JAX package misbehaves; ``save_hf_checkpoint`` of each
variant read back; and one SFT step's loss and gradients.

One set of JAX parameters (biases, relative-position tables and LayerNorm
scales re-drawn from a numpy seed) goes into both models; inputs come from
a numpy seed. Logits to 1e-4 through 2 ViT, 2+2 μ²tokenizer and 2 decoder
layers (as ``tests/test_torch_model.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_u2tok_variants import _pair
from u2tokenizer_torch.config import U2ModelConfig as TCfg
from u2tokenizer_torch.models import hf_export as t_export
from u2tokenizer_torch.models import hf_weights as t_hf
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.train import sft as t_sft
from u2tokenizer_torch.weights import (flatten, flax_params,
                                       load_flax_params, torch_name)
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.models import hf_weights as j_hf
from u2tokenizer_tpu.models.u2_model import U2CausalLM as JModel
from u2tokenizer_tpu.train import sft as j_sft

pytestmark = pytest.mark.fast

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
def _model_cfgs(**changes):
    """The tiny config with ``changes`` ({"u2t": {...}, "projector": {...},
    "vision": {...}} or top-level fields), for both packages."""
    jcfg = JCfg.tiny()
    for key, value in changes.items():
        if isinstance(value, dict):
            value = dataclasses.replace(getattr(jcfg, key), **value)
        jcfg = dataclasses.replace(jcfg, **{key: value})
    return jcfg, TCfg.from_dict(dataclasses.asdict(jcfg))


VARIANTS = {
    "rope": dict(u2t={"attn_type": "rope"}),
    "vanilla": dict(u2t={"attn_type": "vanilla"}),
    "linvt": dict(u2t={"enable": False}),
    "sequence": dict(projector={"pooling_type": "sequence"}),
    "linear": dict(projector={"projector_type": "linear"},
                   u2t={"attn_type": "rope"}),
    "identity": dict(projector={"projector_type": "identity"},
                     vision={"hidden_size": 128}),
}


def _model_pair(variant, s=24):
    jcfg, tcfg = _model_cfgs(**VARIANTS[variant])
    rs = np.random.RandomState(15)
    d, h, w = jcfg.vision.input_spatial
    inputs = {
        "ids": rs.randint(0, jcfg.llm.vocab_size, (2, s)).astype(np.int32),
        "images": rs.randn(2, jcfg.num_chunks, d, h, w).astype(np.float32),
        "qids": rs.randint(0, jcfg.llm.vocab_size, (2, 6)).astype(np.int32)}
    jm = JModel(jcfg, dtype=jnp.float32)
    tm = TModel(tcfg, dtype=torch.float32, device="cpu")
    params = _pair(jm, tm, inputs["ids"], inputs["images"], inputs["qids"])
    return jm, tm, params, inputs


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_model_logits(variant):
    """The whole model's logits with each variant, over a prompt that holds
    every image token (16 without the μ²tokenizer: 2 chunks of 8)."""
    jm, tm, params, inputs = _model_pair(variant)
    flat = flatten(params)
    assert ("u2tokenizer/query_tokens" in flat) == (variant != "linvt")
    assert any(k.startswith("mm_projector/") for k in flat) == (
        variant != "identity")
    assert any(k.endswith("relative_bias") for k in flat) == (
        variant in ("sequence", "identity"))  # 'rma' in those two
    ref, _, _ = jm.apply(params, *(jnp.asarray(inputs[k])
                                   for k in ("ids", "images", "qids")))
    with torch.no_grad():
        out, _, _ = tm(*(torch.from_numpy(inputs[k]).long()
                         if k != "images" else torch.from_numpy(inputs[k])
                         for k in ("ids", "images", "qids")))
    assert out.shape == ref.shape == (2, 24, tm.cfg.llm.vocab_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODEL_TOL)


def test_linvt_prompt_too_short_raises():
    """Known difference 14: without the μ²tokenizer 2 chunks give 16 image
    tokens; over a 12-token prompt the JAX splice lengthens the sequence
    to 17 rows, the port raises naming both counts."""
    jm, tm, params, inputs = _model_pair("linvt", s=12)
    ref, _, _ = jm.apply(params, *(jnp.asarray(inputs[k])
                                   for k in ("ids", "images", "qids")))
    assert ref.shape[1] == 17
    with pytest.raises(ValueError, match="16 image tokens.*12 tokens"):
        tm(torch.from_numpy(inputs["ids"]).long(),
           torch.from_numpy(inputs["images"]),
           torch.from_numpy(inputs["qids"]).long())


def test_identity_width_mismatch_raises():
    _, tcfg = _model_cfgs(projector={"projector_type": "identity"})
    with pytest.raises(ValueError, match="widths must be equal"):
        TModel(tcfg, dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("variant", ["rope", "vanilla", "linvt", "linear"])
def test_hf_checkpoint_round_trip(tmp_path, variant):
    """``save_hf_checkpoint`` of a port model of each variant, read back
    through its own config.json into a model of the same config that
    holds the same parameters; the JAX converter reads the same tree."""
    from u2tokenizer_torch.eval.inference import (load_model_config,
                                                  load_state_dict)

    _, tcfg = _model_cfgs(**VARIANTS[variant])
    tm = TModel(tcfg, dtype=torch.float32, device="cpu", seed=3)
    tree = flax_params(tm)
    t_export.save_hf_checkpoint(str(tmp_path), tree, tcfg)
    cfg = load_model_config(str(tmp_path))
    assert cfg == tcfg
    sd = load_state_dict(str(tmp_path))
    back = TModel(cfg, dtype=torch.float32, device="cpu", seed=4)
    load_flax_params(back, flatten(t_hf.convert_u2_checkpoint(sd, cfg)))
    for (name, a), (_, b) in zip(tm.named_parameters(),
                                 back.named_parameters()):
        assert torch.equal(a, b), name
    jcfg = JCfg.from_dict(dataclasses.asdict(cfg))
    j_tree = flatten(j_hf.convert_u2_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, jcfg))
    assert j_tree.keys() == flatten(tree).keys()


# One SFT step through one ViT, one μ²tokenizer and one decoder layer: the
# loss to 1e-5 and each parameter's gradient to 1e-3 of its largest
# element, with a floor of 1e-6 of the largest element of any gradient for
# the leaves whose gradient is rounding noise about zero (the key biases
# under 'rma' and 'vanilla': softmax ignores the q.b_k a row of scores
# shares).
GRAD_RTOL, GRAD_FLOOR = 1e-3, 1e-6


def _one_layer(**changes):
    jcfg, _ = _model_cfgs(**changes)
    jcfg = dataclasses.replace(
        jcfg, vision=dataclasses.replace(jcfg.vision, num_layers=1),
        u2t=dataclasses.replace(jcfg.u2t, num_layers=1),
        llm=dataclasses.replace(jcfg.llm, num_layers=1))
    return jcfg, TCfg.from_dict(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("variant", ["rope", "vanilla", "linvt"])
def test_sft_step_matches_jax(variant):
    """The loss of one batch (2 rows of 24 tokens, one valid for 19;
    labels over the text after the image rows) and the gradient of every
    parameter, JAX's ``value_and_grad`` of its SFT loss against the port's
    ``make_loss_fn`` and autograd."""
    jcfg, tcfg = _one_layer(**VARIANTS[variant])
    rs = np.random.RandomState(18)
    d, h, w = jcfg.vision.input_spatial
    n_img = jcfg.num_chunks * jcfg.proj_out_num if variant == "linvt" \
        else jcfg.proj_out_num
    ids = rs.randint(0, jcfg.llm.vocab_size, (2, 24)).astype(np.int32)
    mask = (np.arange(24)[None, :] < np.array([[24], [19]])).astype(np.int32)
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    labels[:, :1 + n_img] = -100
    batch = {"input_ids": ids, "labels": labels, "attention_mask": mask,
             "images": rs.randn(2, jcfg.num_chunks, d, h, w).astype(
                 np.float32),
             "question_ids": rs.randint(0, jcfg.llm.vocab_size,
                                        (2, 6)).astype(np.int32)}
    jm = JModel(jcfg, dtype=jnp.float32)
    tm = TModel(tcfg, dtype=torch.float32, device="cpu")
    params = _pair(jm, tm, ids, batch["images"], batch["question_ids"])
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        j_sft.make_loss_fn(jm), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
          else torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = t_sft.make_loss_fn()(tm, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    want = flatten(jax.tree_util.tree_map(np.asarray, j_grads))
    floor = GRAD_FLOOR * max(np.abs(g).max() for g in want.values())
    modules, params_t = dict(tm.named_modules()), dict(tm.named_parameters())
    assert len(want) == len(params_t)
    for path, g in want.items():
        name, transpose = torch_name(path, modules)
        grad = params_t[name].grad  # None: no path (hard top-k's scores)
        got = np.zeros(g.shape[::-1] if transpose else g.shape,
                       np.float32) if grad is None else grad.numpy()
        got = got.T if transpose else got
        np.testing.assert_allclose(
            got, g, rtol=0, atol=GRAD_RTOL * np.abs(g).max() + floor,
            err_msg=path)
