"""The decoder's remat policies in the port against the JAX package's, in
fp32 on the CPU.

``U2CausalLM(cfg, remat=policy)`` with the policies "nothing"
(``nothing_saveable``), "dots_no_batch"
(``dots_with_no_batch_dims_saveable``) and "dots" (``dots_saveable``):

  * the SFT loss and every parameter's gradient against the JAX package's
    model under the same policy, on the tiny config of
    ``test_torch_train.py`` (one layer a stack);
  * the loss and the trainable leaves' gradients of a QLoRA step over an
    int8 and an int4 base against the JAX package's under each policy;
  * each policy against the port's own "nothing", to the limits of
    ``test_torch_train.test_remat_changes_no_gradient``: a policy changes
    what the backward recomputes, never a number;
  * which products the backward runs again, counted by a
    ``TorchDispatchMode`` against no remat at all: "dots" none,
    "dots_no_batch" only the batched ones (the plain attention's score
    and value products), "nothing" every one.

A remat policy changes no number in exact arithmetic, and in fp32 only
the order of XLA's and torch's sums differs: losses within 1e-5, each
gradient within 1e-5 of its largest element.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_train import (_batch, _cfg, _flax_flat, _port_model,
                              _torch_batch)
from u2tokenizer_torch.config import U2ModelConfig as TCfg
from u2tokenizer_torch.models import quantize as t_quant
from u2tokenizer_torch.models.llm.decoder import (MATMULS,
                                                  is_batched_product,
                                                  remat_policy)
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.train import lora as t_lora
from u2tokenizer_torch.train import sft as t_sft
from u2tokenizer_torch.weights import (flatten, flax_params,
                                       load_flax_params, torch_name)
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.models.u2_model import U2CausalLM as JModel
from u2tokenizer_tpu.train import lora as j_lora
from u2tokenizer_tpu.train import sft as j_sft

pytestmark = pytest.mark.fast

POLICIES = ("nothing", "dots_no_batch", "dots")
RTOL = 1e-5
# the μ²tokenizer's aggregator (its TTA layers and query tokens): its
# gradient reaches the loss only through the μ²tokenizer's attention
# softmaxes and agrees with the JAX package's to ~1e-3 of its largest
# element in fp32 under every policy and without remat (measured 1.5e-3;
# tests/test_torch_qlora_train.py holds it the same way); the key biases'
# gradients are zero in exact arithmetic and rounding noise in both, of a
# norm under NOISE of the largest gradient's (measured up to 1.9e-9, in the
# QLoRA steps)
AGGREGATOR = ("u2tokenizer/tta_module", "u2tokenizer/query_tokens")
AGGREGATOR_RTOL, NOISE = 2e-3, 1e-8
RANK, ALPHA = 4, 8.0


def _grads(model, batch, params):
    loss, _ = t_sft.make_loss_fn()(model, batch)
    return loss, torch.autograd.grad(loss, params, allow_unused=True,
                                     materialize_grads=True)


def _close(got, want, name, top):
    """``got`` against ``want`` within RTOL of its largest element; the
    aggregator's within AGGREGATOR_RTOL; a key bias's gradient, zero in
    exact arithmetic, of a norm under NOISE of ``top``, the largest
    gradient norm."""
    got, want = np.asarray(got), np.asarray(want)
    if name.endswith("wk/bias"):
        assert max(np.linalg.norm(got), np.linalg.norm(want)) < NOISE * top, \
            name
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    rtol = AGGREGATOR_RTOL if any(k in name for k in AGGREGATOR) else RTOL
    assert err <= rtol, (name, err)


def _jax_grads(cfg, params, batch, remat):
    jm = JModel(cfg, dtype=jnp.float32, remat=remat)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        j_sft.make_loss_fn(jm), has_aux=True))(params, jb)
    return float(loss), flatten_dict(grads["params"], sep="/")


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_jax(policy):
    """SFT loss and every parameter's gradient under ``policy`` against
    the JAX package's model under the same policy."""
    tm = _port_model(remat_policy(policy))
    flat = _flax_flat(tm)
    params = {"params": unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
    batch = _batch()
    j_loss, j_grads = _jax_grads(_cfg(JCfg), params, batch,
                                 True if policy == "nothing" else policy)
    loss, grads = _grads(tm, _torch_batch(batch), list(tm.parameters()))
    np.testing.assert_allclose(loss.item(), j_loss, rtol=RTOL)
    modules = dict(tm.named_modules())
    named = dict(zip((n for n, _ in tm.named_parameters()), grads))
    top = max(float(np.linalg.norm(g)) for g in j_grads.values())
    for path, want in j_grads.items():
        name, transpose = torch_name(path, modules)
        got = named[name].numpy()
        _close(got.T if transpose else got, want, path, top)


def _qlora_tree(tm, mode):
    """``tm`` (float, its weights drawn) quantized to ``mode`` in place
    with adapters of RANK and ALPHA, lora_b re-drawn from a numpy seed so
    that every adapter has a gradient: the same parameters for the JAX
    package as its flat tree {"params/...": array} (the port's
    quantization and packing are the JAX package's bit for bit,
    ``test_torch_quantize.py``)."""
    t_quant.quantize_llm_weights(tm, mode)
    t_lora.init_qlora_from_quantized(
        tm, t_lora.qlora_config(tm.cfg, RANK, ALPHA, mode),
        torch.Generator().manual_seed(7))
    flat = {k: np.array(v) for k, v in flatten_dict(
        flax_params(tm), sep="/").items()}
    rs = np.random.RandomState(2)
    for k, v in flat.items():
        if k.endswith("lora_b"):
            flat[k] = (0.02 * rs.randn(*v.shape)).astype(np.float32)
    load_flax_params(tm, flatten(unflatten_dict(flat, sep="/")))
    return flat


@functools.lru_cache(maxsize=None)
def _qlora_flat(mode):
    return _qlora_tree(_port_model(), mode)


def _qlora_models(mode, policy):
    """The same QLoRA model (``mode`` base, ``_qlora_tree``) in both
    packages under ``policy``."""
    lflat = _qlora_flat(mode)
    qcfg = j_lora.qlora_config(_cfg(JCfg), rank=RANK, alpha=ALPHA, mode=mode)
    jm = JModel(qcfg, dtype=jnp.float32,
                remat=True if policy == "nothing" else policy)
    tm = TModel(TCfg.from_dict(dataclasses.asdict(qcfg)),
                dtype=torch.float32, device="cpu", remat=policy)
    load_flax_params(tm, flatten(unflatten_dict(lflat, sep="/")))
    return jm, lflat, tm, _batch()


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_qlora_step_matches_jax(mode, policy):
    """A QLoRA step's loss and the gradient of every trainable leaf (the
    adapters, the μ²tokenizer and the projector) under ``policy`` against
    the JAX package's, over an int8 and an int4 base."""
    jm, lflat, tm, batch = _qlora_models(mode, policy)
    j_train, j_frozen = j_lora.qlora_partition(
        unflatten_dict(lflat, sep="/"))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_fn = j_sft.make_loss_fn(jm)
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda tf: loss_fn(j_lora.qlora_merge_trees(tf, j_frozen), jb),
        has_aux=True))(j_train)
    train, _ = t_lora.qlora_partition(tm)
    assert sorted(train) == sorted(j_train)
    loss, grads = _grads(tm, _torch_batch(batch), list(train.values()))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    modules = dict(tm.named_modules())
    top = max(float(np.linalg.norm(g)) for g in j_grads.values())
    for (path, _), got in zip(train.items(), grads):
        _, transpose = torch_name(path[len("params/"):], modules)
        got = got.t() if transpose else got
        _close(got.numpy(), j_grads[path], path, top)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_changes_no_gradient(policy):
    """Each policy's loss and gradients equal the port's own under
    "nothing", in the SFT step and in an int4 QLoRA step."""
    batch = _torch_batch(_batch())
    runs = {}
    for name in ("nothing", policy):
        tm = _port_model(name)
        runs[name] = _grads(tm, batch, list(tm.parameters()))
        *_, qm, _ = _qlora_models("int4", name)
        train, _ = t_lora.qlora_partition(qm)
        runs[name, "qlora"] = _grads(qm, batch, list(train.values()))
    for ref, got in ((runs["nothing"], runs[policy]),
                     (runs["nothing", "qlora"], runs[policy, "qlora"])):
        for a, b in zip([ref[0], *ref[1]], [got[0], *got[1]]):
            torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)


class _Products(TorchDispatchMode):
    """Counts the matrix products dispatched, batched and plain."""

    def __init__(self):
        super().__init__()
        self.counts = {"plain": 0, "batched": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in MATMULS:
            kind = "batched" if is_batched_product(func, args) else "plain"
            self.counts[kind] += 1
        return func(*args, **(kwargs or {}))


def _backward_products(model, batch, params):
    loss, _ = t_sft.make_loss_fn()(model, batch)
    mode = _Products()
    with mode:
        torch.autograd.grad(loss, params, allow_unused=True)
    return mode.counts


@pytest.mark.parametrize("qlora", [False, True])
def test_policy_recomputes_its_products(qlora):
    """The products the backward runs beyond those of no remat at all,
    the forward's run again: "dots" none, "dots_no_batch" only batched
    ones, "nothing" the plain ones too; and the decoder's forward has
    both kinds, so the counts tell the policies apart."""
    batch = _torch_batch(_batch())
    counts = {}
    for name in ("off", *POLICIES):
        if qlora:
            *_, model, _ = _qlora_models("int4", name)
            params = list(t_lora.qlora_partition(model)[0].values())
        else:
            model = _port_model(remat_policy(name))
            params = list(model.parameters())
        counts[name] = _backward_products(model, batch, params)
    off = counts["off"]
    extra = {name: {k: counts[name][k] - off[k] for k in off}
             for name in POLICIES}
    assert extra["dots"] == {"plain": 0, "batched": 0}
    assert extra["dots_no_batch"]["plain"] == 0
    assert extra["dots_no_batch"]["batched"] > 0
    assert extra["nothing"]["batched"] == extra["dots_no_batch"]["batched"]
    assert extra["nothing"]["plain"] > 0


def test_unknown_policy_raises():
    """"off" and False turn remat off, True is "nothing", and a name the
    JAX package does not know raises."""
    assert remat_policy("off") is None and remat_policy(False) is None
    assert remat_policy(True) == "nothing"
    with pytest.raises(ValueError):
        TModel(_cfg(TCfg), dtype=torch.float32, device="cpu",
               remat="everything")
