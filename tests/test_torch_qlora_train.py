"""QLoRA training of a tiny μ²Phi-3-shaped model (the default μ² stack on a
Phi-3 decoder with heads of 96) in the port against the JAX package, on
the CPU:

  * three train steps of ``make_qlora_train_step`` with the JAX CLI's
    optimizer routing (AdamW on the adapters, Adafactor on the μ²tokenizer
    and projector) and schedule, int8 and int4 bases, in fp32: the losses
    and gradient norms, every trainable leaf's change, and the frozen
    leaves bit for bit;
  * ``cli train --qlora`` against the JAX CLI: ``test_torch_qlora_cli.py``.

Both sides start from the JAX package's adapters (the port's own are drawn
from a ``torch.Generator``, known difference 5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from test_torch_phi import SHAPES, _redraw
from u2tokenizer_torch.config import TrainConfig as TTrain
from u2tokenizer_torch.config import U2ModelConfig as TCfg
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.train import lora as t_lora
from u2tokenizer_torch.train import sft as t_sft
from u2tokenizer_torch.weights import flatten, load_flax_params, torch_name
from u2tokenizer_tpu.config import LLMConfig as JLLM
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.models import quantize as j_quant
from u2tokenizer_tpu.models.u2_model import U2CausalLM as JModel
from u2tokenizer_tpu.train import lora as j_lora
from u2tokenizer_tpu.train import sft as j_sft

pytestmark = pytest.mark.fast

RANK, ALPHA, LR, TOTAL = 4, 8.0, 1e-3, 4
B, S = 2, 24
# the μ²tokenizer's aggregator: its gradient reaches the loss only through
# the μ²tokenizer's attention softmaxes and agrees with the JAX package's
# to ~1e-3 of its norm in fp32 (measured 9.4e-4), which the optimizers'
# per-element normalisation magnifies in its change (measured 1.1e-2)
AGGREGATOR = "u2tokenizer/tta_module"


def _phi3_cfg():
    """μ²Phi-3 cut to one ViT and one μ²tokenizer layer, the tiny Phi-3
    decoder of ``test_torch_phi.py`` (2 layers, 2 heads of 96)."""
    base = JCfg.tiny()
    return dataclasses.replace(
        base, vision=dataclasses.replace(base.vision, num_layers=1),
        u2t=dataclasses.replace(base.u2t, num_layers=1),
        llm=SHAPES["phi3"](JLLM))


def _batch(cfg):
    rs = np.random.RandomState(0)
    d, h, w = cfg.vision.input_spatial
    ids = rs.randint(0, cfg.llm.vocab_size, (B, S)).astype(np.int32)
    mask = (np.arange(S)[None, :] < np.array([[S], [19]])).astype(np.int32)
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    labels[:, :1 + cfg.proj_out_num + 2] = -100
    return {"input_ids": ids, "labels": labels, "attention_mask": mask,
            "images": rs.randn(B, cfg.num_chunks, d, h, w).astype(
                np.float32),
            "question_ids": rs.randint(0, cfg.llm.vocab_size, (B, 6)).astype(
                np.int32)}


def _jax_tx():
    """The JAX CLI's optimizer (``u2tokenizer_tpu/cli.py:254-262``)."""
    schedule = optax.warmup_cosine_decay_schedule(0.0, LR, 1, TOTAL)
    return optax.multi_transform(
        {"lora": optax.adamw(schedule, weight_decay=0.0),
         "full": optax.adafactor(schedule, min_dim_size_to_factor=128)},
        lambda tree: {k: ("lora" if k.endswith(("/lora_a", "/lora_b"))
                          else "full") for k in tree})


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_qlora_train_steps_match_jax(mode):
    """Three steps from the same quantized base, adapters (lora_b re-drawn,
    so that every adapter has a gradient from the first step) and batch:
    loss and grad_norm at each step within 1e-4 (fp32 through the μ²
    stack, sums in another order); each trainable leaf's change element
    by element within 5e-3 of its largest element (the aggregator's 2e-2,
    AGGREGATOR) but for at most 1 % of them, and every element within
    twice the optimizer's reach over the steps: AdamW and Adafactor divide
    each gradient element by its own root mean square, so an element
    whose gradient is near zero, where fp32 rounding sets its sign, takes
    a step of up to lr (AdamW) in either direction in each package. The
    μ²tokenizer's key biases, whose gradient is zero in exact arithmetic
    and rounding noise in both, are held to the reach alone. The frozen
    leaves stay unchanged bit for bit."""
    jcfg = _phi3_cfg()
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JModel(jcfg, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jb["input_ids"], jb["images"],
                     jb["question_ids"])
    flat = _redraw({k: np.array(v) for k, v in flatten_dict(
        params["params"], sep="/").items()}, 1)
    qparams = j_quant.quantize_llm_weights(
        {"params": unflatten_dict(flat, sep="/")}, mode)
    qcfg = j_lora.qlora_config(jcfg, rank=RANK, alpha=ALPHA, mode=mode)
    qmodel = JModel(qcfg, dtype=jnp.float32, remat=True)
    lparams = j_lora.init_qlora_from_quantized(
        qmodel, jax.random.PRNGKey(7), qparams, jb["input_ids"],
        jb["images"], jb["question_ids"])
    rs = np.random.RandomState(2)
    lflat = {k: ((0.02 * rs.randn(*v.shape)).astype(np.float32)
                 if k.endswith("lora_b") else np.array(v))
             for k, v in flatten_dict(lparams, sep="/").items()}
    j_train, j_frozen = j_lora.qlora_partition(
        unflatten_dict(lflat, sep="/"))
    tx = _jax_tx()
    j_opt = tx.init(j_train)
    j_step = jax.jit(j_lora.make_qlora_train_step(
        tx, j_sft.make_loss_fn(qmodel)))

    tm = TModel(TCfg.from_dict(dataclasses.asdict(qcfg)),
                dtype=torch.float32, device="cpu", remat=True)
    load_flax_params(tm, flatten(unflatten_dict(lflat, sep="/")))
    train, frozen = t_lora.qlora_partition(tm)
    assert sorted(train) == sorted(j_train)
    before = {k: p.detach().clone() for k, p in frozen.items()}
    start = {k: p.detach().clone() for k, p in train.items()}
    t_tx = t_lora.QLoraOptimizer(train, t_sft.make_schedule(
        TTrain(learning_rate=LR, warmup_ratio=0.0), TOTAL))
    t_step = t_lora.make_qlora_train_step(t_tx, t_sft.make_loss_fn())
    tb = {k: torch.from_numpy(v).long() if k.endswith("ids") or
          k == "labels" else torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for _ in range(3):
        j_train, j_opt, j_loss, _, j_norm = j_step(j_train, j_opt, j_frozen,
                                                   jb)
        loss, _, norm = t_step(train, tm, tb)
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-4)
        np.testing.assert_allclose(float(norm), float(j_norm), rtol=1e-4)
        losses.append(loss.item())
    assert losses[-1] < losses[0]
    for k, p in frozen.items():
        assert torch.equal(p, before[k]), k
    noise = [k for k in train if k.endswith("wk/bias")]
    assert noise
    lr_sum = sum(t_sft.make_schedule(TTrain(learning_rate=LR,
                                            warmup_ratio=0.0), TOTAL)(i)
                 for i in range(3))
    modules, moved = dict(tm.named_modules()), 0
    for k, p in train.items():
        _, transpose = torch_name(k[len("params/"):], modules)
        flax = (lambda x: x.t()) if transpose else (lambda x: x)
        d_got = flax(p.detach() - start[k]).numpy()
        d_want = np.asarray(j_train[k]) - flax(start[k]).numpy()
        if not np.any(d_want):  # no path to the loss (the top-k's scores)
            assert not np.any(d_got), k
            continue
        moved += 1
        diff = np.abs(d_got - d_want)
        if t_lora.is_adapter(k):  # AdamW: at most 1.0015 lr a step
            reach = 2.01 * lr_sum
        else:  # Adafactor: a step's block rms within lr times p's
            rms = max(float(start[k].pow(2).mean().sqrt()), 1e-3)
            reach = 2.01 * lr_sum * rms * d_want.size ** 0.5
        assert diff.max() <= reach, (k, diff.max())
        if k not in noise:
            rel = 2e-2 if AGGREGATOR in k else 5e-3
            frac = np.mean(diff > rel * np.abs(d_want).max())
            assert frac <= 0.01, (k, frac)
    assert moved >= len(train) - 2
