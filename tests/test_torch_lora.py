"""The port's LoRA (``train/lora.py``, ``QDense``'s LoRA branch) against
the JAX package's, in fp32 on the CPU: the branch over float, int8 (plain
and out-tiled) and int4 bases, its output and the gradients of its
adapters; every function of ``train/lora.py`` on the same trees; and the
float-LoRA train step. Weights and adapters are carried from the JAX
package's trees (``weights.load_flax_params``); the port draws its own
adapters from a ``torch.Generator``, held to the same distribution by its
moments. Mirrors ``tests/test_lora.py`` and ``tests/test_qlora.py``.

Limits: the branch's output and gradients to 1e-5, relative and of their
largest element (fp32 sums of up to 256 products in another order, some
cancelling); ``apply_lora`` / ``merge_lora`` / ``merge_qlora`` to 1e-6
(one r-term product and an add); the merged model's logits to the adapted
ones' at the JAX test's 2e-4 (fp32 associativity through the decoder)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from u2tokenizer_torch.config import LLMConfig as TLLM
from u2tokenizer_torch.config import TrainConfig as TTrain
from u2tokenizer_torch.config import U2ModelConfig as TCfg
from u2tokenizer_torch.models import quantize as t_quant
from u2tokenizer_torch.models.llm.decoder import CausalLM as TLM
from u2tokenizer_torch.models.llm.decoder import QDense as TQDense
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.train import lora as t_lora
from u2tokenizer_torch.train import sft as t_sft
from u2tokenizer_torch.weights import flatten, flax_params, load_flax_params
from u2tokenizer_tpu.config import LLMConfig as JLLM
from u2tokenizer_tpu.config import TrainConfig as JTrain
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.models import quantize as j_quant
from u2tokenizer_tpu.models.llm.decoder import CausalLM as JLM
from u2tokenizer_tpu.models.llm.decoder import QDense as JQDense
from u2tokenizer_tpu.models.u2_model import U2CausalLM as JModel
from u2tokenizer_tpu.train import lora as j_lora
from u2tokenizer_tpu.train import sft as j_sft

pytestmark = pytest.mark.fast

RANK, ALPHA = 4, 8.0
IN, OUT = 256, 192  # two int4 groups of 128; OUT splits into 2 out-tiles


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


def _t(tree):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)),
                                  tree)


def _redraw_b(flat, seed, scale=0.05):
    """lora_b re-drawn from a numpy seed, so that the adapters matter."""
    rs = np.random.RandomState(seed)
    return {k: ((scale * rs.randn(*np.shape(v))).astype(np.float32)
                if k.endswith("lora_b") else np.array(v))
            for k, v in flat.items()}


# --------------------------------------------------- the QDense LoRA branch --

@pytest.mark.parametrize("tokens", [6, 160], ids=["decode", "prefill"])
@pytest.mark.parametrize("mode", ["float", "int8", "int8-tiled", "int4"])
def test_lora_branch_matches_flax(mode, tokens):
    """y = base(x) + (x @ lora_a @ lora_b) * alpha / r + bias over each base
    and both token regimes (int4: per-group partials under 128 tokens,
    dequantize-first from 128; int8 out-tiled from 128 tokens), and the
    gradients of lora_a and lora_b, against flax's QDense."""
    quant = {"float": False, "int8": "int8", "int8-tiled": "int8",
             "int4": "int4"}[mode]
    tiles = 2 if mode == "int8-tiled" else 0
    rs = np.random.RandomState(0)
    x = rs.randn(2, tokens // 2, IN).astype(np.float32)
    w = rs.randn(2, tokens // 2, OUT).astype(np.float32)
    fmod = JQDense(OUT, dtype=jnp.float32, lora_rank=RANK,
                   lora_scale=ALPHA / RANK)
    params = _redraw_b(flatten_dict(fmod.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x))["params"],
                                    sep="/"), 1)
    params["bias"] = (0.1 * rs.randn(OUT)).astype(np.float32)
    if quant:
        params = flatten_dict(j_quant.quantize_llm_weights(
            {"params": {"proj": unflatten_dict(params, sep="/")}}, quant)[
                "params"]["proj"], sep="/")
    jmod = JQDense(OUT, dtype=jnp.float32, quantized=quant, lora_rank=RANK,
                   lora_scale=ALPHA / RANK, out_tiles=tiles)
    tree = {"params": unflatten_dict({k: jnp.asarray(v)
                                      for k, v in params.items()}, sep="/")}

    def loss(ab):
        p = {"params": {**tree["params"], **ab}}
        return jnp.sum(jmod.apply(p, jnp.asarray(x)) * jnp.asarray(w))

    ab = {k: tree["params"][k] for k in ("lora_a", "lora_b")}
    y_ref = jmod.apply(tree, jnp.asarray(x))
    g_ref = jax.grad(loss)(ab)

    dense = TQDense(IN, OUT, True, torch.float32, "cpu", quant, tiles,
                    lora_rank=RANK, lora_scale=ALPHA / RANK)
    load_flax_params(dense, params)
    y = dense(torch.from_numpy(x))
    (y * torch.from_numpy(w)).sum().backward()
    for got, ref, what in ((y.detach(), y_ref, "y"),
                           (dense.lora_a.grad, g_ref["lora_a"], "lora_a"),
                           (dense.lora_b.grad, g_ref["lora_b"], "lora_b")):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=what)
    if quant:  # a quantized base takes no gradient
        assert dense.weight.grad is None


# ------------------------------------------------------------ the decoder --

@pytest.fixture(scope="module")
def float_lm():
    """(JAX config, float params (numpy flat), ids, embeddings) of the tiny
    decoder."""
    cfg = JLLM.tiny()
    model = JLM(cfg, dtype=jnp.float32)
    emb0 = jnp.zeros((2, 10, cfg.hidden_size), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), emb0,
                        jnp.zeros((2, 10), jnp.int32),
                        jnp.tril(jnp.ones((10, 10), bool))[None, None])
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 10))
    return cfg, _np(flatten_dict(params["params"], sep="/")), ids


def _lm_logits(model, ids):
    with torch.no_grad():
        return model(model.embed_tokens(torch.from_numpy(ids)),
                     torch.arange(10).expand(2, 10),
                     torch.ones(10, 10, dtype=torch.bool).tril()[None, None]
                     )[0]


def _jax_lparams(cfg, flat, mode, seed=7):
    """The JAX package's QLoRA tree (quantized base, fresh adapters) and
    its config."""
    qparams = j_quant.quantize_llm_weights(
        {"params": unflatten_dict(flat, sep="/")}, mode)
    qcfg = j_lora.qlora_config(cfg, rank=RANK, alpha=ALPHA, mode=mode)
    emb0 = jnp.zeros((2, 10, cfg.hidden_size), jnp.float32)
    lparams = j_lora.init_qlora_from_quantized(
        JLM(qcfg, dtype=jnp.float32), jax.random.PRNGKey(seed), qparams,
        emb0, jnp.zeros((2, 10), jnp.int32),
        jnp.tril(jnp.ones((10, 10), bool))[None, None])
    return qcfg, lparams


def _same(jcfg):
    return TLLM(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_qlora_identity_at_init(float_lm, mode):
    """The port's float decoder quantized in place and given fresh
    adapters (``init_qlora_from_quantized``) computes the plain quantized
    decoder's logits bit for bit (lora_b = 0), carries adapters on the
    same leaves as the JAX package's QLoRA tree, none on the embeddings or
    the head, and draws lora_a from N(0, 1/r)."""
    cfg, flat, ids = float_lm
    model = TLM(_same(cfg), dtype=torch.float32, device="cpu")
    load_flax_params(model, flat)
    t_quant.quantize_llm_weights(model, mode)
    base = _lm_logits(model, ids)
    qcfg = t_lora.qlora_config(model.cfg, RANK, ALPHA, mode)
    t_lora.init_qlora_from_quantized(model, qcfg,
                                     torch.Generator().manual_seed(3))
    assert model.cfg == qcfg and model.model.cfg == qcfg
    torch.testing.assert_close(_lm_logits(model, ids), base, rtol=0, atol=0)
    _, lparams = _jax_lparams(cfg, flat, mode)
    want = {k: np.shape(v) for k, v in flatten_dict(
        lparams["params"], sep="/").items()}
    got = {k: tuple(v.shape) for k, v in flatten(flax_params(model)).items()}
    assert got == want
    assert not any(("lm_head" in k or "embed" in k) and "lora" in k
                   for k in got)
    a = torch.cat([p.flatten() for n, p in model.named_parameters()
                   if n.endswith("lora_a")])
    # moments of ~13k draws: mean within 5 of its standard errors, the
    # standard deviation within 3 %
    assert abs(a.mean().item()) < 5 * RANK ** -0.5 / a.numel() ** 0.5
    assert abs(a.std().item() * RANK ** 0.5 - 1) < 0.03


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_merge_qlora_matches_jax(float_lm, mode):
    """``merge_qlora`` folds the adapters into dequantized fp32 weights as
    the JAX package's does (1e-6), and the merged float decoder gives the
    adapted decoder's logits (2e-4, the JAX test's limit)."""
    cfg, flat, ids = float_lm
    qcfg, lparams = _jax_lparams(cfg, flat, mode)
    lflat = _redraw_b(_np(flatten_dict(lparams["params"], sep="/")), 9)
    model = TLM(_same(qcfg), dtype=torch.float32, device="cpu")
    load_flax_params(model, lflat)
    adapted = _lm_logits(model, ids)
    t_lora.merge_qlora(model)
    assert not model.cfg.lora_rank and not model.cfg.quantized_weights
    want = flatten_dict(j_lora.merge_qlora(
        {"params": unflatten_dict(lflat, sep="/")}, qcfg)["params"], sep="/")
    got = flatten(flax_params(model))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    torch.testing.assert_close(_lm_logits(model, ids), adapted, rtol=2e-4,
                               atol=2e-4)


def test_quantize_preserves_adapters(float_lm):
    """Dequantizing and re-quantizing a decoder that carries adapters keeps
    them bit for bit (``test_quantize_preserves_adapters``)."""
    cfg, flat, _ = float_lm
    qcfg, lparams = _jax_lparams(cfg, flat, "int8")
    lflat = _redraw_b(_np(flatten_dict(lparams["params"], sep="/")), 4)
    model = TLM(_same(qcfg), dtype=torch.float32, device="cpu")
    load_flax_params(model, lflat)
    t_quant.quantize_llm_weights(t_quant.dequantize_llm_weights(model),
                                 "int8")
    got = flatten(flax_params(model))
    lora = [k for k in lflat if k.endswith(("lora_a", "lora_b"))]
    assert lora
    for k in lora:
        np.testing.assert_array_equal(got[k], lflat[k], err_msg=k)


# --------------------------------------------------------- μ² and float LoRA --

B, S = 2, 24


def _u2_setup():
    """The tiny μ² model in both packages from the JAX package's init, and
    a batch (``tests/test_lora.py``'s)."""
    jcfg = JCfg.tiny()
    rs = np.random.RandomState(0)
    d, h, w = jcfg.vision.input_spatial
    labels = rs.randint(0, jcfg.llm.vocab_size, (B, S)).astype(np.int32)
    labels[:, :4] = -100
    batch = {"input_ids": np.zeros((B, S), np.int32),
             "images": rs.randn(B, jcfg.num_chunks, d, h, w).astype(
                 np.float32),
             "question_ids": np.ones((B, 6), np.int32),
             "attention_mask": np.ones((B, S), np.int32), "labels": labels}
    jm = JModel(jcfg, dtype=jnp.float32)
    params = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(
        batch["input_ids"]), jnp.asarray(batch["images"]),
        jnp.asarray(batch["question_ids"])))
    tm = TModel(TCfg.from_dict(dataclasses.asdict(jcfg)),
                dtype=torch.float32, device="cpu")
    load_flax_params(tm, flatten(params))
    return jcfg, jm, params, tm, batch


@pytest.fixture(scope="module")
def u2():
    return _u2_setup()


def test_lora_functions_match_jax(u2):
    """``init_lora_params`` targets the JAX package's kernels (decoder
    only) with the same shapes; ``count_params`` counts as it does;
    ``apply_lora`` and ``merge_lora`` of the same adapters give its trees
    (1e-6); zero-init adapters leave the model's logits unchanged."""
    jcfg, jm, params, tm, batch = u2
    lcfg_j, lcfg_t = j_lora.LoraConfig(r=RANK, alpha=8), \
        t_lora.LoraConfig(r=RANK, alpha=8)
    jl = j_lora.init_lora_params(params, lcfg_j, jax.random.PRNGKey(1))
    tl = t_lora.init_lora_params(tm, lcfg_t, torch.Generator().manual_seed(1))
    assert {k: {n: tuple(np.shape(x)) for n, x in v.items()}
            for k, v in tl.items()} == \
        {k: {n: tuple(np.shape(x)) for n, x in v.items()}
         for k, v in jl.items()}
    assert all("llm" in p and "embed_tokens" not in p and "lm_head" not in p
               for p in tl)
    assert t_lora.count_params(tl) == j_lora.count_params(jl)
    assert t_lora.count_params(tm) == j_lora.count_params(params)
    assert all(float(ab["b"].abs().max()) == 0 for ab in tl.values())
    # the JAX package's adapters, b re-drawn, through both
    rs = np.random.RandomState(2)
    jl = {p: {"a": np.asarray(ab["a"]),
              "b": (0.05 * rs.randn(*np.shape(ab["b"]))).astype(np.float32)}
          for p, ab in jl.items()}
    want = flatten_dict(j_lora.apply_lora(params, jl, lcfg_j), sep="/")
    for fn in (t_lora.apply_lora, t_lora.merge_lora):
        got = flatten_dict(fn(_t(params), _t(jl), lcfg_t), sep="/")
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                       rtol=1e-6, atol=1e-6, err_msg=str(k))


def test_qlora_partition_matches_jax(u2):
    """``qlora_partition`` splits the port's QLoRA μ² model into the JAX
    package's trainable and frozen key sets, the trainable in fp32 and
    requiring gradients, the frozen with the JAX tree's dtypes; and
    ``qlora_merge_trees`` gives the whole tree back."""
    jcfg, jm, params, _, batch = u2
    qparams = j_quant.quantize_llm_weights(params, "int8")
    qcfg = j_lora.qlora_config(jcfg, rank=RANK, mode="int8")
    lparams = j_lora.init_qlora_from_quantized(
        JModel(qcfg, dtype=jnp.float32), jax.random.PRNGKey(7), qparams,
        jnp.asarray(batch["input_ids"]), jnp.asarray(batch["images"]),
        jnp.asarray(batch["question_ids"]))
    j_train, j_frozen = j_lora.qlora_partition(lparams)
    tm = TModel(TCfg.from_dict(dataclasses.asdict(qcfg)),
                dtype=torch.float32, device="cpu")
    load_flax_params(tm, flatten(_np(lparams)))
    train, frozen = t_lora.qlora_partition(tm)
    assert sorted(train) == sorted(j_train)
    assert sorted(frozen) == sorted(j_frozen)
    dtype = lambda x: str(x.dtype).replace("torch.", "")
    assert {k: dtype(v) for k, v in train.items()} == \
        {k: str(v.dtype) for k, v in j_train.items()}
    assert {k: dtype(v) for k, v in frozen.items()} == \
        {k: str(v.dtype) for k, v in j_frozen.items()}
    assert all(p.requires_grad for p in train.values())
    assert not any(p.requires_grad for p in frozen.values())
    merged = t_lora.qlora_merge_trees(train, frozen)
    assert sorted(flatten(merged)) == sorted(flatten(_np(lparams)))


def test_lora_training_learns_and_freezes_base(u2):
    """The float-LoRA step (``make_lora_train_step``) against the JAX
    package's over four steps of AdamW (lr 5e-3, no warmup): the same
    losses (1e-4, fp32 through the μ² stack), the frozen decoder kernel
    unchanged bit for bit, lora_b moved, and the merged model equal to the
    adapted one (1e-6)."""
    jcfg, jm, params, tm, batch = u2
    jl = j_lora.init_lora_params(params, j_lora.LoraConfig(r=RANK, alpha=8),
                                 jax.random.PRNGKey(1))
    jtx = j_sft.make_optimizer(JTrain(learning_rate=5e-3, warmup_ratio=0.0),
                               10)
    wrapped = {"lora": jl, "base": params}
    jstate = j_sft.TrainState(step=jnp.zeros((), jnp.int32), params=wrapped,
                              opt_state=jtx.init(wrapped))
    jstep = jax.jit(j_lora.make_lora_train_step(
        jm, jtx, j_lora.LoraConfig(r=RANK, alpha=8), j_sft.make_loss_fn(jm)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    lcfg = t_lora.LoraConfig(r=RANK, alpha=8)
    tl = {p: {k: torch.from_numpy(np.array(x)) for k, x in ab.items()}
          for p, ab in jl.items()}
    ttx = t_sft.Optimizer(t_lora.lora_leaves(tm, tl).values(),
                          t_sft.make_schedule(TTrain(learning_rate=5e-3,
                                                     warmup_ratio=0.0), 10),
                          weight_decay=TTrain().weight_decay)
    state = t_lora.LoraState(step=0, model=tm, lora=tl)
    step = t_lora.make_lora_train_step(tm, ttx, lcfg, t_sft.make_loss_fn())
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
          else torch.from_numpy(v) for k, v in batch.items()}
    kernel = "params/llm/model/layers_0/self_attn/q_proj/kernel"
    before = t_lora.named_leaves(tm)[kernel][1].detach().clone()
    losses, jlosses = [], []
    for _ in range(4):
        jstate, jm_ = jstep(jstate, jb)
        jlosses.append(float(jm_["loss"]))
        state, m = step(state, tb)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]
    torch.testing.assert_close(t_lora.named_leaves(tm)[kernel][1], before,
                               rtol=0, atol=0)
    b = next(ab["b"] for p, ab in state.lora.items() if "q_proj" in p)
    assert float(b.abs().sum()) > 0
    base = _t(flax_params(tm))
    with torch.no_grad():
        merged = t_lora.merge_lora(base, state.lora, lcfg)
        eff = t_lora.apply_lora(base, state.lora, lcfg)
    for k, v in flatten(merged).items():
        torch.testing.assert_close(v, flatten(eff)[k], rtol=1e-6, atol=1e-6)
