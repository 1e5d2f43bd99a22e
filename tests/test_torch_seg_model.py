"""The segmentation path of the whole model, the port against the JAX
package, in fp32 on the CPU: ``U2ModelConfig.tiny()`` with
``SegConfig.tiny()``.

One set of flax parameters (``init`` through ``forward_seg``, every bias
re-drawn from a numpy seed) goes into both models, the port's through
``load_flax_params``; inputs come from a numpy seed. Held: ``forward_seg``
and ``segment`` (1e-4, as tests/test_torch_model.py), the '[SEG]'
generate (tokens and has_seg equal, mask logits 1e-4) on a hit in the row
with a pad gap and on a miss, the joint loss (1e-5 relative) and each
parameter's gradient (1e-4 of the leaf's largest element, plus 1e-5 of the
largest gradient of the model for the leaves whose gradient is zero in
exact arithmetic), ``seg_positions_from_ids``, and the seeded draws of
every other parameter, unchanged bit for bit when the head is enabled.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from u2tokenizer_torch.config import GenerationConfig as TGen
from u2tokenizer_torch.config import U2ModelConfig as TCfg
from u2tokenizer_torch.models import generate as t_generate
from u2tokenizer_torch.models.layers import Dense
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.train import sft as t_sft
from u2tokenizer_torch.weights import flax_path, load_flax_params
from u2tokenizer_tpu.config import GenerationConfig as JGen
from u2tokenizer_tpu.config import SegConfig as JSeg
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.models import generate as j_generate
from u2tokenizer_tpu.models.u2_model import U2CausalLM as JModel
from u2tokenizer_tpu.train import sft as j_sft

pytestmark = pytest.mark.fast

TOL = dict(rtol=1e-4, atol=1e-4)
B, S, SQ = 2, 16, 4
PROMPT_LEN = np.array([16, 12], np.int32)
MAX_NEW = 5


def _sphere(shape):
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, n) for n in shape],
                          indexing="ij")
    return (z ** 2 + y ** 2 + x ** 2 < 0.4).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(JCfg.tiny(), seg=JSeg.tiny())
    tcfg = TCfg.from_dict(dataclasses.asdict(jcfg))
    rs = np.random.RandomState(0)
    d, h, w = jcfg.vision.input_spatial
    x = {
        "images": rs.randn(B, jcfg.num_chunks, d, h, w).astype(np.float32),
        "ids": rs.randint(3, jcfg.llm.vocab_size, (B, S)).astype(np.int32),
        "qids": rs.randint(3, jcfg.llm.vocab_size, (B, SQ)).astype(np.int32),
        "seg_image": rs.randn(B, 1, *jcfg.seg.image_size).astype(np.float32),
        "seg_positions": np.array([5, 3], np.int32),
    }
    jm = JModel(jcfg, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x["ids"]),
                     jnp.asarray(x["images"]), jnp.asarray(x["qids"]),
                     jnp.asarray(x["seg_image"]),
                     jnp.asarray(x["seg_positions"]), method="forward_seg")
    flat = {k: np.array(v) for k, v in
            traverse_util.flatten_dict(params["params"], sep="/").items()}
    for k in flat:
        if k.endswith(("bias", "cls_token")):
            flat[k] = (rs.randn(*flat[k].shape) * 0.1).astype(np.float32)
    params = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
    tm = TModel(tcfg, dtype=torch.float32, device="cpu")
    load_flax_params(tm, flat)
    return jm, params, tm, x


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(out, ref):
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref),
                               **TOL)


def test_forward_seg(pair):
    jm, params, tm, x = pair
    keys = ("ids", "images", "qids", "seg_image", "seg_positions")
    ref_logits, ref_masks = jm.apply(
        params, *[jnp.asarray(x[k]) for k in keys], method="forward_seg")
    with torch.no_grad():
        logits, masks = tm.forward_seg(*[_t(x[k]) for k in keys])
    assert masks.shape == x["seg_image"].shape
    _close(logits, ref_logits)
    _close(masks, ref_masks)


def test_segment_without_prompt(pair):
    jm, params, tm, x = pair
    ref = jm.apply(params, jnp.asarray(x["seg_image"]), None,
                   method="segment")
    with torch.no_grad():
        out = tm.segment(_t(x["seg_image"]), None)
    _close(out, ref)


def _jax_seg_generate(pair, seg_id):
    jm, params, _, x = pair
    jfn = j_generate.make_seg_generate_fn(
        jm, JGen(max_new_tokens=MAX_NEW, eos_token_id=-2), seg_id,
        cache_dtype=jnp.float32, jit=False)
    ref = jfn(params, jnp.asarray(x["ids"]), jnp.asarray(x["images"]),
              jnp.asarray(x["qids"]), jnp.asarray(PROMPT_LEN),
              jnp.asarray(x["seg_image"]), jax.random.PRNGKey(1))
    return [np.asarray(r) for r in ref]


def _seg_generate(pair, seg_id):
    _, _, tm, x = pair
    tfn = t_generate.make_seg_generate_fn(
        tm, TGen(max_new_tokens=MAX_NEW, eos_token_id=-2), seg_id,
        cache_dtype=torch.float32)
    return tfn(_t(x["ids"]), _t(x["images"]), _t(x["qids"]), _t(PROMPT_LEN),
               _t(x["seg_image"]))


@pytest.fixture(scope="module")
def refs(pair):
    """The JAX package's (tokens, logits, has_seg) for a miss (an id never
    emitted) and a hit: the id that greedy decoding emits first in row 1
    (prompt 12 of 16 rows, so the pad gap matters), as the JAX package's
    own test forces one; it must not be the row's last token, so that the
    state one row later exists."""
    miss = _jax_seg_generate(pair, -3)
    hit_id = int(miss[0][1, 0])
    assert list(miss[0][1]).index(hit_id) < MAX_NEW - 1
    return {"miss": (-3, miss), "hit": (hit_id,
                                        _jax_seg_generate(pair, hit_id))}


def test_seg_generate_miss(pair, refs):
    seg_id, (tokens, logits, has) = refs["miss"]
    t_tokens, t_logits, t_has = _seg_generate(pair, seg_id)
    np.testing.assert_array_equal(t_tokens.numpy(), tokens)
    assert not has.any() and not t_has.any()
    _close(t_logits, logits)


def test_seg_generate_hit(pair, refs):
    seg_id, (tokens, logits, has) = refs["hit"]
    t_tokens, t_logits, t_has = _seg_generate(pair, seg_id)
    np.testing.assert_array_equal(t_tokens.numpy(), tokens)
    np.testing.assert_array_equal(t_has.numpy(), has)
    assert has[1]
    _close(t_logits, logits)
    assert not np.allclose(logits[1], refs["miss"][1][1][1], **TOL)


def test_seg_generate_faults_show(pair, refs, monkeypatch):
    """The two faults the card's check plants each move the hit row's mask
    logits outside the tolerance: the '[SEG]' state one row late, and the
    pad gap left unmasked in the re-run."""
    hit_id, (_, logits, _) = refs["hit"]
    right_state = t_generate.seg_hidden_state
    right_layout = t_generate.teacher_forced_layout

    def late(hidden, tokens, s, seg_id):
        shifted = torch.cat([hidden[:, 1:], hidden[:, -1:]], dim=1)
        return right_state(shifted, tokens, s, seg_id)

    def gap_open(prompt_len, s, t):
        return right_layout(torch.full_like(prompt_len, s), s, t)

    for name, fault in (("seg_hidden_state", late),
                        ("teacher_forced_layout", gap_open)):
        with monkeypatch.context() as m:
            m.setattr(t_generate, name, fault)
            _, wrong, _ = _seg_generate(pair, hit_id)
        assert not np.allclose(wrong[1].numpy(), logits[1], **TOL), name


def _batch(pair, seg_token_id=7):
    jm, _, tm, x = pair
    cfg = tm.cfg
    ids = x["ids"].copy()
    ids[0, 5] = seg_token_id  # row 0 has a '[SEG]', row 1 none
    pos, has = t_sft.seg_positions_from_ids(ids, seg_token_id)
    labels = np.random.RandomState(3).randint(
        0, cfg.llm.vocab_size, (B, S)).astype(np.int64)
    labels[:, :4] = t_sft.IGNORE_INDEX
    target = np.broadcast_to(_sphere(cfg.seg.image_size)[None, None],
                             x["seg_image"].shape).copy()
    return {"input_ids": ids, "images": x["images"], "question_ids": x["qids"],
            "attention_mask": (np.arange(S)[None] < PROMPT_LEN[:, None]
                               ).astype(np.int32),
            "labels": labels, "seg_image": x["seg_image"], "seg": target,
            "seg_positions": pos, "has_seg": has}


def test_seg_positions_from_ids():
    ids = np.ones((3, 8), np.int32)
    ids[0, 5] = ids[0, 6] = 7
    ids[2, 0] = 7
    for fn in (t_sft.seg_positions_from_ids, j_sft.seg_positions_from_ids):
        pos, has = fn(ids, 7)
        np.testing.assert_array_equal(pos, [5, 0, 0])
        np.testing.assert_array_equal(has, [1.0, 0.0, 1.0])
        assert pos.dtype == np.int32 and has.dtype == np.float32


def _port_grads(tm, loss):
    modules = dict(tm.named_modules())
    names = [n for n, p in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()],
                                allow_unused=True, materialize_grads=True)
    out = {}
    for name, g in zip(names, grads):
        g = g.numpy()
        owner = modules.get(name.rsplit(".", 1)[0])
        if isinstance(owner, Dense) and g.ndim == 2:
            g = g.T
        out[flax_path(name, modules)[len("params/"):]] = g
    return out


@pytest.fixture(scope="module")
def jax_seg_grads(pair):
    """The JAX package's seg loss metrics and gradients on ``_batch``."""
    jm, params, _, _ = pair
    jloss = j_sft.make_seg_loss_fn(jm)
    (_, metrics), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in _batch(pair).items()})
    return metrics, grads


def test_seg_loss_and_gradients(pair, jax_seg_grads):
    _, _, tm, _ = pair
    ref_m, ref_g = jax_seg_grads
    batch = {k: _t(v) for k, v in _batch(pair).items()}
    loss, metrics = t_sft.make_seg_loss_fn()(tm, batch)
    for key in ("loss", "lm_loss", "seg_loss", "token_accuracy"):
        np.testing.assert_allclose(float(metrics[key]), float(ref_m[key]),
                                   rtol=1e-5)
    assert float(ref_m["seg_loss"]) > 0.1  # row 0's mask loss counts
    with torch.no_grad():
        weighted, _ = t_sft.make_seg_loss_fn(seg_weight=0.7)(tm, batch)
    np.testing.assert_allclose(
        float(weighted), float(ref_m["lm_loss"] + 0.7 * ref_m["seg_loss"]),
        rtol=1e-5)
    grads = _port_grads(tm, loss)
    ref_g = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        ref_g["params"], sep="/").items()}
    assert set(grads) == set(ref_g)
    assert any(k.startswith("seg_module/") for k in grads)
    top = max(np.abs(v).max() for v in ref_g.values())
    for k, g in grads.items():
        err = np.abs(g - ref_g[k]).max()
        assert err <= 1e-4 * np.abs(ref_g[k]).max() + 1e-5 * top, k


def test_seg_train_step_grad_norm_and_descent(pair, jax_seg_grads):
    """Three AdamW steps of ``make_seg_train_step`` on a copy: the first
    grad_norm is the global norm of the JAX gradients, and the joint loss
    and both of its parts fall."""
    jm, params, tm, x = pair
    from u2tokenizer_torch.config import TrainConfig

    tcfg = TCfg.from_dict(dataclasses.asdict(tm.cfg))
    model = TModel(tcfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(tm.state_dict())
    batch = {k: _t(v) for k, v in _batch(pair).items()}
    state, _ = t_sft.make_trainer(
        model, TrainConfig(learning_rate=1e-3, warmup_ratio=0.0,
                           lr_schedule="constant"), 10)
    step = t_sft.make_seg_train_step(model)
    ref_g = jax_seg_grads[1]
    loss_fn = t_sft.make_seg_loss_fn()
    with torch.no_grad():
        _, m0 = loss_fn(model, batch)
    norms = []
    for _ in range(3):
        state, metrics = step(state, batch)
        norms.append(float(metrics["grad_norm"]))
    np.testing.assert_allclose(norms[0], float(optax.global_norm(ref_g)),
                               rtol=1e-4)
    with torch.no_grad():
        _, m1 = loss_fn(model, batch)
    for key in ("loss", "lm_loss", "seg_loss"):
        assert float(m1[key]) < float(m0[key]), key
    assert state.step == 3


def test_enabling_seg_keeps_every_other_draw():
    base = TCfg.tiny()
    with_seg = dataclasses.replace(
        base, seg=TCfg.from_dict({"seg": dataclasses.asdict(JSeg.tiny())}).seg)
    plain = dict(TModel(base, dtype=torch.float32, device="cpu",
                        seed=3).named_parameters())
    seg = dict(TModel(with_seg, dtype=torch.float32, device="cpu",
                      seed=3).named_parameters())
    extra = set(seg) - set(plain)
    assert extra and all(n.startswith(("seg_module.", "seg_projector."))
                         for n in extra)
    for name, p in plain.items():
        assert torch.equal(p, seg[name]), name


def test_checkpoint_forms_carry_the_head(pair, tmp_path):
    """The HF state dict leaves the head out with the JAX package's
    warning; the framework form (``u2_params.msgpack`` by
    ``save_params_msgpack``, the writer of ``cli convert-checkpoint``)
    carries it, and a checkpoint directory loads it back bit for bit."""
    from u2tokenizer_torch import cli as t_cli
    from u2tokenizer_torch.models import hf_export as t_export
    from u2tokenizer_torch.train.checkpoint import save_params_msgpack
    from u2tokenizer_torch.weights import flatten, flax_params
    from u2tokenizer_tpu.models import hf_export as j_export

    jm, _, tm, _ = pair
    tree = flax_params(tm)
    with pytest.warns(UserWarning, match="seg_module/seg_projector"):
        sd = t_export.export_u2_state_dict(tree, tm.cfg)
    with pytest.warns(UserWarning, match="seg_module/seg_projector"):
        ref = j_export.export_u2_state_dict(tree, jm.cfg)
    assert sorted(sd) == sorted(ref) and not any("seg" in k for k in sd)
    for k in sd:
        np.testing.assert_array_equal(np.asarray(sd[k]), np.asarray(ref[k]))

    (tmp_path / "u2_config.json").write_text(tm.cfg.to_json())
    save_params_msgpack(str(tmp_path / "u2_params.msgpack"), tree)
    model = TModel(tm.cfg, dtype=torch.float32, device="cpu", seed=5)
    t_cli._load_pretrained_into(model, str(tmp_path), tm.cfg)
    back, want = flatten(flax_params(model)), flatten(tree)
    assert set(back) == set(want)
    assert any(k.startswith("seg_projector/") for k in back)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v)
