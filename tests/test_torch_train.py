"""The port's SFT path against the JAX package's, in fp32 on the CPU.

One model configuration, ``U2ModelConfig.tiny()`` cut to one layer per
stack so that each jitted JAX train step compiles in seconds. Its
parameters are drawn by the port (biases re-drawn from a numpy seed so that
every parameter matters) and carried into the JAX package's tree through
``weights.flax_path``; the same batch (numpy seed) goes to both. Compared:
the losses, the lr schedule, the AdamW + MultiSteps update, and three
updates of the train step (loss, grad_norm, each parameter's change, the
loss after them) with the vision tower trainable, and frozen under two-step
gradient accumulation.
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from u2tokenizer_torch.config import TrainConfig as TTrain
from u2tokenizer_torch.config import U2ModelConfig as TCfg
from u2tokenizer_torch.models.layers import Dense
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.models.vit3d import PatchEmbed3D, _ConvProj
from u2tokenizer_torch.train import sft as t_sft
from u2tokenizer_torch.train.checkpoint import CheckpointManager
from u2tokenizer_torch.train.loop import (MetricLogger, device_prefetch,
                                          evaluate_token_accuracy,
                                          run_training)
from u2tokenizer_torch.weights import flax_path, load_flax_params, torch_name
from u2tokenizer_tpu.config import TrainConfig as JTrain
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.models.u2_model import U2CausalLM as JModel
from u2tokenizer_tpu.train import sft as j_sft

pytestmark = pytest.mark.fast

B, S, SQ = 2, 24, 6
FROZEN = lambda p: "vision_tower" not in p  # cli train --freeze-vision-tower
# Three updates at lr 1e-2 (the first at lr 0), then one more call whose
# loss is that of the updated parameters. Losses and gradient norms agree to
# fp32 through one ViT, one μ²tokenizer and one decoder layer with sums in
# another order (1e-4, as tests/test_torch_model.py; measured 2e-6 on the
# last loss). Each parameter's change over the three updates agrees with
# JAX's to 5e-3 of its norm (measured at most 1.6e-3: AdamW divides each
# gradient element by its own root mean square, which magnifies the rounding
# of its small elements). The μ²tokenizer's attention key biases are the
# exception: softmax is invariant to the q.b_k it adds to a row of scores,
# so their gradient is zero in exact arithmetic and rounding noise in fp32
# (under NOISE of the largest leaf gradient; measured 1e-15 to 3e-10).
# AdamW turns noise into a step of up to lr in either direction in each
# package, so they are held only to 2 lr. The update rule itself is held
# exactly on given gradients (test_schedule_and_adamw_match_optax and
# test_grad_accumulation_matches_multisteps).
LR = 1e-2
DELTA_RTOL, NOISE = 5e-3, 1e-9


def _cfg(cls):
    base = cls.tiny()
    return dataclasses.replace(
        base, vision=dataclasses.replace(base.vision, num_layers=1),
        u2t=dataclasses.replace(base.u2t, num_layers=1),
        llm=dataclasses.replace(base.llm, num_layers=1))


def _batch():
    rs = np.random.RandomState(0)
    cfg = _cfg(JCfg)
    d, h, w = cfg.vision.input_spatial
    ids = rs.randint(0, cfg.llm.vocab_size, (B, S)).astype(np.int32)
    mask = (np.arange(S)[None, :] < np.array([[S], [19]])).astype(np.int32)
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    labels[:, :1 + 8 + 2] = -100  # bos, image rows, part of the prompt
    return {
        "input_ids": ids, "labels": labels, "attention_mask": mask,
        "images": rs.randn(B, cfg.num_chunks, d, h, w).astype(np.float32),
        "question_ids": rs.randint(0, cfg.llm.vocab_size,
                                   (B, SQ)).astype(np.int32),
    }


@torch.no_grad()
def _draw_fixed_weights(tm, seed=0):
    """This test's weights, as the port drew them before its initializers
    became flax's (untruncated normals of std 1/sqrt(fan_in), position
    embeddings clamped): the test's fixed data, whose gradient noise and
    update deltas the limits above were measured on. The initializers
    themselves are held to flax's in tests/test_torch_init.py."""
    g = torch.Generator().manual_seed(seed)
    for module in tm.modules():
        if isinstance(module, Dense):
            module.weight.normal_(0.0, module.weight.shape[1] ** -0.5,
                                  generator=g)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, _ConvProj):
            module.kernel.normal_(0.0, module.kernel.shape[0] ** -0.5,
                                  generator=g)
            module.bias.zero_()
        elif isinstance(module, PatchEmbed3D):
            module.position_embeddings.normal_(0.0, 0.02, generator=g)
            module.position_embeddings.clamp_(-0.04, 0.04)
        elif hasattr(module, "reset_parameters"):
            module.reset_parameters(g)


def _port_model(remat=True):
    tm = TModel(_cfg(TCfg), dtype=torch.float32, device="cpu", seed=0,
                remat=remat)
    _draw_fixed_weights(tm)
    rs = np.random.RandomState(1)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if name.endswith(("bias", "cls_token")):
                p.copy_(torch.from_numpy(
                    (rs.randn(*p.shape) * 0.1).astype(np.float32)))
    return tm


def _flax_flat(tm):
    """The port's parameters as the JAX package's flat param dict."""
    modules = dict(tm.named_modules())
    flat = {}
    for name, p in tm.named_parameters():
        path = flax_path(name, modules)[len("params/"):]
        back, transpose = torch_name(path, modules)
        assert back == name
        value = p.detach().numpy()
        flat[path] = np.ascontiguousarray(value.T if transpose else value)
    return flat


@pytest.fixture(scope="module")
def setup():
    tm = _port_model()
    flat = _flax_flat(tm)
    params = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
    return JModel(_cfg(JCfg), dtype=jnp.float32), params, flat, _batch()


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def test_flax_paths_round_trip(setup):
    """load_flax_params takes back what flax_path exported, and the JAX
    filter of ``cli train --freeze-vision-tower`` selects the same
    parameters in both packages."""
    _, params, flat, _ = setup
    tm = _port_model()
    load_flax_params(tm, flat)
    j_paths = ["params/" + p for p in traverse_util.flatten_dict(
        params["params"], sep="/")]
    modules = dict(tm.named_modules())
    t_paths = [flax_path(n, modules) for n, _ in tm.named_parameters()]
    assert sorted(t_paths) == sorted(j_paths)
    t_sft.set_trainable(tm, FROZEN)
    frozen = {flax_path(n, modules) for n, p in tm.named_parameters()
              if not p.requires_grad}
    assert frozen == {p for p in j_paths if not FROZEN(p)}
    assert frozen and all("vision_tower" in p for p in frozen)


def test_cross_entropy_matches_jax():
    rs = np.random.RandomState(2)
    logits = rs.randn(2, 9, 31).astype(np.float32)
    labels = rs.randint(0, 31, (2, 9)).astype(np.int32)
    labels[0, :4] = labels[1, 6:] = -100
    ref = j_sft.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))
    out = t_sft.cross_entropy_loss(torch.from_numpy(logits),
                                   torch.from_numpy(labels).long())
    for got, want in zip(out, ref):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("chunk", [3, 64])
def test_chunked_cross_entropy_matches_jax(chunk):
    """Chunks that do not divide S-1 and that exceed it; the gradient
    through the checkpointed chunks equals the plain loss's."""
    rs = np.random.RandomState(3)
    hidden = rs.randn(2, 9, 16).astype(np.float32)
    w = rs.randn(16, 31).astype(np.float32)
    labels = rs.randint(0, 31, (2, 9)).astype(np.int32)
    labels[1, :5] = -100
    ref = j_sft.chunked_cross_entropy_from_hidden(
        lambda h: h @ jnp.asarray(w), jnp.asarray(hidden),
        jnp.asarray(labels), chunk)
    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(w)
    out = t_sft.chunked_cross_entropy_from_hidden(
        lambda h: h @ tw, th, torch.from_numpy(labels).long(), chunk)
    for got, want in zip(out, ref):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-6)
    out[0].backward()
    th2 = torch.from_numpy(hidden).requires_grad_()
    t_sft.cross_entropy_loss(th2 @ tw, torch.from_numpy(labels).long())[
        0].backward()
    np.testing.assert_allclose(th.grad.numpy(), th2.grad.numpy(), rtol=1e-5,
                               atol=1e-7)


def _scalar_run(tx, opt, grads):
    """Feed the same gradients to an optax transform and to the port's
    Optimizer over one (3,) parameter; returns both trajectories."""
    p = jnp.asarray([0.5, -1.0, 2.0], jnp.float32)
    state = tx.init(p)
    tp = opt.params[0]
    j_traj, t_traj = [], []
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, upd)
        opt.update([torch.from_numpy(g)])
        j_traj.append(np.asarray(p))
        t_traj.append(tp.detach().numpy().copy())
    return np.array(j_traj), np.array(t_traj)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_schedule_and_adamw_match_optax(schedule):
    """20 updates: the port's schedule equals the learning rate the JAX
    package's optimizer applies at every step (read back from a constant
    unit gradient, where AdamW's step is lr / (1 + eps)), the first 0
    included; the parameters follow the same path with weight decay on."""
    kw = dict(learning_rate=1e-2, warmup_ratio=0.2, lr_schedule=schedule,
              weight_decay=0.1)
    total = 20
    jtx = j_sft.make_optimizer(JTrain(**kw), total)
    lr_tx = j_sft.make_optimizer(JTrain(**{**kw, "weight_decay": 0.0}), total)
    sched = t_sft.make_schedule(TTrain(**kw), total)
    st, zero = lr_tx.init(jnp.zeros(())), jnp.zeros(())
    for count in range(total):
        upd, st = lr_tx.update(jnp.ones(()), st, zero)
        # optax keeps its moments in fp32, where 1 - 0.999 is off by
        # 1.3e-5 relative: the lr read back carries that much
        np.testing.assert_allclose(sched(count), -float(upd) * (1 + 1e-8),
                                   rtol=3e-5, atol=1e-12)
    assert sched(0) == 0.0
    param = torch.nn.Parameter(torch.tensor([0.5, -1.0, 2.0]))
    opt = t_sft.make_optimizer(TTrain(**kw), [param], total)
    grads = np.random.RandomState(4).randn(total, 3).astype(np.float32)
    j_traj, t_traj = _scalar_run(jtx, opt, grads)
    np.testing.assert_allclose(t_traj, j_traj, rtol=1e-5, atol=1e-7)


def test_grad_accumulation_matches_multisteps():
    """grad_accum_steps=3: the mean of 3 gradients, one update every third
    call, the schedule advancing once per update (optax.MultiSteps)."""
    kw = dict(learning_rate=1e-2, warmup_ratio=0.2, grad_accum_steps=3,
              weight_decay=0.1)
    jtx = j_sft.make_optimizer(JTrain(**kw), 4)
    param = torch.nn.Parameter(torch.tensor([0.5, -1.0, 2.0]))
    opt = t_sft.make_optimizer(TTrain(**kw), [param], 4)
    grads = np.random.RandomState(5).randn(12, 3).astype(np.float32)
    j_traj, t_traj = _scalar_run(jtx, opt, grads)
    np.testing.assert_allclose(t_traj, j_traj, rtol=1e-5, atol=1e-7)
    assert opt.gradient_step == 4 and opt.mini_step == 0


@pytest.mark.parametrize("case", ["trainable", "frozen-vision-accum2"])
def test_train_steps_match_jax(setup, case):
    """Three updates from the same parameters and batch, with the vision
    tower trainable, or frozen under two-step gradient accumulation
    (optax.MultiSteps; one JAX compile a case): loss, token_accuracy and
    grad_norm at every call, each parameter's change after the updates,
    and the loss of the updated parameters; frozen parameters move by
    weight decay alone, as in JAX."""
    jm, params, flat, batch = setup
    accum = 2 if case.endswith("accum2") else 1
    kw = dict(learning_rate=LR, weight_decay=0.1, grad_accum_steps=accum)
    filt = FROZEN if case.startswith("frozen") else None
    tx = j_sft.make_optimizer(JTrain(**kw), 3)
    j_step = jax.jit(j_sft.make_train_step(jm, tx, filt))
    j_state = j_sft.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               opt_state=tx.init(params))
    tm = _port_model()
    load_flax_params(tm, flat)
    tb = _torch_batch(batch)
    loss, _ = t_sft.make_loss_fn()(tm, tb)
    grad_norm = {n: g.norm().item() for (n, _), g in zip(
        tm.named_parameters(), torch.autograd.grad(
            loss, list(tm.parameters()), allow_unused=True,
            materialize_grads=True))}
    noise = {n for n in grad_norm if n.endswith("wk.bias")}
    assert noise and all(grad_norm[n] < NOISE * max(grad_norm.values())
                         for n in noise)
    t_state, t_step = t_sft.make_trainer(tm, TTrain(**kw), 3, filt)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    steps = 3 * accum
    losses = []

    def call_both():
        nonlocal j_state, t_state
        j_state, j_met = j_step(j_state, jb)
        t_state, t_met = t_step(t_state, tb)
        for key in ("loss", "token_accuracy", "grad_norm"):
            np.testing.assert_allclose(float(t_met[key]), float(j_met[key]),
                                       rtol=1e-4, err_msg=key)
        losses.append(float(t_met["loss"]))

    for _ in range(steps):
        call_both()
    assert t_state.step == steps and losses[-1] < losses[0]
    modules = dict(tm.named_modules())
    params_t = dict(tm.named_parameters())
    for path, want in traverse_util.flatten_dict(
            j_state.params["params"], sep="/").items():
        name, transpose = torch_name(path, modules)
        got = params_t[name].detach().numpy()
        got = got.T if transpose else got
        d_want, d_got = np.asarray(want) - flat[path], got - flat[path]
        assert np.any(d_want != 0), path  # weight decay at least
        if filt is not None and not filt("params/" + path):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                       err_msg=path)
        elif name in noise:
            np.testing.assert_allclose(d_got, d_want, rtol=0, atol=2 * LR,
                                       err_msg=path)
        else:
            err = np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want)
            assert err <= DELTA_RTOL, (path, err)
    call_both()  # the loss of the parameters after the last update
    assert losses[-1] < losses[-2]


def test_remat_changes_no_gradient():
    """Checkpointed decoder layers give the same loss and gradients as
    plain ones, under full recompute and under the policies that keep
    matmul outputs ("dots", "dots_no_batch"; tests/test_torch_remat.py
    holds them to the JAX package's)."""
    batch = _torch_batch(_batch())
    loss_fn = t_sft.make_loss_fn()
    grads = []
    for remat in ("off", True, "dots", "dots_no_batch"):
        tm = _port_model(remat)
        loss, _ = loss_fn(tm, batch)
        grads.append([loss] + list(torch.autograd.grad(
            loss, list(tm.parameters()), allow_unused=True,
            materialize_grads=True)))
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)


def test_checkpoint_manager_interval_and_limit(tmp_path):
    tm = _port_model()
    state, _ = t_sft.make_trainer(tm, TTrain(), 10)
    ckpt = CheckpointManager(str(tmp_path), save_total_limit=2,
                             save_interval_steps=2)
    assert ckpt.restore(state) is None
    assert [ckpt.save(s, state) for s in (1, 2, 3, 4)] == [
        False, True, False, True]
    assert not ckpt.save(4, state, force=True)  # idempotent
    assert ckpt.save(5, state, force=True)
    assert ckpt.all_steps() == [4, 5] and ckpt.latest_step() == 5


def test_run_training_resume_matches_uninterrupted(tmp_path):
    """save_steps=2: a run stopped after 3 of 4 steps and resumed (a fresh
    model, the checkpoint of step 2, batch 3 of the epoch next) ends where
    an uninterrupted run ends."""
    base = _batch()
    rs = np.random.RandomState(6)
    batches = [dict(base, images=rs.randn(*base["images"].shape).astype(
        np.float32)) for _ in range(4)]
    data = lambda epoch: iter(batches)

    def run(out, max_steps):
        cfg = TTrain(learning_rate=1e-2, warmup_ratio=0.0, save_steps=2,
                     log_steps=1, max_steps=max_steps, output_dir=str(out))
        state, step = t_sft.make_trainer(_port_model(), cfg, 4)
        return run_training(cfg, state, step, data, steps_per_epoch=4)

    whole = run(tmp_path / "whole", 4)
    run(tmp_path / "cut", 3)  # saves step 2, and step 3 when it stops
    shutil.rmtree(tmp_path / "cut" / "checkpoints" / "3")
    resumed = run(tmp_path / "cut", 4)
    assert resumed.step == whole.step == 4
    for a, b in zip(whole.model.parameters(), resumed.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    loss_fn = t_sft.make_loss_fn()
    ev = evaluate_token_accuracy(whole.model, loss_fn, whole,
                                 [_torch_batch(b) for b in batches[:2]])
    assert np.isfinite(ev["loss"]) and 0 <= ev["token_accuracy"] <= 1


def test_device_prefetch_and_metric_logger(tmp_path):
    """device_prefetch yields every batch in order as tensors on the device,
    drawing at most ``depth`` batches ahead of the consumer; MetricLogger
    appends one JSON record per call, values as floats."""
    drawn = []

    def batches():
        for i in range(5):
            drawn.append(i)
            yield {"x": np.full((2,), i, np.int32), "y": [float(i)]}

    for i, batch in enumerate(device_prefetch(batches(), "cpu", depth=2)):
        assert len(drawn) <= i + 2
        assert batch["x"].device.type == "cpu"
        assert batch["x"].tolist() == [i, i] and batch["y"].tolist() == [i]
    assert drawn == list(range(5)) and i == 4
    logger = MetricLogger(str(tmp_path))
    logger.log(1, {"loss": torch.tensor(2.5), "token_accuracy": 0.25})
    logger.log(2, {"loss": np.float32(1.5)})
    logger.close()
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line) for line in lines] == [
        {"step": 1, "loss": 2.5, "token_accuracy": 0.25},
        {"step": 2, "loss": 1.5}]
