"""The port's optimizers (``train/optim.py``'s Adafactor, the QLoRA
routing ``train.lora.QLoraOptimizer`` and the ``torch.optim.AdamW`` of
``train.sft.Optimizer``) against optax 0.2.6, and its msgpack form of a parameter tree (``utils/msgpack.py``,
``train/checkpoint.save_params_msgpack``) against flax's serialization.

Adafactor runs optax's chain step for step in the parameter's dtype; the
two differ only where a sum is taken in another order or XLA's rsqrt
(not correctly rounded) and torch's part in the last bit:

  * fp32: each update within a few fp32 ulps, so after STEPS steps every
    parameter within STEPS ulps of the largest one (the updates themselves
    are ~1e-3 of the parameters: a wrong update fails by far); AdamW's
    bias correction 1 - 0.999^t takes b2^t in XLA's pow, whose last bit
    is not torch's, and the cancellation makes that a relative 1e-5 of
    the update (torch also divides sqrt(nu) by sqrt(1 - b2^t) where optax
    takes the root of the quotient): within STEPS * 2e-5 * LR more;
  * bf16: bit for bit, but for elements where such a last-bit difference
    in fp32 rounds a moment, a mean or a sum p + u to the neighbouring bf16
    value: on at most 1 % of the elements, each within 2 bf16 ulps of the
    leaf's largest value (a rounding flip costs one ulp of the value it
    hits, and the difference stays as the value moves on).

Inputs and gradients come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from u2tokenizer_torch.config import TrainConfig
from u2tokenizer_torch.train import checkpoint as t_ckpt
from u2tokenizer_torch.train import lora as t_lora
from u2tokenizer_torch.train import optim as t_optim
from u2tokenizer_torch.train.sft import Optimizer, make_schedule
from u2tokenizer_torch.utils import msgpack as t_msgpack

pytestmark = pytest.mark.fast

STEPS, LR, TOTAL = 5, 1e-2, 6
# factored (two dims >= 128, in either order, and a 3-D leaf), unfactored
# (the second largest dim under 128; a vector) and square
SHAPES = {"fac": (256, 160), "fac_t": (160, 256), "fac3": (3, 130, 200),
          "unf": (64, 200), "vec": (300,), "sq": (128, 128)}
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _schedules():
    """The JAX CLI's schedule and the port's, warmup 1 of TOTAL steps."""
    jax_s = optax.warmup_cosine_decay_schedule(0.0, LR, 1, TOTAL)
    port = make_schedule(TrainConfig(learning_rate=LR, warmup_ratio=0.0),
                         TOTAL)
    return jax_s, port


def _ulp(x: np.ndarray, bits: int) -> np.ndarray:
    """The spacing of floats with ``bits`` mantissa bits at |x|."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - bits)


def _agree(got: np.ndarray, want: np.ndarray, dtype: str, steps: int,
           what: str, adam: bool = False) -> None:
    if dtype == "fp32":
        atol = steps * (_ulp(np.abs(want).max(), 23) + adam * 2e-5 * LR)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=what)
        return
    diff = got != want
    assert diff.mean() <= 0.01, (what, diff.mean())
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * _ulp(np.abs(want).max(), 7),
                               err_msg=what)


def _grads(rs, step):
    return {k: rs.randn(*s).astype(np.float32) * (0.1 + step)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_adafactor_matches_optax(dtype):
    """``optim.Adafactor(schedule)`` against ``optax.adafactor(schedule,
    min_dim_size_to_factor=128)`` over STEPS updates: parameters and the
    factored (v_row, v_col) and unfactored (v) moments, in fp32 and in
    bf16, whose moments stay bf16 and whose update rounds to bf16 at each
    of optax's steps."""
    jdt, tdt = DTYPES[dtype]
    jax_s, port_s = _schedules()
    rs = np.random.RandomState(0)
    p0 = {k: rs.randn(*s).astype(np.float32) * 0.05 for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p0.items()}
    jtx = optax.adafactor(jax_s, min_dim_size_to_factor=128)
    ttx = t_optim.Adafactor(port_s)
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(STEPS):
        g = _grads(rs, step)
        ju, js = jtx.update({k: jnp.asarray(v, jdt) for k, v in g.items()},
                            js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update({k: torch.from_numpy(v).to(tdt)
                             for k, v in g.items()}, ts, tp)
        t_optim.apply_updates(tp, tu)
    assert ts["count"] == int(js[0].count) == STEPS
    for k in SHAPES:
        assert tp[k].dtype == tdt
        _agree(tp[k].float().numpy(), np.asarray(jp[k], np.float32), dtype,
               STEPS, k)
        for part in ("v_row", "v_col", "v"):
            want = np.asarray(getattr(js[0], part)[k], np.float32)
            got = ts[part][k]
            assert got.dtype == tdt and tuple(got.shape) == want.shape
            _agree(got.float().numpy(), want, dtype, STEPS, f"{k} {part}")


def test_adafactor_factors_the_two_largest_dims():
    """Which leaves optax factors, and along which dims."""
    for shape in SHAPES.values():
        want = optax._src.factorized._factored_dims(shape, True, 128)
        assert t_optim._factored_dims(shape, 128) == want, shape


def test_multi_transform_routes_as_the_jax_cli():
    """``lora.QLoraOptimizer`` (torch's AdamW, weight decay 0, on the
    adapters; Adafactor on the rest) against the JAX CLI's
    ``optax.multi_transform`` over STEPS updates: fp32 adapters, bf16
    full-rank leaves."""
    jax_s, port_s = _schedules()
    rs = np.random.RandomState(1)
    shapes = {"params/llm/q_proj/lora_a": (160, 4),
              "params/llm/q_proj/lora_b": (4, 160),
              "params/u2tokenizer/dense/kernel": (160, 256),
              "params/mm_projector/bias": (160,)}
    dt = {k: (jnp.float32, torch.float32) if k.endswith(("lora_a", "lora_b"))
          else (jnp.bfloat16, torch.bfloat16) for k in shapes}
    p0 = {k: rs.randn(*s).astype(np.float32) * 0.05 for k, s in shapes.items()}
    jp = {k: jnp.asarray(v, dt[k][0]) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(dt[k][1]) for k, v in p0.items()}
    jtx = optax.multi_transform(
        {"lora": optax.adamw(jax_s, weight_decay=0.0),
         "full": optax.adafactor(jax_s, min_dim_size_to_factor=128)},
        lambda tree: {k: ("lora" if k.endswith(("/lora_a", "/lora_b"))
                          else "full") for k in tree})
    ttx = t_lora.QLoraOptimizer(tp, port_s)
    js = jtx.init(jp)
    for step in range(STEPS):
        g = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
        ju, js = jtx.update({k: jnp.asarray(v, dt[k][0])
                             for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        ttx.update({k: torch.from_numpy(v).to(dt[k][1])
                    for k, v in g.items()})
    assert set(ttx.adapters) == {k for k in shapes if "lora" in k}
    assert set(ttx.adafactor_state["v"]) == {k for k in shapes
                                             if "lora" not in k}
    for k in shapes:
        dtype = "fp32" if "lora" in k else "bf16"
        assert tp[k].dtype == dt[k][1]
        _agree(tp[k].float().numpy(), np.asarray(jp[k], np.float32), dtype,
               STEPS, k, adam=dtype == "fp32")


def test_adamw_matches_optax_with_weight_decay():
    """``sft.Optimizer`` (``torch.optim.AdamW`` under the schedule), which
    the QLoRA adapters and the float-LoRA trainer take, against
    ``optax.adamw`` with its default weight decay, fp32."""
    jax_s, port_s = _schedules()
    rs = np.random.RandomState(2)
    p0 = rs.randn(64, 32).astype(np.float32)
    jp = {"w": jnp.asarray(p0)}
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    jtx, ttx = optax.adamw(jax_s), Optimizer([tp], port_s, weight_decay=1e-4)
    js = jtx.init(jp)
    for _ in range(STEPS):
        g = rs.randn(64, 32).astype(np.float32)
        ju, js = jtx.update({"w": jnp.asarray(g)}, js, jp)
        jp = optax.apply_updates(jp, ju)
        ttx.update([torch.from_numpy(g)])
    _agree(tp.detach().numpy(), np.asarray(jp["w"]), "fp32", STEPS, "w",
           adam=True)


def _tree(rs):
    return {"params": {
        "llm": {"layers_0": {"q_proj": {
            "lora_a": rs.randn(12, 4).astype(np.float32),
            "lora_b": rs.randn(4, 12).astype(np.float32)}}},
        "u2tokenizer": {"norm": {"scale": rs.randn(12).astype(np.float32)},
                        "codes": rs.randint(-8, 8, (3, 5)).astype(np.int8)},
        "empty": np.zeros((0, 3), np.float32)}}


def test_msgpack_writes_flax_bytes():
    """The port's ``to_bytes`` of a tree (tensors, bf16 among them, and
    numpy arrays) is byte for byte flax's ``to_bytes`` of the same tree
    (bf16 through jax), and flax restores it to the same values."""
    tree = _tree(np.random.RandomState(3))
    bf = np.random.RandomState(4).randn(6, 10).astype(np.float32)
    jtree = jax.tree_util.tree_map(lambda x: x, tree)
    jtree["params"]["u2tokenizer"]["dense"] = jnp.asarray(bf, jnp.bfloat16)
    ttree = jax.tree_util.tree_map(torch.from_numpy, tree)
    ttree["params"]["u2tokenizer"]["dense"] = torch.from_numpy(bf).to(
        torch.bfloat16)
    ttree["meta"] = jtree["meta"] = {"step": 3, "neg": -300, "lr": 0.5,
                                     "name": "x" * 40, "ok": True}
    want = serialization.to_bytes(jtree)
    got = t_msgpack.to_bytes(ttree)
    assert got == want
    back = serialization.msgpack_restore(got)
    np.testing.assert_array_equal(
        np.asarray(back["params"]["u2tokenizer"]["dense"], np.float32),
        ttree["params"]["u2tokenizer"]["dense"].float().numpy())
    assert back["meta"] == ttree["meta"]


def test_msgpack_reads_flax_bytes(tmp_path):
    """flax's bytes read back by the port, bf16 included, exactly; the
    checkpoint helpers round-trip a tree through a file."""
    tree = _tree(np.random.RandomState(5))
    bf = np.random.RandomState(6).randn(7, 3).astype(np.float32)
    tree["params"]["mm_projector"] = {"kernel": jnp.asarray(bf, jnp.bfloat16)}
    back = t_msgpack.restore(serialization.to_bytes(tree))
    got = back["params"]["mm_projector"]["kernel"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(tree["params"]["mm_projector"][
            "kernel"], np.float32))
    codes = back["params"]["u2tokenizer"]["codes"]
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(),
                                  tree["params"]["u2tokenizer"]["codes"])
    assert tuple(back["params"]["empty"].shape) == (0, 3)
    path = str(tmp_path / "tree.msgpack")
    t_ckpt.save_params_msgpack(path, back)
    again = t_ckpt.load_params_msgpack(path)
    assert open(path, "rb").read() == serialization.to_bytes(tree)
    for k in ("lora_a", "lora_b"):
        np.testing.assert_array_equal(
            again["params"]["llm"]["layers_0"]["q_proj"][k].numpy(),
            tree["params"]["llm"]["layers_0"]["q_proj"][k])


def test_msgpack_chunks_as_flax(monkeypatch):
    """Arrays over flax's chunk size are split and joined as flax does
    (the chunk size lowered on both sides, so that a small array splits)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(t_msgpack, "MAX_CHUNK_SIZE", 64)
    arr = np.arange(50, dtype=np.float32).reshape(5, 10)
    want = serialization.to_bytes({"a": arr})
    got = t_msgpack.to_bytes({"a": torch.from_numpy(arr)})
    assert got == want
    np.testing.assert_array_equal(t_msgpack.restore(want)["a"].numpy(), arr)


def test_optimizer_state_survives_a_checkpoint(tmp_path):
    """The QLoRA optimizer's state (torch's AdamW state and the Adafactor
    moments) through ``torch.save`` / ``torch.load(weights_only=True)``,
    as a QLoRA checkpoint carries it, loaded into a fresh optimizer: the
    next update is the uninterrupted one's, bit for bit."""
    _, port_s = _schedules()

    def params():
        return {"params/a/lora_a": torch.nn.Parameter(torch.ones(3, 2)),
                "params/u2tokenizer/w": torch.nn.Parameter(
                    torch.ones(130, 129).bfloat16())}

    rs = np.random.RandomState(3)
    grads = [{k: torch.from_numpy(rs.randn(*p.shape).astype(np.float32)).to(
        p.dtype) for k, p in params().items()} for _ in range(2)]
    kept = params()
    tx = t_lora.QLoraOptimizer(kept, port_s)
    tx.update(grads[0])
    path = tmp_path / "s.pt"
    torch.save(tx.state_dict(), path)
    loaded = torch.load(path, weights_only=True)
    assert loaded["adafactor"]["count"] == 1
    assert loaded["adafactor"]["v_row"]["params/u2tokenizer/w"].dtype == \
        torch.bfloat16
    again = {k: torch.nn.Parameter(p.detach().clone())
             for k, p in kept.items()}
    resumed = t_lora.QLoraOptimizer(again, port_s)
    resumed.load_state_dict(loaded)
    tx.update(grads[1])
    resumed.update(grads[1])
    for k in kept:
        assert torch.equal(kept[k], again[k]), k
