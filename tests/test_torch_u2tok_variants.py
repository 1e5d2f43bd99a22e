"""The μ²tokenizer's ablation variants in the port against the JAX package:
the 'rope' and 'vanilla' self attentions (modules, SVR, TTA and the whole
μ²tokenizer, with attention capture), the relative-position bias at and
past its table, the 'sequence' pooling, the 'linear' and 'identity'
projectors, and the reference's ``nn.MultiheadAttention`` layout into the
vanilla module. Whole models of each variant, their checkpoints and an SFT
step: ``tests/test_torch_variants_model.py``.

The JAX modules' parameters (biases and relative-position tables re-drawn
from a numpy seed, so that every parameter moves the output) go into the
port's through ``load_flax_params``; inputs come from numpy seeds; fp32 on
the CPU. Sums in other orders: 1e-5 for a module, scaled by the output's
magnitude for the SVR stack, whose lack of norms lets activations grow
(as ``tests/test_parity_u2tokenizer.py`` holds the JAX package).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from u2tokenizer_torch.config import ProjectorConfig as TProjCfg
from u2tokenizer_torch.config import U2TokenizerConfig as TU2tCfg
from u2tokenizer_torch.models import hf_weights as t_hf
from u2tokenizer_torch.models import projector as t_proj
from u2tokenizer_torch.models.u2tok import attention as t_attn
from u2tokenizer_torch.models.u2tok.svr import \
    SpatioTemporalVisualTokenRefiner as TSVR
from u2tokenizer_torch.models.u2tok.tta import \
    TextConditionTokenAggregator as TTTA
from u2tokenizer_torch.models.u2tok.u2tokenizer import \
    U2Tokenizer as TU2Tokenizer
from u2tokenizer_torch.ops import attention as t_ops
from u2tokenizer_torch.ops import pooling as t_pool
from u2tokenizer_torch.weights import flatten, load_flax_params
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.models import hf_weights as j_hf
from u2tokenizer_tpu.models import projector as j_proj
from u2tokenizer_tpu.models.u2tok import attention as j_attn
from u2tokenizer_tpu.models.u2tok.svr import \
    SpatioTemporalVisualTokenRefiner as JSVR
from u2tokenizer_tpu.models.u2tok.tta import \
    TextConditionTokenAggregator as JTTA
from u2tokenizer_tpu.models.u2tok.u2tokenizer import \
    U2Tokenizer as JU2Tokenizer
from u2tokenizer_tpu.ops import attention as j_ops
from u2tokenizer_tpu.ops import pooling as j_pool

pytestmark = pytest.mark.fast

E, HEADS, MAX_SEQ = 32, 4, 64
TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_TYPES = ["rma", "rope", "vanilla"]


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _flat(params):
    return {k: np.array(v) for k, v in
            traverse_util.flatten_dict(params["params"], sep="/").items()}


def _tree(flat):
    return {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}


def _redraw(flat, seed=0):
    """Biases and relative-position tables re-drawn (0.1 sigma), LayerNorm
    scales about 1."""
    rs = np.random.RandomState(seed)
    for k, v in flat.items():
        if k.endswith(("bias", "relative_bias", "cls_token")):
            flat[k] = (rs.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("scale"):
            flat[k] = (1.0 + rs.randn(*v.shape) * 0.1).astype(np.float32)
    return flat


def _pair(jm, tm, *inputs, **kw):
    """The JAX module's redrawn parameters, also loaded into ``tm``."""
    flat = _redraw(_flat(jm.init(jax.random.PRNGKey(0),
                                 *map(jnp.asarray, inputs), **kw)))
    load_flax_params(tm, flat)
    return _tree(flat)


def _sown(state, *path):
    node = state["intermediates"]
    for key in path:
        node = node[key]
    return np.asarray(node["attn"][0])


def _self_attention_modules(attn_type):
    if attn_type == "rma":
        return (j_attn.RelativeMultiheadAttention(E, HEADS, MAX_SEQ),
                t_attn.RelativeMultiheadAttention(E, HEADS, MAX_SEQ))
    if attn_type == "rope":
        return (j_attn.RotaryMultiheadAttention(E, HEADS, MAX_SEQ),
                t_attn.RotaryMultiheadAttention(E, HEADS))
    return (j_attn.VanillaMultiheadAttention(E, HEADS),
            t_attn.VanillaMultiheadAttention(E, HEADS))


@pytest.mark.parametrize("attn_type", ATTN_TYPES)
def test_self_attention_and_capture(attn_type):
    """Output and captured map (fp32 softmax, with the relative bias for
    'rma') against the JAX module's sown map; capture changes no output."""
    jm, tm = _self_attention_modules(attn_type)
    assert isinstance(t_attn.make_self_attention(attn_type, E, HEADS,
                                                 MAX_SEQ), type(tm))
    x = _rand((2, 12, E), 1)
    params = _pair(jm, tm, x, x, x)
    ref, state = jm.apply(params, *[jnp.asarray(x)] * 3,
                          capture_attention=True, mutable=["intermediates"])
    xt = torch.from_numpy(x)
    with torch.no_grad():
        plain = tm(xt, xt, xt)
        assert tm.attn is None
        out = tm(xt, xt, xt, capture_attention=True)
    assert torch.equal(out, plain)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert tm.attn.dtype == torch.float32 and tm.attn.shape == (2, HEADS,
                                                                12, 12)
    np.testing.assert_allclose(tm.attn.numpy(), _sown(state), **TOL)
    np.testing.assert_allclose(tm.attn.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("compress", [False, True])
def test_cross_attention_capture(compress):
    jm = j_attn.MultiHeadCrossAttention(E, HEADS)
    tm = t_attn.MultiHeadCrossAttention(E, HEADS, is_compress=compress)
    q, v = _rand((2, 5, E), 2), _rand((2, 9, E), 3)
    params = _pair(jm, tm, q, v, is_compress=compress)
    ref, state = jm.apply(params, jnp.asarray(q), jnp.asarray(v),
                          is_compress=compress, capture_attention=True,
                          mutable=["intermediates"])
    with torch.no_grad():
        out = tm(torch.from_numpy(q), torch.from_numpy(v),
                 capture_attention=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(tm.attn.numpy(), _sown(state), **TOL)


def test_unknown_attention_type_raises():
    """A name other than 'rma' and 'rope' builds the vanilla attention in
    both packages (the reference falls back to ``nn.MultiheadAttention``
    the same way): the same module type, and the same output on the same
    parameters. Nothing raises."""
    jm = j_attn.make_self_attention("alibi", E, HEADS, MAX_SEQ,
                                    jnp.float32, "alibi")
    tm = t_attn.make_self_attention("alibi", E, HEADS, MAX_SEQ)
    assert isinstance(jm, j_attn.VanillaMultiheadAttention)
    assert isinstance(tm, t_attn.VanillaMultiheadAttention)
    x = _rand((2, 12, E), 5)
    params = _pair(jm, tm, x, x, x)
    ref = jm.apply(params, *[jnp.asarray(x)] * 3)
    with torch.no_grad():
        out = tm(*[torch.from_numpy(x)] * 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("attn_type", ATTN_TYPES)
def test_svr(attn_type):
    """Two SVR layers (spatial over N, temporal over T), hard top-k and the
    fixed multi-scale pool; the first layer's maps captured."""
    kw = dict(embed_size=E, num_heads=HEADS, num_layers=2, top_k=16,
              attn_type=attn_type, max_seq_len=MAX_SEQ)
    jm, tm = JSVR(**kw), TSVR(**kw)
    x = _rand((2, 3, 10, E), 4)
    params = _pair(jm, tm, x)
    ref, state = jm.apply(params, jnp.asarray(x), capture_attention=True,
                          mutable=["intermediates"])
    with torch.no_grad():
        out = tm(torch.from_numpy(x), capture_attention=True)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * scale)
    layer = tm.layers[0]
    for name in ("spatial_attention", "temporal_attention"):
        np.testing.assert_allclose(
            getattr(layer, name).attn.numpy(),
            _sown(state, "layers_0", name), **TOL)
    assert tm.layers[1].spatial_attention.attn is None  # layer 0 only


@pytest.mark.parametrize("attn_type", ATTN_TYPES)
def test_tta(attn_type):
    jm = JTTA(E, 2, HEADS, attn_type=attn_type, max_seq_len=MAX_SEQ)
    tm = TTTA(E, 2, HEADS, attn_type=attn_type, max_seq_len=MAX_SEQ)
    q, vis, txt = _rand((2, 6, E), 5), _rand((2, 20, E), 6), _rand(
        (2, 7, E), 7)
    params = _pair(jm, tm, q, vis, txt)
    ref = jm.apply(params, jnp.asarray(q), jnp.asarray(vis),
                   jnp.asarray(txt))
    with torch.no_grad():
        out = tm(*map(torch.from_numpy, (q, vis, txt)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("attn_type", ATTN_TYPES)
def test_u2tokenizer(attn_type):
    """The whole μ²tokenizer of the tiny config with each attention."""
    jcfg = dataclasses.replace(JCfg.tiny().u2t, attn_type=attn_type)
    jm = JU2Tokenizer(128, jcfg)
    tm = TU2Tokenizer(128, TU2tCfg(**dataclasses.asdict(jcfg)))
    v, t = _rand((2, 2, 8, 128), 8), _rand((2, 6, 128), 9)
    params = _pair(jm, tm, v, t)
    ref = jm.apply(params, jnp.asarray(v), jnp.asarray(t))
    with torch.no_grad():
        out = tm(torch.from_numpy(v), torch.from_numpy(t))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_relative_position_bias_within_its_table():
    """Equal to the JAX lookup up to max_seq_len, the last offsets
    included."""
    table = _rand((2 * 16 - 1, 3), 10)
    for s in (1, 9, 16):
        np.testing.assert_array_equal(
            t_ops.relative_position_bias(torch.from_numpy(table), s,
                                         16).numpy(),
            np.asarray(j_ops.relative_position_bias(jnp.asarray(table), s,
                                                    16)))


def test_relative_position_bias_past_its_table_raises():
    """Known difference 15: past max_seq_len the JAX lookup gives NaN
    biases; the port raises before forming an index, and so does an 'rma'
    module over a longer sequence."""
    table = _rand((2 * 16 - 1, 3), 11)
    ref = np.asarray(j_ops.relative_position_bias(jnp.asarray(table), 20,
                                                  16))
    assert np.isnan(ref).any() and np.isfinite(ref[..., :16, :16]).all()
    with pytest.raises(ValueError, match="max_seq_len = 16"):
        t_ops.relative_position_bias(torch.from_numpy(table), 17, 16)
    tm = t_attn.RelativeMultiheadAttention(E, HEADS, max_seq_len=8)
    x = torch.from_numpy(_rand((1, 9, E), 12))
    with pytest.raises(ValueError, match="max_seq_len"):
        tm(x, x, x)


@pytest.mark.parametrize("s,pool", [(64, 2), (60, 2), (81, 3)])
def test_sequence_pool(s, pool):
    x = _rand((2, s, 5), 13)
    np.testing.assert_allclose(
        t_pool.sequence_pool(torch.from_numpy(x), pool).numpy(),
        np.asarray(j_pool.sequence_pool(jnp.asarray(x), pool)), **TOL)


def _vision(hidden=64):
    return dataclasses.replace(JCfg.tiny().vision, hidden_size=hidden)


@pytest.mark.parametrize("kind", ["spp_spatial", "spp_sequence", "linear",
                                  "spp_sequence_linear"])
def test_projector(kind):
    """The SPP projector with either pooling (mlp and linear stacks) and
    ``FullLinear`` (one Dense named ``linear``), over the tiny ViT's 64
    tokens."""
    jcfg = JCfg.tiny().projector
    if kind == "linear":
        jcfg = dataclasses.replace(jcfg, projector_type="linear")
    elif kind.startswith("spp_sequence"):
        jcfg = dataclasses.replace(
            jcfg, pooling_type="sequence",
            layer_type="linear" if kind.endswith("linear") else "mlp")
    tcfg = TProjCfg(**dataclasses.asdict(jcfg))
    vision = _vision()
    jm = j_proj.build_projector(jcfg, vision, 48)
    tm = t_proj.build_projector(tcfg, vision, 48)
    x = _rand((3, 64, 64), 14)
    params = _pair(jm, tm, x)
    if kind == "linear":
        assert set(params["params"]) == {"linear"}
        assert isinstance(tm, t_proj.FullLinear)
    ref = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_projector_names():
    """'identity' builds nothing; an unknown type, an unknown pooling, or
    an identity between unequal widths raises."""
    tcfg = TProjCfg()
    vision = _vision(128)
    assert j_proj.build_projector(dataclasses.replace(
        JCfg().projector, projector_type="identity"), vision, 128) is None
    assert t_proj.build_projector(dataclasses.replace(
        tcfg, projector_type="identity"), vision, 128) is None
    with pytest.raises(ValueError, match="widths must be equal"):
        t_proj.build_projector(dataclasses.replace(
            tcfg, projector_type="identity"), vision, 96)
    with pytest.raises(ValueError, match="Unknown projector type"):
        t_proj.build_projector(dataclasses.replace(
            tcfg, projector_type="mlp"), vision, 128)
    with pytest.raises(ValueError, match="Unknown pooling type"):
        t_proj.build_projector(dataclasses.replace(
            tcfg, pooling_type="max"), vision, 128)


def test_reference_in_proj_layout_into_vanilla():
    """A checkpoint trained with ``enable_rpe: false`` keeps the reference's
    ``nn.MultiheadAttention`` layout (fused ``in_proj`` and
    ``out_proj``): the port's converter splits it, and the vanilla module
    it loads into equals the JAX package's on the same state dict and
    torch's own module fed the same batch-first tensors seq-first."""
    mha = torch.nn.MultiheadAttention(E, HEADS)
    g = torch.Generator().manual_seed(16)
    with torch.no_grad():
        for p in mha.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    sd = {k: v.numpy() for k, v in mha.state_dict().items()}
    t_flat = flatten(t_hf._attn_params(sd, ""))
    j_flat = flatten(j_hf._attn_params(sd, ""))
    assert t_flat.keys() == j_flat.keys()
    for k in t_flat:
        np.testing.assert_array_equal(t_flat[k], j_flat[k])
    tm = t_attn.VanillaMultiheadAttention(E, HEADS)
    load_flax_params(tm, t_flat)
    x = _rand((2, 10, E), 17)
    ref = j_attn.VanillaMultiheadAttention(E, HEADS).apply(
        _tree(j_flat), *[jnp.asarray(x)] * 3)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out = tm(xt, xt, xt)
        seq_first = xt.transpose(0, 1)
        torch_ref = mha(seq_first, seq_first, seq_first)[0].transpose(0, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out.numpy(), torch_ref.numpy(), **TOL)
