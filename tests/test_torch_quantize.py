"""Weight-only int8/int4 quantization of the PyTorch port against the JAX
package's, on the CPU, on ``U2ModelConfig.tiny()``.

One set of flax parameters (biases re-drawn from a numpy seed so that they
matter) is quantized by both packages: the JAX package's
``quantize_llm_weights`` on the tree, the port's on a model that loaded the
same float tree. Integers and scales are compared bit for bit, products at
fp32 with a stated tolerance, greedy tokens for equality.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from u2tokenizer_torch.config import GenerationConfig as TGen
from u2tokenizer_torch.config import U2ModelConfig as TCfg
from u2tokenizer_torch.models import generate as t_generate
from u2tokenizer_torch.models import quantize as t_quant
from u2tokenizer_torch.models.llm import decoder as t_dec
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.weights import flax_path, load_flax_params, torch_name
from u2tokenizer_tpu.config import GenerationConfig as JGen
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.models import generate as j_generate
from u2tokenizer_tpu.models import quantize as j_quant
from u2tokenizer_tpu.models.llm import decoder as j_dec
from u2tokenizer_tpu.models.u2_model import U2CausalLM as JModel

pytestmark = pytest.mark.fast

# fp32 through 2 ViT, 2+2 μ²tokenizer and 2 decoder layers, as the float
# model's parity tests (tests/test_torch_model.py)
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, SQ = 2, 24, 6
PROMPT_LEN = np.array([24, 19], np.int32)


def _flat(params):
    return {k: np.array(v) for k, v in
            traverse_util.flatten_dict(params["params"], sep="/").items()}


def _tree(flat):
    return {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}


@pytest.fixture(scope="module")
def float_pair():
    """The JAX model, its float parameters (flat) and the inputs."""
    jcfg = JCfg.tiny()
    rs = np.random.RandomState(0)
    d, h, w = jcfg.vision.input_spatial
    inputs = {
        "images": rs.randn(B, jcfg.num_chunks, d, h, w).astype(np.float32),
        "ids": rs.randint(0, jcfg.llm.vocab_size, (B, S)).astype(np.int32),
        "qids": rs.randint(0, jcfg.llm.vocab_size, (B, SQ)).astype(np.int32),
    }
    params = JModel(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.asarray(inputs["ids"]),
        jnp.asarray(inputs["images"]), jnp.asarray(inputs["qids"]))
    flat = _flat(params)
    for k in flat:
        if k.endswith(("bias", "cls_token")):
            flat[k] = (rs.randn(*flat[k].shape) * 0.1).astype(np.float32)
    return jcfg, flat, inputs


def _port(jcfg, flat, mode=None):
    """The port's model with ``flat`` loaded, built quantized when
    ``mode`` names a mode."""
    cfg = TCfg.from_dict(dataclasses.asdict(jcfg))
    if mode:
        cfg = t_quant.quantized_llm_config(cfg, mode)
    model = TModel(cfg, dtype=torch.float32, device="cpu")
    load_flax_params(model, flat)
    return model


def _assert_state_is(model, flat):
    """Every parameter of ``model`` equals its entry of ``flat`` bit for
    bit (2-D Dense kernels transposed), integers as integers."""
    modules = dict(model.named_modules())
    state = dict(model.named_parameters())
    assert len(state) == len(flat)
    for name, p in state.items():
        path = flax_path(name, modules)[len("params/"):]
        assert torch_name(path, modules)[0] == name
        want = np.asarray(flat[path])
        got = p.detach()
        if torch_name(path, modules)[1]:
            got = got.t()
        if want.dtype.kind in "iu":
            assert got.dtype == torch.int8, name
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        else:
            np.testing.assert_array_equal(got.float().numpy(),
                                          want.astype(np.float32),
                                          err_msg=name)


def test_pack_int4_weights_bit_equal():
    """(ng, g, out) -> (ng, g/2, out) along the group axis, low nibble the
    even index, and back with sign extension, as the JAX package packs."""
    q = np.random.RandomState(1).randint(-8, 8, (3, 128, 40)).astype(np.int8)
    jp = np.asarray(j_dec.pack_int4(jnp.asarray(q)))
    tp = t_dec.pack_int4(torch.from_numpy(q))
    assert tp.shape == (3, 64, 40) and tp.dtype == torch.int8
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(t_dec.unpack_int4(tp).numpy(),
                                  np.asarray(j_dec.unpack_int4(
                                      jnp.asarray(jp))))
    np.testing.assert_array_equal(t_dec.unpack_int4(tp).numpy(), q)
    for n in (128, 256, 200, 7):
        assert t_dec.int4_group(n) == j_dec.int4_group(n)


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("cast", [False, True], ids=["fp32", "bf16-cast"])
def test_quantize_llm_weights_bit_equal(float_pair, mode, cast):
    """The port's in-place quantization of a loaded model gives the JAX
    package's integers and scales bit for bit, from fp32 weights and from
    weights first cast for serving; the config then names the mode."""
    jcfg, flat, _ = float_pair
    params = _tree(flat)
    model = _port(jcfg, flat)
    if cast:
        params = j_quant.cast_for_inference(params)
        t_quant.cast_for_inference(model)
    want = _flat(j_quant.quantize_llm_weights(params, mode))
    assert t_quant.quantize_llm_weights(model, mode) is model
    _assert_state_is(model, want)
    assert model.cfg.llm.quantized_weights == mode
    assert model.llm.model.layers[0].self_attn.cfg.quantized_weights == mode
    with pytest.raises(ValueError):
        t_quant.quantize_llm_weights(model, mode)


@pytest.mark.parametrize("mode,tokens,out_tiles", [
    ("int8", 5, 0),
    ("int8", 160, 4),     # out-dim tiles from 128 tokens on
    ("int4", 5, 0),       # fewer tokens than the group: per-group partials
    ("int4", 160, 0),     # from g tokens on: dequantize, one contraction
])
def test_qdense_matches_jax(mode, tokens, out_tiles):
    """``QDense`` against the JAX package's at fp32, over 2 groups of 128
    inputs (rtol 1e-5: sums of 256 products in another order)."""
    rs = np.random.RandomState(2)
    x = rs.randn(tokens, 256).astype(np.float32)
    kernel = (rs.randn(256, 96) * 0.05).astype(np.float32)
    if mode == "int4":
        q, scale = j_quant._quantize_kernel_int4(jnp.asarray(kernel))
    else:
        q, scale = j_quant._quantize_channels(jnp.asarray(kernel), axis=1)
        scale = scale.reshape(-1)
    flat = {"kernel": np.asarray(q), "scale": np.asarray(scale),
            "bias": rs.randn(96).astype(np.float32)}
    jlayer = j_dec.QDense(96, dtype=jnp.float32, quantized=mode,
                          out_tiles=out_tiles)
    ref = jlayer.apply(_tree(flat), jnp.asarray(x))
    layer = t_dec.QDense(256, 96, True, torch.float32, "cpu", mode, out_tiles)
    load_flax_params(layer, flat)
    assert not layer.weight.requires_grad
    assert set(layer.state_dict()) == {"weight", "scale", "bias"}
    with torch.no_grad():
        out = layer(torch.from_numpy(x))
    assert out.is_contiguous()  # q, k and v go to the kernels as they are
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_load_flax_params_quantized_tree(float_pair, mode):
    """A model built quantized loads the JAX package's quantized tree with
    its dtypes (int8 and packed int4 kernels, int8 table, fp32 scales);
    a float model refuses it, and the quantized model a float tree."""
    jcfg, flat, _ = float_pair
    qflat = _flat(j_quant.quantize_llm_weights(_tree(flat), mode))
    model = _port(jcfg, qflat, mode)
    _assert_state_is(model, qflat)
    float_model = _port(jcfg, flat)
    with pytest.raises((TypeError, KeyError)):
        load_flax_params(float_model, qflat)
    with pytest.raises((TypeError, KeyError)):
        load_flax_params(model, flat)


def _jax_quantized(jcfg, flat, mode):
    jm = JModel(j_quant.quantized_llm_config(jcfg, mode), dtype=jnp.float32)
    return jm, j_quant.quantize_llm_weights(_tree(flat), mode)


@pytest.mark.parametrize("mode,seq", [
    ("int8", 24), ("int8", 72), ("int4", 24), ("int4", 72)],
    ids=["int8", "int8-144-tokens", "int4-partials", "int4-dequantized"])
def test_decoder_logits_quantized(float_pair, mode, seq):
    """Decoder logits (the tied head with the row scales) over a
    right-padded batch: 48 tokens take int4's per-group form, 144 its
    dequantized one."""
    jcfg, flat, _ = float_pair
    jm, params = _jax_quantized(jcfg, flat, mode)
    model = t_quant.quantize_llm_weights(_port(jcfg, flat), mode)
    emb = np.random.RandomState(3).randn(B, seq, 128).astype(np.float32)
    att = (np.arange(seq)[None, :] < np.array([seq, seq - 5])[:, None]
           ).astype(np.int32)
    ref, _, _ = jm.apply(params, jnp.asarray(emb), jnp.asarray(att),
                         method="forward_embeds")
    with torch.no_grad():
        out, _, _ = model.forward_embeds(torch.from_numpy(emb),
                                         torch.from_numpy(att))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_full_model_logits_quantized(float_pair, mode):
    """The whole model with quantized decoder weights: quantized embedding
    lookup of the prompt and the question, the decoder, the head."""
    jcfg, flat, inputs = float_pair
    jm, params = _jax_quantized(jcfg, flat, mode)
    model = t_quant.quantize_llm_weights(_port(jcfg, flat), mode)
    ref, _, _ = jm.apply(params, jnp.asarray(inputs["ids"]),
                         jnp.asarray(inputs["images"]),
                         jnp.asarray(inputs["qids"]))
    with torch.no_grad():
        out, _, _ = model(torch.from_numpy(inputs["ids"]).long(),
                          torch.from_numpy(inputs["images"]),
                          torch.from_numpy(inputs["qids"]).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("mode,cache", [
    ("int8", "int4"), ("int4", "int4")])
def test_greedy_tokens_quantized(float_pair, mode, cache):
    """The serving configuration, quantized weights and the int4 cache:
    greedy tokens equal to the JAX package's generate."""
    jcfg, flat, inputs = float_pair
    jm, params = _jax_quantized(jcfg, flat, mode)
    jgen = JGen(max_new_tokens=6, eos_token_id=-2)
    ref = j_generate.make_multimodal_generate_fn(jm, jgen, cache_dtype=cache)(
        params, jnp.asarray(inputs["ids"]), jnp.asarray(inputs["images"]),
        jnp.asarray(inputs["qids"]), jnp.asarray(PROMPT_LEN),
        jax.random.PRNGKey(1))
    model = t_quant.quantize_llm_weights(_port(jcfg, flat), mode)
    out = t_generate.make_multimodal_generate_fn(
        model, TGen(**dataclasses.asdict(jgen)), cache_dtype=cache)(
        torch.from_numpy(inputs["ids"]).long(),
        torch.from_numpy(inputs["images"]),
        torch.from_numpy(inputs["qids"]).long(), torch.from_numpy(PROMPT_LEN))
    assert out.shape == (B, 6) and out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_dequantize_round_trip(float_pair, mode):
    """``dequantize_llm_weights`` gives the JAX package's fp32 weights bit
    for bit; quantizing them again gives the same integers and scales."""
    jcfg, flat, _ = float_pair
    qtree = j_quant.quantize_llm_weights(_tree(flat), mode)
    model = t_quant.quantize_llm_weights(_port(jcfg, flat), mode)
    assert t_quant.dequantize_llm_weights(model) is model
    assert not model.cfg.llm.quantized_weights
    assert not model.llm.model.quantized
    _assert_state_is(model, _flat(j_quant.dequantize_llm_weights(qtree)))
    t_quant.quantize_llm_weights(model, mode)
    _assert_state_is(model, _flat(qtree))


def test_quantized_llm_config_matches_jax():
    for mode in (True, "int8", "int4"):
        want = dataclasses.asdict(j_quant.quantized_llm_config(JCfg.tiny(),
                                                               mode))
        got = t_quant.quantized_llm_config(TCfg.tiny(), mode)
        assert dataclasses.asdict(got) == want
        assert (dataclasses.asdict(t_quant.quantized_llm_config(
            TCfg.tiny().llm, mode)) == want["llm"])
