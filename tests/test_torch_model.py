"""Module and whole-model parity of the PyTorch port with the JAX package on
``U2ModelConfig.tiny()``, in fp32 on the CPU.

One set of flax parameters (zero-initialised biases, relative-position
tables and the cls token re-drawn from a numpy seed, so that every
parameter matters) goes into both models, the port's through
``load_flax_params``. Inputs come from a numpy seed.
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
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.weights import load_flax_params, torch_name
from u2tokenizer_tpu.config import GenerationConfig as JGen
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.models import generate as j_generate
from u2tokenizer_tpu.models.u2_model import U2CausalLM as JModel

pytestmark = pytest.mark.fast

# fp32 through 2 ViT, 2+2 μ²tokenizer and 2 decoder layers
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, SQ = 2, 24, 6
PROMPT_LEN = np.array([24, 19], np.int32)


@pytest.fixture(scope="module")
def pair():
    jcfg = JCfg.tiny()
    tcfg = TCfg.from_dict(dataclasses.asdict(jcfg))
    rs = np.random.RandomState(0)
    d, h, w = jcfg.vision.input_spatial
    inputs = {
        "images": rs.randn(B, jcfg.num_chunks, d, h, w).astype(np.float32),
        "ids": rs.randint(0, jcfg.llm.vocab_size, (B, S)).astype(np.int32),
        "qids": rs.randint(0, jcfg.llm.vocab_size, (B, SQ)).astype(np.int32),
    }
    jm = JModel(jcfg, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(inputs["ids"]),
                     jnp.asarray(inputs["images"]), jnp.asarray(inputs["qids"]))
    flat = {k: np.array(v) for k, v in
            traverse_util.flatten_dict(params["params"], sep="/").items()}
    for k in flat:
        if k.endswith(("bias", "cls_token")):
            flat[k] = (rs.randn(*flat[k].shape) * 0.1).astype(np.float32)
    params = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
    tm = TModel(tcfg, dtype=torch.float32, device="cpu")
    load_flax_params(tm, flat)
    return jm, params, tm, flat, inputs


def _close(out, ref):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


def test_vit_tower(pair):
    jm, params, tm, _, inputs = pair
    chunks = inputs["images"].reshape(-1, 1, *inputs["images"].shape[2:])
    ref = jm.apply(params, jnp.asarray(chunks),
                   method=lambda m, x: m.vision_tower(x))
    with torch.no_grad():
        out = tm.vision_tower(torch.from_numpy(chunks))
    assert out.shape == ref.shape  # cls token stripped
    _close(out, ref)


def test_projector(pair):
    jm, params, tm, _, _ = pair
    feats = np.random.RandomState(1).randn(3, 64, 64).astype(np.float32)
    ref = jm.apply(params, jnp.asarray(feats),
                   method=lambda m, x: m.mm_projector(x))
    with torch.no_grad():
        out = tm.mm_projector(torch.from_numpy(feats))
    _close(out, ref)


def test_u2tokenizer(pair):
    jm, params, tm, _, _ = pair
    rs = np.random.RandomState(2)
    v = rs.randn(B, 2, 8, 128).astype(np.float32)  # untied top-k scores
    t = rs.randn(B, SQ, 128).astype(np.float32)
    ref = jm.apply(params, jnp.asarray(v), jnp.asarray(t),
                   method=lambda m, a, b: m.u2tokenizer(a, b))
    with torch.no_grad():
        out = tm.u2tokenizer(torch.from_numpy(v), torch.from_numpy(t))
    _close(out, ref)


def test_decoder_logits_right_padded(pair):
    """Text-only decoder forward over a right-padded batch: the port takes
    the flash path (its plain version here), the JAX package the masked
    GQA attention; padded query rows agree too."""
    jm, params, tm, _, _ = pair
    emb = np.random.RandomState(3).randn(B, S, 128).astype(np.float32)
    att = (np.arange(S)[None, :] < PROMPT_LEN[:, None]).astype(np.int32)
    ref, _, _ = jm.apply(params, jnp.asarray(emb), jnp.asarray(att),
                         method="forward_embeds")
    with torch.no_grad():
        out, _, _ = tm.forward_embeds(torch.from_numpy(emb),
                                      torch.from_numpy(att))
    _close(out, ref)


def test_full_model_logits(pair):
    jm, params, tm, _, inputs = pair
    ref, _, _ = jm.apply(params, jnp.asarray(inputs["ids"]),
                         jnp.asarray(inputs["images"]),
                         jnp.asarray(inputs["qids"]))
    with torch.no_grad():
        out, _, _ = tm(torch.from_numpy(inputs["ids"]).long(),
                       torch.from_numpy(inputs["images"]),
                       torch.from_numpy(inputs["qids"]).long())
    assert out.dtype == torch.float32
    _close(out, ref)


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_greedy_tokens_match(pair, cache):
    jm, params, tm, _, inputs = pair
    jgen = JGen(max_new_tokens=5, eos_token_id=-2)
    tgen = TGen(**dataclasses.asdict(jgen))
    jfn = j_generate.make_multimodal_generate_fn(
        jm, jgen, cache_dtype=jnp.float32 if cache == "float32" else "int8")
    ref = jfn(params, jnp.asarray(inputs["ids"]),
              jnp.asarray(inputs["images"]), jnp.asarray(inputs["qids"]),
              jnp.asarray(PROMPT_LEN), jax.random.PRNGKey(1))
    tfn = t_generate.make_multimodal_generate_fn(
        tm, tgen, cache_dtype=torch.float32 if cache == "float32" else "int8")
    out = tfn(torch.from_numpy(inputs["ids"]).long(),
              torch.from_numpy(inputs["images"]),
              torch.from_numpy(inputs["qids"]).long(),
              torch.from_numpy(PROMPT_LEN))
    assert out.shape == (B, 5) and out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_eos_then_pad(pair):
    """A row that emits EOS emits pad_token_id from then on."""
    _, _, tm, _, inputs = pair
    free = t_generate.make_multimodal_generate_fn(
        tm, TGen(max_new_tokens=4, eos_token_id=-2), cache_dtype=torch.float32)
    args = (torch.from_numpy(inputs["ids"]).long(),
            torch.from_numpy(inputs["images"]),
            torch.from_numpy(inputs["qids"]).long(),
            torch.from_numpy(PROMPT_LEN))
    first = free(*args)
    row = next(r for r in range(B) if first[r, 1] != first[r, 0])
    eos = int(first[row, 1])  # the row's second token, not its first
    stopped = t_generate.make_multimodal_generate_fn(
        tm, TGen(max_new_tokens=4, eos_token_id=eos, pad_token_id=7),
        cache_dtype=torch.float32)(*args)
    assert stopped[row, :2].tolist() == first[row, :2].tolist()
    assert stopped[row, 2:].tolist() == [7, 7]


def test_microbatched_vision_equals_one_shot(pair):
    _, _, tm, _, inputs = pair
    args = (torch.from_numpy(inputs["ids"]).long(),
            torch.from_numpy(inputs["images"]),
            torch.from_numpy(inputs["qids"]).long())
    one = t_generate._microbatched_embeds(tm, *args, vision_microbatch=128)
    groups = t_generate._microbatched_embeds(tm, *args, vision_microbatch=2)
    torch.testing.assert_close(groups, one, rtol=1e-5, atol=1e-5)


def test_load_flax_params_is_strict(pair):
    _, _, tm, flat, _ = pair
    modules = dict(tm.named_modules())
    assert torch_name("llm/model/layers_1/self_attn/q_proj/kernel",
                      modules) == ("llm.model.layers.1.self_attn.q_proj.weight",
                                   True)
    assert torch_name("vision_tower/vision_tower/blocks_0/norm1/scale",
                      modules) == (
        "vision_tower.vision_tower.blocks.0.norm1.weight", False)
    assert torch_name("vision_tower/vision_tower/patch_embedding/proj/kernel",
                      modules) == (
        "vision_tower.vision_tower.patch_embedding.proj.kernel", False)
    short = dict(flat)
    short.pop("llm/model/norm/weight")
    with pytest.raises(KeyError):
        load_flax_params(tm, short)
    bad = dict(flat)
    bad["llm/model/norm/weight"] = np.ones(3, np.float32)
    with pytest.raises(ValueError):
        load_flax_params(tm, bad)
    load_flax_params(tm, flat)  # leave the shared model as it was
