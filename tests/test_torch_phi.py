"""The Phi family in the PyTorch port against the JAX package, on the CPU:
the decoders, the HF converters, the presets and ``cli green --judge``.

Tiny configurations of the two Phi presets: a Phi-2 shape (2 layers,
hidden 160 = 2 heads of 80, partial rotary 0.4, LayerNorm, tanh-GELU MLP,
biases on every projection and the LM head, parallel blocks) and a Phi-3
shape (hidden 192 = 2 heads of 96, MHA, untied head). One set of flax
parameters (biases and LayerNorm scales re-drawn from a numpy seed, so
that each matters) goes into both packages, the port's through
``load_flax_params``; inputs come from numpy seeds.

Held here: the decoders' logits (fp32, 1e-4 as ``test_torch_model.py``)
and greedy tokens over the bf16, int8 and int4 caches (equal); the HF
converters and ``llm_config_from_hf`` (exact); the presets (field for
field); and ``cli green --judge`` on a Phi-2 directory (config and loaded
weights exact, replies the port's greedy generate's).
``tests/test_torch_phi_u2.py`` holds μ²Phi-3: ``U2CausalLM`` and ``cli
generate --checkpoint``.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from u2tokenizer_torch import cli as t_cli
from u2tokenizer_torch.config import GenerationConfig as TGen
from u2tokenizer_torch.config import LLMConfig as TLLM
from u2tokenizer_torch.models import generate as t_generate
from u2tokenizer_torch.models import hf_export as t_export
from u2tokenizer_torch.models import hf_weights as t_hf
from u2tokenizer_torch.models.llm.decoder import CausalLM as TLM
from u2tokenizer_torch.models.llm.decoder import rope_dim
from u2tokenizer_torch.models.safetensors_io import write_safetensors
from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer
from u2tokenizer_torch.weights import flatten, flax_params, load_flax_params
from u2tokenizer_tpu.config import GenerationConfig as JGen
from u2tokenizer_tpu.config import LLMConfig as JLLM
from u2tokenizer_tpu.models import generate as j_generate
from u2tokenizer_tpu.models import hf_export as j_export
from u2tokenizer_tpu.models import hf_weights as j_hf
from u2tokenizer_tpu.models.llm.decoder import CausalLM as JLM

pytestmark = pytest.mark.fast

TOL = dict(rtol=1e-4, atol=1e-4)  # fp32 through 2 decoder layers
B, S, NEW = 2, 12, 6
PLEN = np.array([S, 9], np.int32)
SHAPES = {
    "phi2": lambda c: dataclasses.replace(
        c.phi2(vocab_size=512), hidden_size=160, intermediate_size=320,
        num_layers=2, num_heads=2, num_kv_heads=2),
    "phi3": lambda c: dataclasses.replace(
        c.phi3_mini(vocab_size=512), hidden_size=192, intermediate_size=256,
        num_layers=2, num_heads=2, num_kv_heads=2),
}
# config.json of each family as its HF checkpoints write it
HF_CONFIGS = {
    "phi2": lambda c: {
        "model_type": "phi", "vocab_size": c.vocab_size,
        "hidden_size": c.hidden_size,
        "intermediate_size": c.intermediate_size,
        "num_hidden_layers": c.num_layers,
        "num_attention_heads": c.num_heads, "num_key_value_heads": None,
        "partial_rotary_factor": c.partial_rotary_factor,
        "rope_theta": c.rope_theta, "layer_norm_eps": c.rms_norm_eps,
        "tie_word_embeddings": False,
        "max_position_embeddings": c.max_position_embeddings},
    "phi3": lambda c: {
        "model_type": "phi3", "vocab_size": c.vocab_size,
        "hidden_size": c.hidden_size,
        "intermediate_size": c.intermediate_size,
        "num_hidden_layers": c.num_layers,
        "num_attention_heads": c.num_heads,
        "num_key_value_heads": c.num_kv_heads, "rope_theta": c.rope_theta,
        "rms_norm_eps": c.rms_norm_eps, "sliding_window": 2047,
        "tie_word_embeddings": False,
        "max_position_embeddings": c.max_position_embeddings},
}


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _flat(params):
    return {k: np.array(v) for k, v in
            traverse_util.flatten_dict(params["params"], sep="/").items()}


def _tree(flat):
    return {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}


def _redraw(flat, seed):
    """Biases re-drawn (0.1 sigma) and LayerNorm scales about 1, so that
    every parameter moves the output."""
    rs = np.random.RandomState(seed)
    for k, v in flat.items():
        if k.endswith("bias") or k.endswith("cls_token"):
            flat[k] = (rs.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("layernorm/scale") or k == "model/norm/scale":
            flat[k] = (1.0 + rs.randn(*v.shape) * 0.1).astype(np.float32)
    return flat


def _same(jcfg):
    return TLLM(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module", params=["phi2", "phi3"])
def decoder(request):
    """(family, JAX config, JAX model, params, port model, embeddings)."""
    jcfg = SHAPES[request.param](JLLM)
    jm = JLM(jcfg, dtype=jnp.float32)
    emb = _rand((B, S, jcfg.hidden_size), 1)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(emb),
                     jnp.zeros((B, S), jnp.int32),
                     jnp.ones((B, 1, S, S), bool))
    flat = _redraw(_flat(params), 3)
    tm = TLM(_same(jcfg), dtype=torch.float32, device="cpu")
    load_flax_params(tm, flat)
    return request.param, jcfg, jm, _tree(flat), tm, emb


def test_decoder_modules(decoder):
    """The Phi-2 tree has LayerNorm, fc1/fc2 with biases, biased attention
    projections and head, and no post-attention norm; RoPE turns 32 of
    Phi-2's 80 dims and all of Phi-3's 96."""
    family, jcfg, _, _, tm, _ = decoder
    names = dict(tm.named_parameters())
    layer = "model.layers.0."
    if family == "phi2":
        assert rope_dim(tm.cfg) == 32
        for n in ("input_layernorm.bias", "mlp.fc1.bias", "mlp.fc2.bias",
                  "self_attn.o_proj.bias", "self_attn.q_proj.bias"):
            assert layer + n in names
        assert "lm_head.bias" in names and "model.norm.bias" in names
        assert not any("post_attention" in n or "gate_proj" in n
                       for n in names)
    else:
        assert rope_dim(tm.cfg) == 96
        assert layer + "post_attention_layernorm.weight" in names
        assert not any(n.endswith("bias") for n in names)


def test_decoder_logits_right_padded(decoder):
    """Text-only forward over a right-padded batch: the port takes its
    flash path (the plain version here), the JAX package the masked
    attention; padded query rows agree too."""
    _, _, jm, params, tm, emb = decoder
    att = (np.arange(S)[None, :] < PLEN[:, None]).astype(np.int32)
    ref, _, _ = jm.apply(params, jnp.asarray(emb), jnp.asarray(att),
                         method="forward_embeds")
    with torch.no_grad():
        out, _, _ = tm.forward_embeds(torch.from_numpy(emb),
                                      torch.from_numpy(att))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("cache", ["bfloat16", "int8", "int4"])
def test_decoder_greedy_tokens(decoder, cache):
    """Greedy tokens over each cache equal the JAX package's generate;
    the port's quantized caches decode through K3's plain version."""
    _, _, jm, params, tm, emb = decoder
    jgen = JGen(max_new_tokens=NEW, eos_token_id=-2)
    jdtype = jnp.bfloat16 if cache == "bfloat16" else cache
    tdtype = torch.bfloat16 if cache == "bfloat16" else cache
    ref = j_generate.make_generate_fn(jm, jgen, cache_dtype=jdtype)(
        params, jnp.asarray(emb), jnp.asarray(PLEN), jax.random.PRNGKey(0))
    out = t_generate.make_generate_fn(
        tm, TGen(**dataclasses.asdict(jgen)), cache_dtype=tdtype)(
        torch.from_numpy(emb), torch.from_numpy(PLEN))
    assert out.shape == (B, NEW)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _hf_state_dict(family, seed=6):
    """A seeded HF state dict of the tiny decoder, as the JAX package's
    exporter writes it (Phi-3: fused qkv_proj and gate_up_proj; Phi-2:
    self_attn.dense, fc1/fc2, final_layernorm, biases)."""
    jcfg = SHAPES[family](JLLM)
    params = JLM(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4, jcfg.hidden_size)),
        jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 1, 4, 4), bool))
    tree = _tree(_redraw(_flat(params), seed))["params"]
    sd = {}
    j_export.export_decoder(tree, jcfg, sd)
    return jcfg, tree, {k: np.asarray(v) for k, v in sd.items()}


def _assert_trees_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg=k)


@pytest.mark.parametrize("family", ["phi2", "phi3"])
def test_converters_match_jax(family):
    """export_decoder gives the JAX exporter's state dict key for key;
    convert_decoder over it gives the JAX converter's tree; both
    llm_config_from_hf read config.json alike."""
    jcfg, tree, sd = _hf_state_dict(family)
    mine = {}
    t_export.export_decoder(jax.tree_util.tree_map(np.asarray, tree),
                            _same(jcfg), mine)
    assert sorted(mine) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(mine[k], sd[k], err_msg=k)
    if family == "phi2":
        assert "model.final_layernorm.bias" in sd and "lm_head.bias" in sd
    else:
        assert "model.layers.0.self_attn.qkv_proj.weight" in sd
        assert "model.layers.0.mlp.gate_up_proj.weight" in sd
    _assert_trees_equal(t_hf.convert_decoder(sd, _same(jcfg)),
                        j_hf.convert_decoder(sd, jcfg))
    hf = HF_CONFIGS[family](jcfg)
    got = dataclasses.asdict(t_hf.llm_config_from_hf(hf))
    assert got == dataclasses.asdict(j_hf.llm_config_from_hf(hf))
    assert got == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("preset", ["phi3_mini", "phi2"])
def test_presets_match_jax(preset):
    assert dataclasses.asdict(getattr(TLLM, preset)()) == \
        dataclasses.asdict(getattr(JLLM, preset)())


@pytest.fixture(autouse=True)
def no_sentence_transformers(monkeypatch):
    """The JAX package's GREEN summary embeds with TF-IDF, never a
    download."""
    monkeypatch.setitem(sys.modules, "sentence_transformers", None)


def _run(argv, **kw):
    args = t_cli.build_parser().parse_args(argv)
    return args.fn(args, **kw)


def test_cli_green_with_a_phi2_judge(tmp_path, monkeypatch):
    """``cli green --judge DIR`` on a Phi-2 HF directory (bf16 weights,
    HF Phi-2 config.json): the judge's config is the JAX converter's, its
    weights the JAX converter's rounded to bf16, its greedy replies those
    of the port's plain generate on the same model, and every sample is
    scored and sorted."""
    from u2tokenizer_torch.eval.green import TorchJudge

    jcfg, _, sd = _hf_state_dict("phi2")
    judge_dir = tmp_path / "judge"
    judge_dir.mkdir()
    write_safetensors(str(judge_dir / "model.safetensors"),
                      {k: torch.from_numpy(np.array(v)).to(torch.bfloat16)
                       for k, v in sd.items()})
    hf = HF_CONFIGS["phi2"](jcfg)
    (judge_dir / "config.json").write_text(json.dumps(hf))
    preds = tmp_path / "preds.jsonl"
    preds.write_text(json.dumps({
        "image": "a", "question": "q", "answer": "clear lungs and heart",
        "predictions": ["clear lungs", "a small effusion",
                        "normal heart"]}) + "\n")
    built, replies = [], []
    build, tokens_of = t_cli._build_judge, TorchJudge.batch_tokens

    def spy(args, tokenizer=None):
        built.append(build(args, tokenizer))
        built[-1].gen_cfg = dataclasses.replace(built[-1].gen_cfg,
                                                max_new_tokens=6)
        built[-1].max_length = 256
        return built[-1]

    def tokens(judge, ids, lens, split):
        replies.append((ids, lens, tokens_of(judge, ids, lens, split)))
        return replies[-1][2]

    monkeypatch.setattr(t_cli, "_build_judge", spy)
    monkeypatch.setattr(TorchJudge, "batch_tokens", tokens)
    out = tmp_path / "greened.jsonl"
    _run(["green", "--predictions", str(preds), "--judge", str(judge_dir),
          "--output", str(out), "--device", "cpu", "--no-summary"],
         tokenizer=MockTokenizer())
    judge = built[0]
    assert dataclasses.asdict(judge.model.cfg) == dataclasses.asdict(
        j_hf.llm_config_from_hf(hf))
    want = flatten(j_hf.convert_decoder(
        {k: torch.from_numpy(np.array(v)).bfloat16().float().numpy()
         for k, v in sd.items()}, jcfg))
    got = flatten(flax_params(judge.model))
    assert sorted(got) == sorted(want)
    for k in want:
        w = torch.from_numpy(np.asarray(want[k]))
        if w.dim() >= 2:  # cast_for_inference: matrices bf16
            w = w.bfloat16().float()
        np.testing.assert_array_equal(got[k], w.numpy(), err_msg=k)
    plain = t_generate.make_generate_fn(judge.model, judge.gen_cfg)
    for ids, lens, toks in replies:
        ref = plain(judge.model.embed_tokens(ids), lens)
        np.testing.assert_array_equal(toks.numpy(), ref.numpy())
    row = json.loads(out.read_text())
    assert sorted(row["predictions"]) == sorted(
        ["clear lungs", "a small effusion", "normal heart"])
    assert len(row["green_scores"]) == 3


@pytest.mark.parametrize("d", [16, 32, 64, 80, 96, 128, 48, 112])
def test_kernel_wrappers_take_phi_head_dims(d):
    """The CUDA wrappers' operand checks, made before a launch: the flash
    forward (K1/K2) and the flash backward (K4a-c) take D in {16, 32, 64,
    80, 96, 128}, the decode kernel (K3) D in {32, 64, 80, 96, 128}; any other
    D raises."""
    from u2tokenizer_torch.ops import decode_attention as t_dec
    from u2tokenizer_torch.ops import flash_attention as t_flash

    b, s, h = 2, 16, 4
    q = torch.zeros(b, s, h, d, dtype=torch.bfloat16)
    lens = torch.full((b,), s, dtype=torch.int32)
    for dims in (t_flash.FWD_HEAD_DIMS, t_flash.BWD_HEAD_DIMS):
        if d in dims:
            t_flash._check_attention(q, q, q, lens, dims)
        else:
            with pytest.raises(ValueError, match="head dim"):
                t_flash._check_attention(q, q, q, lens, dims)
    assert t_flash.FWD_HEAD_DIMS == (16, 32, 64, 80, 96, 128)
    assert t_flash.BWD_HEAD_DIMS == (16, 32, 64, 80, 96, 128)
    cache = torch.zeros(b, h, s, d, dtype=torch.int8)
    scales = torch.zeros(b, h, s, dtype=torch.bfloat16)
    args = (q[:, :1].contiguous(), cache, scales, cache, scales, lens, lens)
    if d in t_dec.HEAD_DIMS:
        assert t_dec.check_operands(*args) == "decode_attention_int8"
    else:
        with pytest.raises(ValueError, match="not supported"):
            t_dec.check_operands(*args)
