"""μ²Qwen3-8B's geometry in the port against the JAX package's, on the CPU.

``LLMConfig.qwen3_8b()`` field for field, then its geometry at narrow
width: an untied head tiled in 8 (``lm_head_tiles``, as the JAX package's
8B QLoRA tool sets it), GQA with a group of 4 (8 query heads over 2 KV
heads) at head dim 128, two layers, under the tiny vision stack. Held:

  * the decoder's forward logits (``forward_embeds`` over a right-padded
    batch) within 1e-5 in fp32;
  * int8 weights with the int4 KV cache (``bench.py``'s 8B serving
    configuration): greedy tokens equal;
  * an int4 QLoRA step with the tiled int8 head, over 128 tokens so that
    the head runs tiled: the loss within 1e-5 and every trainable leaf's
    gradient within RTOL of its largest element (U2T_RTOL in the
    μ²tokenizer, SCORE_RTOL for its saturated second layer's scores), but
    the leaves NOISE_LEAVES names.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from test_torch_remat import ALPHA, RANK, _qlora_tree
from u2tokenizer_torch.config import GenerationConfig as TGen
from u2tokenizer_torch.config import LLMConfig as TLLM
from u2tokenizer_torch.config import U2ModelConfig as TCfg
from u2tokenizer_torch.models import generate as t_generate
from u2tokenizer_torch.models import quantize as t_quant
from u2tokenizer_torch.models.llm.decoder import CausalLM as TLM
from u2tokenizer_torch.models.llm.decoder import QDense
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.train import lora as t_lora
from u2tokenizer_torch.train import sft as t_sft
from u2tokenizer_torch.weights import (flatten, flax_params,
                                       load_flax_params, torch_name)
from u2tokenizer_tpu.config import GenerationConfig as JGen
from u2tokenizer_tpu.config import LLMConfig as JLLM
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.models import generate as j_generate
from u2tokenizer_tpu.models import quantize as j_quant
from u2tokenizer_tpu.models.llm.decoder import CausalLM as JLM
from u2tokenizer_tpu.models.u2_model import U2CausalLM as JModel
from u2tokenizer_tpu.train import lora as j_lora
from u2tokenizer_tpu.train import sft as j_sft

pytestmark = pytest.mark.fast

B, SQ, TILES = 2, 6, 8
# Held as noise (a gradient norm under NOISE_TOL of the largest leaf's, in
# both packages): the key biases, as everywhere, and at this width the
# μ²tokenizer's aggregator, whose attention softmaxes saturate over the
# 256-wide tokens: its gradients' norms are at most 4.2e-8 of the largest
# leaf's, rounding noise in both packages
NOISE_LEAVES = ("wk/bias", "u2tokenizer/tta_module",
                "u2tokenizer/query_tokens")
NOISE_TOL = 1e-7
# gradients within RTOL of each leaf's largest element (fp32, sums in
# other orders); the μ²tokenizer's SVR leaves within U2T_RTOL, their
# gradients through its softmaxes and the top-k's pooling (measured up to
# 6.9e-5, a relative-position table); and the score parameters (wq, wk) of
# its second SVR layer within SCORE_RTOL: its softmaxes saturate, so their
# gradients are 1e-5 of the other leaves' and keep fewer digits (measured
# up to 4.3e-4; chip_smoke.py leaves the same leaves out of its bf16 checks)
RTOL, U2T_RTOL, SCORE_RTOL = 1e-5, 1e-4, 1e-3
SCORES = re.compile(r"svt_module/layers_[1-9]\d*/\w+_attention/w[qk]/")


def _rtol(path: str) -> float:
    if SCORES.search(path):
        return SCORE_RTOL
    return U2T_RTOL if "u2tokenizer/" in path else RTOL


def _narrow(cls):
    """The 8B decoder at narrow width: 8 heads of 128 over 2 KV heads."""
    return dataclasses.replace(
        cls.qwen3_8b(vocab_size=512), hidden_size=256,
        intermediate_size=512, num_layers=2, num_heads=8, num_kv_heads=2,
        lm_head_tiles=TILES)


def _u2(cls, llm_cls):
    return dataclasses.replace(cls.tiny(), llm=_narrow(llm_cls))


def _tree(flat):
    return {"params": unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}


def _drawn(model, seed=0):
    """``model``'s flax tree with its biases re-drawn from a numpy seed,
    loaded back into it: flat {path: array}."""
    flat = {k: np.array(v) for k, v in flatten(flax_params(model)).items()}
    rs = np.random.RandomState(seed)
    for k, v in flat.items():
        if k.endswith(("bias", "cls_token")):
            flat[k] = (0.1 * rs.randn(*v.shape)).astype(np.float32)
    load_flax_params(model, flat)
    return flat


def _inputs(cfg, s):
    rs = np.random.RandomState(1)
    d, h, w = cfg.vision.input_spatial
    return {"images": rs.randn(B, cfg.num_chunks, d, h, w).astype(np.float32),
            "ids": rs.randint(0, cfg.llm.vocab_size, (B, s)).astype(np.int32),
            "qids": rs.randint(0, cfg.llm.vocab_size, (B, SQ)).astype(
                np.int32),
            "plen": np.array([s, s - 5], np.int32)}


def test_preset_matches_jax():
    """``qwen3_8b`` field for field, and the μ²Qwen3-8B config around it:
    untied 151,936 x 4096 head, 36 layers, 32/8 heads of 128."""
    t, j = TLLM.qwen3_8b(), JLLM.qwen3_8b()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.vocab_size, t.hidden_size, t.num_layers, t.num_heads,
            t.num_kv_heads, t.head_dim, t.tie_word_embeddings) == (
        151936, 4096, 36, 32, 8, 128, False)
    assert dataclasses.asdict(TCfg(llm=t)) == dataclasses.asdict(JCfg(llm=j))
    assert TCfg(llm=t).to_json() == JCfg(llm=j).to_json()


def test_decoder_logits_match_jax():
    """The narrow 8B decoder's fp32 logits over a right-padded batch."""
    tm = TLM(_narrow(TLLM), dtype=torch.float32, device="cpu")
    from u2tokenizer_torch.models.layers import init_weights
    init_weights(tm, 0)
    flat = _drawn(tm)
    jm = JLM(_narrow(JLLM), dtype=jnp.float32)
    s = 40
    emb = np.random.RandomState(3).randn(B, s, 256).astype(np.float32)
    att = (np.arange(s)[None, :] < np.array([s, s - 7])[:, None]).astype(
        np.int32)
    ref, _, _ = jax.jit(lambda p: jm.apply(
        p, jnp.asarray(emb), jnp.asarray(att), method="forward_embeds"))(
        _tree(flat))
    with torch.no_grad():
        out, _, _ = tm.forward_embeds(torch.from_numpy(emb),
                                      torch.from_numpy(att))
    valid = att.astype(bool)
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(ref)[valid],
                               rtol=1e-5, atol=1e-5)


def test_int8_weights_int4_cache_greedy_matches_jax():
    """The 8B serving configuration: int8 decoder weights (the untied head
    int8, tiled), the int4 KV cache, greedy tokens equal."""
    tcfg = _u2(TCfg, TLLM)
    tm = TModel(tcfg, dtype=torch.float32, device="cpu", seed=0)
    flat = _drawn(tm)
    jm = JModel(t_quant.quantized_llm_config(_u2(JCfg, JLLM), "int8"),
                dtype=jnp.float32)
    params = j_quant.quantize_llm_weights(_tree(flat), "int8")
    t_quant.quantize_llm_weights(tm, "int8")
    head = tm.llm.lm_head
    assert head.mode == "int8" and head.out_tiles == TILES
    inp = _inputs(tcfg, 24)
    jgen = JGen(max_new_tokens=6, eos_token_id=-2)
    ref = j_generate.make_multimodal_generate_fn(jm, jgen,
                                                 cache_dtype="int4")(
        params, jnp.asarray(inp["ids"]), jnp.asarray(inp["images"]),
        jnp.asarray(inp["qids"]), jnp.asarray(inp["plen"]),
        jax.random.PRNGKey(1))
    out = t_generate.make_multimodal_generate_fn(
        tm, TGen(**dataclasses.asdict(jgen)), cache_dtype="int4")(
        torch.from_numpy(inp["ids"]).long(),
        torch.from_numpy(inp["images"]),
        torch.from_numpy(inp["qids"]).long(), torch.from_numpy(inp["plen"]))
    assert out.shape == (B, 6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_int4_qlora_step_matches_jax():
    """One QLoRA step's loss and trainable gradients over an int4 base
    with the int8 head tiled in 8 (lora_b re-drawn so that every adapter
    has a gradient; the same parameters in both packages,
    ``test_torch_remat._qlora_tree``)."""
    tcfg, jcfg = _u2(TCfg, TLLM), _u2(JCfg, JLLM)
    s = 64  # 128 tokens: the head takes its tiled form
    inp = _inputs(tcfg, s)
    tm = TModel(tcfg, dtype=torch.float32, device="cpu", seed=0)
    _drawn(tm)
    lflat = _qlora_tree(tm, "int4")
    qcfg = j_lora.qlora_config(jcfg, rank=RANK, alpha=ALPHA, mode="int4")
    jm = JModel(qcfg, dtype=jnp.float32)
    mask = (np.arange(s)[None, :] < inp["plen"][:, None]).astype(np.int32)
    labels = np.where(mask == 1, inp["ids"], -100).astype(np.int32)
    labels[:, :1 + tcfg.proj_out_num + 2] = -100
    batch = {"input_ids": inp["ids"], "labels": labels,
             "attention_mask": mask, "images": inp["images"],
             "question_ids": inp["qids"]}
    j_train, j_frozen = j_lora.qlora_partition(
        unflatten_dict(lflat, sep="/"))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_fn = j_sft.make_loss_fn(jm)
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda tf: loss_fn(j_lora.qlora_merge_trees(tf, j_frozen), jb),
        has_aux=True))(j_train)

    head = tm.llm.lm_head
    assert isinstance(head, QDense) and head.mode == "int8"
    assert head.out_tiles == TILES and head.weight.shape[0] % TILES == 0
    assert tm.llm.model.layers[0].self_attn.q_proj.mode == "int4"
    train, _ = t_lora.qlora_partition(tm)
    assert sorted(train) == sorted(j_train)
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
          else torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = t_sft.make_loss_fn()(tm, tb)
    grads = torch.autograd.grad(loss, list(train.values()), allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    modules = dict(tm.named_modules())
    top = max(float(np.linalg.norm(g)) for g in j_grads.values())
    for (path, _), got in zip(train.items(), grads):
        _, transpose = torch_name(path[len("params/"):], modules)
        got = got.t() if transpose else got
        got, want = got.numpy(), np.asarray(j_grads[path])
        if any(k in path for k in NOISE_LEAVES):
            assert max(np.linalg.norm(got), np.linalg.norm(want)) \
                < NOISE_TOL * top, path
            continue
        if not np.any(want):  # no path to the loss (the top-k's scores)
            assert not np.any(got), path
            continue
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= _rtol(path), (path, err)
