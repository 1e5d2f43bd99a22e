"""``resize_token_embeddings`` on a port model against the JAX package's on
the same parameters: the tables, head kernels and biases bit for bit,
grown (mean or zero rows) and cut, with a tied and an untied head."""

import dataclasses

import numpy as np
import pytest
import torch

from u2tokenizer_torch import config as t_config
from u2tokenizer_torch.models import vocab as t_vocab
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.weights import flatten, flax_params
from u2tokenizer_tpu import config as j_config
from u2tokenizer_tpu.models import vocab as j_vocab

pytestmark = pytest.mark.fast


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("new_vocab,mean_init", [(520, True), (517, False),
                                                 (500, True)])
def test_resize_matches_jax(tied, new_vocab, mean_init):
    llm = dataclasses.replace(t_config.LLMConfig.tiny(),
                              tie_word_embeddings=tied, lm_head_bias=not tied)
    tcfg = dataclasses.replace(t_config.U2ModelConfig.tiny(), llm=llm)
    model = TModel(tcfg, dtype=torch.float32, device="cpu", seed=5)
    if not tied:
        with torch.no_grad():
            model.llm.lm_head.bias.normal_(
                generator=torch.Generator().manual_seed(1))
    # the leaves the resize reads, as C-ordered copies (as jax arrays give)
    llm_tree = flax_params(model)["params"]["llm"]
    tree = {"params": {"llm": {"model": {"embed_tokens": np.array(
        llm_tree["model"]["embed_tokens"], order="C")}}}}
    if not tied:
        tree["params"]["llm"]["lm_head"] = {
            k: np.array(v, order="C") for k, v in llm_tree["lm_head"].items()}
    ref = flatten(j_vocab.resize_token_embeddings(tree, new_vocab, mean_init))
    t_vocab.resize_token_embeddings(model, new_vocab, mean_init)
    ours = flatten(flax_params(model))
    for key in ("llm/model/embed_tokens", "llm/lm_head/kernel",
                "llm/lm_head/bias"):
        if key in ref:
            np.testing.assert_array_equal(ours[key], np.asarray(ref[key]),
                                          err_msg=key)
    assert ("llm/lm_head/kernel" in ours) == (not tied)
    jcfg = j_config.U2ModelConfig.from_dict(dataclasses.asdict(tcfg))
    assert (dataclasses.asdict(model.cfg) == dataclasses.asdict(
        j_vocab.resized_config(jcfg, new_vocab)))
    assert model.llm.cfg.vocab_size == new_vocab
    with torch.no_grad():
        logits = model.lm_logits(torch.zeros(1, 1, llm.hidden_size))
    assert logits.shape[-1] == new_vocab
