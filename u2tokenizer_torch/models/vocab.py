"""Vocabulary resizing (counterpart of ``u2tokenizer_tpu/models/vocab.py``,
``resize_token_embeddings`` and ``resized_config``): the embedding table,
and an untied output head, grown for added special tokens (<im_patch> and
the like) or cut, on a port model in place.

New rows are the mean of the existing ones (the reference's
``initialize_vision_tokenizer``). The means are taken with numpy in fp32
over the same memory layout as the JAX package's, so that both give the
same bits. The adapter helpers wait for LoRA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..config import LLMConfig, U2ModelConfig


def _resize_rows(table: np.ndarray, new_vocab: int,
                 mean_init: bool) -> np.ndarray:
    """(V, ...) -> (new_vocab, ...): rows cut, or added as the mean of the
    existing rows (zeros without ``mean_init``)."""
    old = table.shape[0]
    if new_vocab <= old:
        return table[:new_vocab]
    fill = (table.mean(axis=0, keepdims=True) if mean_init
            else np.zeros((1,) + table.shape[1:], table.dtype))
    return np.concatenate([table, np.repeat(fill, new_vocab - old, axis=0)])


def _like(arr: np.ndarray, param: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(param.device,
                                                          param.dtype)


@torch.no_grad()
def resize_token_embeddings(model: nn.Module, new_vocab: int,
                            mean_init: bool = True) -> nn.Module:
    """Resize the decoder vocabulary of a ``U2CausalLM`` or ``CausalLM``
    with float weights in place, and the configs its modules hold; returns
    the model."""
    lm = model.llm if hasattr(model, "llm") else model
    decoder = lm.model
    if decoder.quantized:
        raise ValueError("resize the vocabulary before quantizing weights")
    embed = decoder.embed_tokens
    if new_vocab == embed.shape[0]:
        return model
    table = embed.detach().cpu().float().numpy()
    decoder.set_embedding(_like(_resize_rows(table, new_vocab, mean_init),
                                embed))
    head = getattr(lm, "lm_head", None)
    if head is not None:
        # the JAX package's (hidden, vocab) kernel, contiguous, averaged
        # over its vocab axis: the same sums in the same order
        kernel = np.ascontiguousarray(
            head.weight.detach().cpu().float().numpy().T)
        new = _resize_rows(kernel.T, new_vocab, False)
        if new_vocab > kernel.shape[1] and mean_init:
            new[kernel.shape[1]:] = kernel.mean(axis=1)
        head.set_weight(None, _like(new, head.weight))
        if head.bias is not None:
            bias = head.bias.detach().cpu().float().numpy()
            head.bias = nn.Parameter(_like(
                _resize_rows(bias, new_vocab, False), head.bias))
    for module in model.modules():
        cfg = getattr(module, "cfg", None)
        if isinstance(cfg, (LLMConfig, U2ModelConfig)):
            module.cfg = resized_config(cfg, new_vocab)
    return model


def resized_config(cfg, new_vocab: int):
    """A copy of a ``U2ModelConfig`` (or an ``LLMConfig``) with the
    decoder's ``vocab_size`` set to ``new_vocab``."""
    if isinstance(cfg, U2ModelConfig):
        return dataclasses.replace(
            cfg, llm=dataclasses.replace(cfg.llm, vocab_size=new_vocab))
    return dataclasses.replace(cfg, vocab_size=new_vocab)
