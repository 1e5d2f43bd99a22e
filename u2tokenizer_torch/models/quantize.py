"""Serving-time weight transforms (counterpart of
``u2tokenizer_tpu/models/quantize.py``): bf16 cast and weight-only
int8/int4 quantization of the decoder.

The JAX package transforms a parameter tree; here the same transforms act
on a built model in place, on its device:

  * ``cast_for_inference``: float parameters with ndim >= 2 to bf16 (norm
    weights and biases stay fp32);
  * ``quantize_llm_weights(model, mode)``: every decoder ``QDense`` to int8
    per output channel (``mode="int8"``) or to packed int4 per group of 128
    inputs (``mode="int4"``; the untied ``lm_head`` stays int8), and the
    embedding table to int8 per row, in both modes. The integers and
    scales are those of the JAX package's ``_quantize_channels`` and
    ``_quantize_kernel_int4`` on the same float weights; the model's
    configs then name the mode (``cfg.llm.quantized_weights``);
  * ``dequantize_llm_weights``: back to fp32 weights, exact up to the
    quantization rounding;
  * ``quantized_llm_config``: a config copy with ``quantized_weights`` set,
    for a model built quantized that then loads quantized weights.

The vision tower, projector and μ²tokenizer stay float, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..config import LLMConfig, U2ModelConfig
from .layers import cast_for_inference  # noqa: F401  (re-exported)
from .llm.decoder import (CausalLM, QDense, int4_group, pack_int4, quant_mode,
                          unpack_int4)


def quantize_channels(w: torch.Tensor, dim: int, eps: float = 1e-8):
    """Symmetric int8 quantization of ``w`` per slice along ``dim``:
    (int8 values, fp32 scales with ``dim`` kept and the others 1)."""
    wf = w.float()
    other = [i for i in range(w.dim()) if i != dim % w.dim()]
    scale = wf.abs().amax(dim=other, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=eps)
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_kernel_int4(kernel: torch.Tensor, group: int = 128,
                         eps: float = 1e-8):
    """Group-wise symmetric int4 of an (in, out) kernel: ((ng, g/2, out)
    int8 packed pairs, (ng, out) fp32 scales), g = ``int4_group(in)``."""
    in_f, out = kernel.shape
    g = int4_group(in_f, group)
    k = kernel.float().reshape(in_f // g, g, out)
    scale = torch.clamp(k.abs().amax(dim=1, keepdim=True) / 7.0, min=eps)
    q = torch.clamp(torch.round(k / scale), -7, 7).to(torch.int8)
    return pack_int4(q), scale[:, 0, :]


def _causal_lm(model: nn.Module) -> CausalLM:
    return model.llm if hasattr(model, "llm") else model


def _set_configs(model: nn.Module, mode) -> None:
    """Every config the model's modules hold, with ``quantized_weights``
    set to ``mode``."""
    for module in model.modules():
        cfg = getattr(module, "cfg", None)
        if isinstance(cfg, (LLMConfig, U2ModelConfig)):
            module.cfg = quantized_llm_config(cfg, mode)


@torch.no_grad()
def quantize_llm_weights(model: nn.Module, mode="int8") -> nn.Module:
    """Quantize the decoder of ``model`` (a ``U2CausalLM`` or a bare
    ``CausalLM`` with float weights) in place; returns it."""
    mode = quant_mode(mode)
    if mode is None:
        raise ValueError("quantize_llm_weights needs mode 'int8' or 'int4'")
    lm = _causal_lm(model)
    if lm.model.quantized:
        raise ValueError("the decoder's weights are quantized already")
    for name, layer in lm.named_modules():
        if not isinstance(layer, QDense):
            continue
        kernel = layer.weight.t()  # (in, out), the JAX package's layout
        if mode == "int4" and name != "lm_head":
            layer.set_weight("int4", *quantize_kernel_int4(kernel))
        else:
            q, scale = quantize_channels(kernel, dim=1)
            layer.set_weight("int8", q.t().contiguous(), scale.reshape(-1))
    q, scale = quantize_channels(lm.model.embed_tokens, dim=0)
    lm.model.set_embedding(q, scale.reshape(-1, 1))
    _set_configs(model, mode)
    return model


@torch.no_grad()
def dequantize_llm_weights(model: nn.Module) -> nn.Module:
    """Inverse of ``quantize_llm_weights``: the scales folded back into
    fp32 weights and embedding table, in place; returns the model."""
    lm = _causal_lm(model)
    for layer in lm.modules():
        if not isinstance(layer, QDense) or layer.mode is None:
            continue
        if layer.mode == "int4":
            k = unpack_int4(layer.weight).float() * layer.scale[:, None, :]
            w = k.reshape(-1, k.shape[-1]).t()
        else:
            w = layer.weight.float() * layer.scale[:, None]
        layer.set_weight(None, w.contiguous())
    if lm.model.quantized:
        lm.model.set_embedding(lm.model.embed_tokens.float()
                               * lm.model.embed_scale)
    _set_configs(model, False)
    return model


def quantized_llm_config(cfg, mode=True):
    """A copy of an ``LLMConfig`` or ``U2ModelConfig`` with
    ``quantized_weights=mode`` (True/"int8", "int4", or False)."""
    if hasattr(cfg, "llm"):
        return dataclasses.replace(
            cfg, llm=dataclasses.replace(cfg.llm, quantized_weights=mode))
    return dataclasses.replace(cfg, quantized_weights=mode)
