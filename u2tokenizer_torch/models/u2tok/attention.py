"""Attention modules of the μ²tokenizer (counterpart of
``u2tokenizer_tpu/models/u2tok/attention.py``).

The three self-attention flavours of the reference's ``attn_type`` switch:
``RelativeMultiheadAttention`` (MHA with a learned relative-position bias
table, 'rma', the default), ``RotaryMultiheadAttention`` (rotary
embeddings of theta 10,000, 'rope') and ``VanillaMultiheadAttention``
(plain MHA, 'vanilla' or any other name); and
``MultiHeadCrossAttention``. With
``is_compress`` a module attends the raw values (no value projection) and
skips the output projection; it then has no ``wv``/``dense`` parameters,
like its flax counterpart. All operate batch-first on (B, S, E).

Attention capture (the reference's ``return_attn`` paths feeding its demo
notebook): called with ``capture_attention=True`` a module keeps its fp32
softmax probabilities, (B, H, Sq, Sk) with the relative bias where it has
one, in its ``attn`` attribute, where the JAX package sows them into
flax's 'intermediates'. The output is the same either way.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...ops.attention import _scalar, relative_position_bias, sdpa
from ...ops.rotary import apply_rope, rope_cos_sin
from ..layers import Dense


def _attn_probs(q, k, bias=None) -> torch.Tensor:
    """fp32 softmax probabilities (B, H, Sq, Sk) of q (B, Sq, H, D) against
    k (B, Sk, H, D), scaled by 1/sqrt(D), with an additive ``bias``."""
    scale = _scalar(1.0 / (q.shape[-1] ** 0.5), q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    return torch.softmax(scores.float(), dim=-1)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, e = x.shape
    return x.reshape(b, s, num_heads, e // num_heads)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.reshape(b, s, h * d)


class _Attention(nn.Module):
    """wq and wk, and unless ``is_compress`` wv and the output projection
    ``dense``; ``attend`` runs the attention of projected q and k, keeping
    the probabilities in ``attn`` when asked."""

    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32,
                 is_compress: bool = False, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.is_compress = is_compress
        self.attn: Optional[torch.Tensor] = None
        self.wq = Dense(d_model, d_model, True, dtype, device)
        self.wk = Dense(d_model, d_model, True, dtype, device)
        if not is_compress:
            self.wv = Dense(d_model, d_model, True, dtype, device)
            self.dense = Dense(d_model, d_model, True, dtype, device)

    def attend(self, q, k, value, bias=None,
               capture_attention: bool = False) -> torch.Tensor:
        v = value if self.is_compress else self.wv(value)
        v = _split_heads(v, self.num_heads)
        if capture_attention:
            self.attn = _attn_probs(q, k, bias).detach()
        out = _merge_heads(sdpa(q, k, v, bias=bias))
        return out if self.is_compress else self.dense(out)


class RelativeMultiheadAttention(_Attention):
    def __init__(self, d_model: int, num_heads: int, max_seq_len: int = 512,
                 dtype=torch.float32, is_compress: bool = False, device=None):
        super().__init__(d_model, num_heads, dtype, is_compress, device)
        self.max_seq_len = max_seq_len
        self.relative_bias = nn.Parameter(
            torch.empty(2 * max_seq_len - 1, num_heads, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.relative_bias.zero_()

    def forward(self, query, key, value, capture_attention: bool = False):
        q = _split_heads(self.wq(query), self.num_heads)
        k = _split_heads(self.wk(key), self.num_heads)
        bias = relative_position_bias(self.relative_bias, query.shape[1],
                                      self.max_seq_len)
        return self.attend(q, k, value, bias, capture_attention)


class RotaryMultiheadAttention(_Attention):
    """MHA with rotary embeddings (theta 10,000, no scaling) on q over
    positions 0..Sq-1 and on k over 0..Sk-1."""

    def __init__(self, d_model: int, num_heads: int, theta: float = 10_000.0,
                 dtype=torch.float32, device=None):
        super().__init__(d_model, num_heads, dtype, device=device)
        self.theta = theta

    def forward(self, query, key, value, capture_attention: bool = False):
        q = _split_heads(self.wq(query), self.num_heads)
        k = _split_heads(self.wk(key), self.num_heads)
        head_dim = q.shape[-1]
        for_q = rope_cos_sin(torch.arange(q.shape[1], device=q.device),
                             head_dim, self.theta)
        for_k = rope_cos_sin(torch.arange(k.shape[1], device=k.device),
                             head_dim, self.theta)
        q, k = apply_rope(q, *for_q), apply_rope(k, *for_k)
        return self.attend(q, k, value, None, capture_attention)


class VanillaMultiheadAttention(_Attention):
    """Plain MHA. The reference falls back to ``nn.MultiheadAttention`` and
    feeds it batch-first tensors despite torch's sequence-first default
    (svr.py:17-18); this module, like the JAX package's, attends
    batch-first. Checkpoints of that layout load through
    ``hf_weights``, which splits the fused ``in_proj``."""

    def forward(self, query, key, value, capture_attention: bool = False):
        q = _split_heads(self.wq(query), self.num_heads)
        k = _split_heads(self.wk(key), self.num_heads)
        return self.attend(q, k, value, None, capture_attention)


class MultiHeadCrossAttention(_Attention):
    """Cross attention: queries from ``query``, keys (and, unless
    ``is_compress``, values) projected from ``value``."""

    def forward(self, query, value, capture_attention: bool = False):
        q = _split_heads(self.wq(query), self.num_heads)
        k = _split_heads(self.wk(value), self.num_heads)
        return self.attend(q, k, value, None, capture_attention)


def make_self_attention(attn_type: str, d_model: int, num_heads: int,
                        max_seq_len: int, dtype=torch.float32,
                        device=None) -> nn.Module:
    """The self attention of ``attn_type``: 'rma', 'rope', else the
    vanilla one, as the JAX package (and the reference, which falls back
    to ``nn.MultiheadAttention``) builds for any other name."""
    if attn_type == "rma":
        return RelativeMultiheadAttention(d_model, num_heads, max_seq_len,
                                          dtype, device=device)
    if attn_type == "rope":
        return RotaryMultiheadAttention(d_model, num_heads, dtype=dtype,
                                        device=device)
    return VanillaMultiheadAttention(d_model, num_heads, dtype,
                                     device=device)
