"""Attention modules of the μ²tokenizer (counterpart of
``u2tokenizer_tpu/models/u2tok/attention.py``).

``RelativeMultiheadAttention`` (MHA with a learned relative-position bias
table, the default ``attn_type='rma'``) and ``MultiHeadCrossAttention``.
With ``is_compress`` a module attends the raw values (no value projection)
and skips the output projection; it then has no ``wv``/``dense``
parameters, like its flax counterpart. All operate batch-first on
(B, S, E). The rope and vanilla variants are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.attention import relative_position_bias, sdpa
from ..layers import Dense


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, e = x.shape
    return x.reshape(b, s, num_heads, e // num_heads)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.reshape(b, s, h * d)


class RelativeMultiheadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, max_seq_len: int = 512,
                 dtype=torch.float32, is_compress: bool = False, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.max_seq_len = max_seq_len
        self.is_compress = is_compress
        self.wq = Dense(d_model, d_model, True, dtype, device)
        self.wk = Dense(d_model, d_model, True, dtype, device)
        if not is_compress:
            self.wv = Dense(d_model, d_model, True, dtype, device)
        self.relative_bias = nn.Parameter(
            torch.empty(2 * max_seq_len - 1, num_heads, device=device))
        if not is_compress:
            self.dense = Dense(d_model, d_model, True, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.relative_bias.zero_()

    def forward(self, query, key, value):
        q = _split_heads(self.wq(query), self.num_heads)
        k = _split_heads(self.wk(key), self.num_heads)
        v = value if self.is_compress else self.wv(value)
        v = _split_heads(v, self.num_heads)
        bias = relative_position_bias(self.relative_bias, query.shape[1],
                                      self.max_seq_len)
        out = _merge_heads(sdpa(q, k, v, bias=bias))
        return out if self.is_compress else self.dense(out)


class MultiHeadCrossAttention(nn.Module):
    """Cross attention: queries from ``query``, keys (and, unless
    ``is_compress``, values) projected from ``value``."""

    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32,
                 is_compress: bool = False, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.is_compress = is_compress
        self.wq = Dense(d_model, d_model, True, dtype, device)
        self.wk = Dense(d_model, d_model, True, dtype, device)
        if not is_compress:
            self.wv = Dense(d_model, d_model, True, dtype, device)
            self.dense = Dense(d_model, d_model, True, dtype, device)

    def forward(self, query, value):
        q = _split_heads(self.wq(query), self.num_heads)
        k = _split_heads(self.wk(value), self.num_heads)
        v = value if self.is_compress else self.wv(value)
        v = _split_heads(v, self.num_heads)
        out = _merge_heads(sdpa(q, k, v))
        return out if self.is_compress else self.dense(out)


def make_self_attention(attn_type: str, d_model: int, num_heads: int,
                        max_seq_len: int, dtype=torch.float32,
                        device=None) -> nn.Module:
    if attn_type != "rma":
        raise NotImplementedError(
            f"attn_type={attn_type!r} is not ported; only 'rma'")
    return RelativeMultiheadAttention(d_model, num_heads, max_seq_len, dtype,
                                      device=device)
