"""TTA, the text-conditioned token aggregator (counterpart of
``u2tokenizer_tpu/models/u2tok/tta.py``).

Per layer: query self-attention (+residual, LN), cross-attention to the
refined visual tokens (+residual, LN), cross-attention to the question-token
embeddings (+residual, LN). A final compressing cross-attention projects
the queries onto the raw visual values (no value or output projection).
"""

from __future__ import annotations

import torch
from torch import nn

from ..layers import LayerNorm
from .attention import MultiHeadCrossAttention, make_self_attention


class TextConditionTokenAttMap(nn.Module):
    def __init__(self, d_model: int, num_heads: int, attn_type: str = "rma",
                 max_seq_len: int = 512, dtype=torch.float32, device=None):
        super().__init__()
        self.self_attention = make_self_attention(
            attn_type, d_model, num_heads, max_seq_len, dtype, device)
        self.visual_cross_attention = MultiHeadCrossAttention(
            d_model, num_heads, dtype, device=device)
        self.text_cross_attention = MultiHeadCrossAttention(
            d_model, num_heads, dtype, device=device)
        self.norm_self = LayerNorm(d_model, dtype=dtype, device=device)
        self.norm_cross_v = LayerNorm(d_model, dtype=dtype, device=device)
        self.norm_cross_t = LayerNorm(d_model, dtype=dtype, device=device)

    def forward(self, visual_query, visual_value, text_value):
        x = self.self_attention(visual_query, visual_query, visual_query)
        x = self.norm_self(visual_query + x)
        x = self.norm_cross_v(x + self.visual_cross_attention(x, visual_value))
        return self.norm_cross_t(x + self.text_cross_attention(x, text_value))


class LinearAggregation(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.linear_aggregator = MultiHeadCrossAttention(
            d_model, num_heads, dtype, is_compress=True, device=device)

    def forward(self, query_vt, visual_value):
        return self.linear_aggregator(query_vt, visual_value)


class TextConditionTokenAggregator(nn.Module):
    def __init__(self, d_model: int, num_layers: int, num_heads: int,
                 attn_type: str = "rma", max_seq_len: int = 512,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.layers_vt = nn.ModuleList(
            TextConditionTokenAttMap(d_model, num_heads, attn_type,
                                     max_seq_len, dtype, device)
            for _ in range(num_layers))
        self.layer_linagg = LinearAggregation(d_model, num_heads, dtype, device)

    def forward(self, query, visual_value, text_value):
        for layer in self.layers_vt:
            query = layer(query, visual_value, text_value)
        return self.layer_linagg(query, visual_value)
