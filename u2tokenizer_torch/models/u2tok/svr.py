"""SVR, the spatio-temporal visual token refiner (counterpart of
``u2tokenizer_tpu/models/u2tok/svr.py``).

Per layer, tokens attend spatially within each chunk (over N) and then
temporally across chunks (over T), with no residuals or norms (the
reference's quirk, kept for parity). Then hard top-k token selection and
fixed multi-scale pooling. DiffTS and DMTP are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...ops.pooling import multi_scale_pool
from ...ops.topk import hard_topk_select
from ..layers import Dense
from .attention import make_self_attention


class SpatioTemporalAttentionLayer(nn.Module):
    def __init__(self, embed_size: int, num_heads: int, attn_type: str = "rma",
                 max_seq_len: int = 512, dtype=torch.float32, device=None):
        super().__init__()
        self.spatial_attention = make_self_attention(
            attn_type, embed_size, num_heads, max_seq_len, dtype, device)
        self.temporal_attention = make_self_attention(
            attn_type, embed_size, num_heads, max_seq_len, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, n, e = x.shape
        xs = x.reshape(b * t, n, e)
        x = self.spatial_attention(xs, xs, xs).reshape(b, t, n, e)
        xt = x.transpose(1, 2).reshape(b * n, t, e)
        xt = self.temporal_attention(xt, xt, xt)
        return xt.reshape(b, n, t, e).transpose(1, 2)


class TokenSelection(nn.Module):
    """Hard top-k over all T*N tokens by a learned score."""

    def __init__(self, embed_size: int, top_k: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.top_k = top_k
        self.score_net = Dense(embed_size, 1, True, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, n, e = x.shape
        scores = self.score_net(x).reshape(b, t * n)
        return hard_topk_select(x.reshape(b, t * n, e), scores, self.top_k)


class SpatioTemporalVisualTokenRefiner(nn.Module):
    def __init__(self, embed_size: int, num_heads: int, num_layers: int,
                 top_k: int, use_multi_scale: bool = True,
                 attn_type: str = "rma", enable_diffts: bool = False,
                 enable_dmtp: bool = False, max_seq_len: int = 512,
                 scales: Sequence[int] = (1, 2, 4), dtype=torch.float32,
                 device=None):
        super().__init__()
        if enable_diffts or enable_dmtp:
            raise NotImplementedError("DiffTS and DMTP are not ported yet")
        self.use_multi_scale = use_multi_scale
        self.scales = tuple(scales)
        self.layers = nn.ModuleList(
            SpatioTemporalAttentionLayer(embed_size, num_heads, attn_type,
                                         max_seq_len, dtype, device)
            for _ in range(num_layers))
        self.token_selection = TokenSelection(embed_size, top_k, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        x = self.token_selection(x)
        if self.use_multi_scale:
            x = multi_scale_pool(x, self.scales)
        return x
