"""SVR, the spatio-temporal visual token refiner (counterpart of
``u2tokenizer_tpu/models/u2tok/svr.py``).

Per layer, tokens attend spatially within each chunk (over N) and then
temporally across chunks (over T), with no residuals or norms (the
reference's quirk, kept for parity). Then token selection, hard top-k or
DiffTS's soft selection (``enable_diffts``), and multi-scale pooling, fixed
or gated (DMTP, ``enable_dmtp``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...ops.pooling import dynamic_multi_scale_pool, multi_scale_pool
from ...ops.topk import hard_topk_select, soft_topk_select
from ..layers import Dense, lecun_normal_
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


class DifferentiableTokenSelection(nn.Module):
    """DiffTS: ``top_k`` selection heads, each a softmax-weighted sum of all
    T*N tokens (``ops.topk.soft_topk_select``)."""

    def __init__(self, embed_size: int, top_k: int, tau: float = 1.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.top_k = top_k
        self.tau = tau
        self.score_net = Dense(embed_size, top_k, True, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, n, e = x.shape
        scores = self.score_net(x).reshape(b, t * n, self.top_k)
        return soft_topk_select(x.reshape(b, t * n, e), scores, self.tau)


class DynamicMultiScalePooling(nn.Module):
    """DMTP: ``ops.pooling.dynamic_multi_scale_pool`` with a learned gate,
    ``gate_kernel`` (E, 1) and ``gate_bias`` (1,), fp32 parameters that
    keep flax's names and layout (not a ``Dense``: no transpose on load),
    cast to the input's dtype."""

    def __init__(self, embed_size: int, scales: Sequence[int] = (1, 2, 4),
                 device=None):
        super().__init__()
        self.scales = tuple(scales)
        self.gate_kernel = nn.Parameter(torch.empty(embed_size, 1,
                                                    device=device))
        self.gate_bias = nn.Parameter(torch.empty(1, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.gate_kernel, self.gate_kernel.shape[0], generator)
        self.gate_bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dynamic_multi_scale_pool(x, self.gate_kernel.to(x.dtype),
                                        self.gate_bias.to(x.dtype),
                                        self.scales)


class SpatioTemporalVisualTokenRefiner(nn.Module):
    def __init__(self, embed_size: int, num_heads: int, num_layers: int,
                 top_k: int, use_multi_scale: bool = True,
                 attn_type: str = "rma", enable_diffts: bool = False,
                 enable_dmtp: bool = False, max_seq_len: int = 512,
                 scales: Sequence[int] = (1, 2, 4), diffts_tau: float = 1.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.use_multi_scale = use_multi_scale
        self.scales = tuple(scales)
        self.layers = nn.ModuleList(
            SpatioTemporalAttentionLayer(embed_size, num_heads, attn_type,
                                         max_seq_len, dtype, device)
            for _ in range(num_layers))
        if enable_diffts:
            self.token_selection = DifferentiableTokenSelection(
                embed_size, top_k, diffts_tau, dtype, device)
        else:
            self.token_selection = TokenSelection(embed_size, top_k, dtype,
                                                  device)
        if use_multi_scale and enable_dmtp:
            self.dynamic_pool = DynamicMultiScalePooling(embed_size, scales,
                                                         device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        x = self.token_selection(x)
        if hasattr(self, "dynamic_pool"):
            x = self.dynamic_pool(x)
        elif self.use_multi_scale:
            x = multi_scale_pool(x, self.scales)
        return x
