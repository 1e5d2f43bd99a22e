"""μ²Tokenizer top module (counterpart of
``u2tokenizer_tpu/models/u2tok/u2tokenizer.py``): SVR refinement, then TTA
aggregation of learned queries. (B, T, N, E) visual tokens and (B, S_text, E)
question-token embeddings -> (B, num_query_tokens, E) image tokens."""

from __future__ import annotations

import torch
from torch import nn

from ...config import U2TokenizerConfig
from .svr import SpatioTemporalVisualTokenRefiner
from .tta import TextConditionTokenAggregator


class U2Tokenizer(nn.Module):
    def __init__(self, embed_size: int, cfg: U2TokenizerConfig,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.query_tokens = nn.Parameter(
            torch.empty(1, cfg.num_query_tokens, embed_size, device=device))
        self.svt_module = SpatioTemporalVisualTokenRefiner(
            embed_size=embed_size, num_heads=cfg.num_heads,
            num_layers=cfg.num_layers, top_k=cfg.top_k,
            use_multi_scale=cfg.use_multi_scale, attn_type=cfg.attn_type,
            enable_diffts=cfg.enable_diffts, enable_dmtp=cfg.enable_dmtp,
            max_seq_len=cfg.max_seq_len, scales=cfg.scales,
            diffts_tau=cfg.diffts_tau, dtype=dtype, device=device)
        self.tta_module = TextConditionTokenAggregator(
            d_model=embed_size, num_layers=cfg.num_layers,
            num_heads=cfg.num_heads, attn_type=cfg.attn_type,
            max_seq_len=cfg.max_seq_len, dtype=dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.query_tokens.normal_(0.0, 0.02, generator=generator)

    def forward(self, v_token: torch.Tensor,
                t_token: torch.Tensor) -> torch.Tensor:
        b = v_token.shape[0]
        query = self.query_tokens.to(self.dtype).expand(b, -1, -1)
        v_token = self.svt_module(v_token)
        return self.tta_module(query, v_token, t_token)
