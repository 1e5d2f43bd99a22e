"""Multimodal projectors (counterpart of
``u2tokenizer_tpu/models/projector.py``).

'spp', the spatial-pooling projector of the released models: 2048 patch
tokens, average-pooled over the declared 3D grid ('spatial') or in sequence
order ('sequence') to 256 tokens, then a linear/mlp stack to the LLM
width. 'linear' (``FullLinear``): one ``Dense`` a token, no pooling, so all
2048 tokens go on. 'identity': no projector and no ``mm_projector``
parameters; the ViT's width must then be the LLM's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ProjectorConfig, VisionConfig
from ..ops.pooling import sequence_pool, spatial_pool_3d
from .layers import Dense


class SpatialPoolingProjector(nn.Module):
    def __init__(self, cfg: ProjectorConfig, grid_pre: Tuple[int, int, int],
                 in_dim: int, out_dim: int, dtype=torch.float32, device=None):
        super().__init__()
        if cfg.pooling_type not in ("spatial", "sequence"):
            raise ValueError(f"Unknown pooling type: {cfg.pooling_type}")
        self.cfg = cfg
        self.grid_pre = tuple(grid_pre)
        dims = [in_dim] + [out_dim] * int(cfg.layer_num)
        self.projector = nn.ModuleList(
            Dense(dims[i], dims[i + 1], True, dtype, device)
            for i in range(int(cfg.layer_num)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.pooling_type == "spatial":
            x = spatial_pool_3d(x, self.grid_pre, self.cfg.pooling_size)
        else:
            x = sequence_pool(x, self.cfg.pooling_size)
        x = self.projector[0](x)
        for layer in self.projector[1:]:
            if self.cfg.layer_type == "mlp":
                x = F.gelu(x, approximate="none")
            x = layer(x)
        return x


class FullLinear(nn.Module):
    """One ``Dense`` a token, named ``linear`` under ``mm_projector``."""

    def __init__(self, in_dim: int, out_dim: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.linear = Dense(in_dim, out_dim, True, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x)


def build_projector(cfg: ProjectorConfig, vision: VisionConfig, out_dim: int,
                    dtype=torch.float32, device=None) -> Optional[nn.Module]:
    """The projector of ``cfg.projector_type``; None for 'identity'."""
    if cfg.projector_type == "spp":
        return SpatialPoolingProjector(
            cfg, cfg.grid_pre(vision.image_size, vision.patch_size),
            vision.hidden_size, out_dim, dtype, device)
    if cfg.projector_type == "linear":
        return FullLinear(vision.hidden_size, out_dim, dtype, device)
    if cfg.projector_type == "identity":
        if vision.hidden_size != out_dim:
            raise ValueError(
                f"projector_type 'identity' passes the ViT's "
                f"{vision.hidden_size}-wide features on as they are; the "
                f"LLM is {out_dim} wide: the widths must be equal")
        return None
    raise ValueError(f"Unknown projector type: {cfg.projector_type}")
