"""Multimodal projector (counterpart of
``u2tokenizer_tpu/models/projector.py``): the spatial-pooling projector
('spp') only. 2048 patch tokens -> declared-grid 3D average pool -> 256
tokens -> linear/mlp stack to the LLM width."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ProjectorConfig, VisionConfig
from ..ops.pooling import spatial_pool_3d
from .layers import Dense


class SpatialPoolingProjector(nn.Module):
    def __init__(self, cfg: ProjectorConfig, grid_pre: Tuple[int, int, int],
                 in_dim: int, out_dim: int, dtype=torch.float32, device=None):
        super().__init__()
        if cfg.pooling_type != "spatial":
            raise NotImplementedError(
                f"pooling_type={cfg.pooling_type!r} is not ported; "
                "only 'spatial'")
        self.cfg = cfg
        self.grid_pre = tuple(grid_pre)
        dims = [in_dim] + [out_dim] * int(cfg.layer_num)
        self.projector = nn.ModuleList(
            Dense(dims[i], dims[i + 1], True, dtype, device)
            for i in range(int(cfg.layer_num)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = spatial_pool_3d(x, self.grid_pre, self.cfg.pooling_size)
        x = self.projector[0](x)
        for layer in self.projector[1:]:
            if self.cfg.layer_type == "mlp":
                x = F.gelu(x, approximate="none")
            x = layer(x)
        return x


def build_projector(cfg: ProjectorConfig, vision: VisionConfig, out_dim: int,
                    dtype=torch.float32, device=None) -> nn.Module:
    if cfg.projector_type != "spp":
        raise NotImplementedError(
            f"projector_type={cfg.projector_type!r} is not ported; only 'spp'")
    return SpatialPoolingProjector(
        cfg, cfg.grid_pre(vision.image_size, vision.patch_size),
        vision.hidden_size, out_dim, dtype, device)
