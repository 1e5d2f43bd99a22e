"""3D Vision Transformer tower (counterpart of
``u2tokenizer_tpu/models/vit3d.py``).

Perceptron patch embedding (flattened-patch projection + learned position
embeddings), a zero-init cls token prepended after the position embeddings,
``num_layers`` pre-LN blocks with exact GELU, and a final LayerNorm. The
self-attention runs through ``ops.flash_attention`` (kernel K1 on the GPU).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VisionConfig
from ..ops.attention import sdpa
from ..ops.flash_attention import flash_attention
from .layers import Dense, LayerNorm, lecun_normal_


class _ConvProj(nn.Module):
    """Patch projection with the JAX package's flattened (pd*ph*pw*c, F)
    ``kernel``; feature index ((ipd*ph + iph)*pw + ipw)*c + ic. Runs as a
    reshape and one matmul: (B, C, D, H, W) -> (B, gd, gh, gw, F)."""

    def __init__(self, features: int, patch, in_channels: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.patch = tuple(patch)
        self.in_channels = in_channels
        self.dtype = dtype
        pd, ph, pw = self.patch
        flat = pd * ph * pw * in_channels
        self.kernel = nn.Parameter(torch.empty(flat, features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, d, h, w = x.shape
        pd, ph, pw = self.patch
        gd, gh, gw = d // pd, h // ph, w // pw
        x = x.to(self.dtype).reshape(b, c, gd, pd, gh, ph, gw, pw)
        x = x.permute(0, 2, 4, 6, 3, 5, 7, 1).reshape(
            b, gd, gh, gw, pd * ph * pw * c)
        return x @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)


class PatchEmbed3D(nn.Module):
    """(B, C, D, H, W) -> (B, gd*gh*gw, F) patch tokens + position
    embeddings, the patch grid row-major over (D, H, W)."""

    def __init__(self, cfg: VisionConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.proj = _ConvProj(cfg.hidden_size, cfg.patch_size, cfg.in_channels,
                              dtype, device)
        self.position_embeddings = nn.Parameter(
            torch.empty(1, cfg.num_patches, cfg.hidden_size, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax's truncated_normal(0.02, -2, 2): out-of-range draws are
        # redrawn, not clamped
        nn.init.trunc_normal_(self.position_embeddings, 0.0, 0.02, -0.04,
                              0.04, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.proj(x)
        y = y.reshape(y.shape[0], -1, self.cfg.hidden_size)
        return y + self.position_embeddings.to(y.dtype)


class SelfAttentionBlock(nn.Module):
    """Fused qkv projection (qkv-major feature layout), per-head attention,
    output projection."""

    def __init__(self, hidden_size: int, num_heads: int, qkv_bias: bool = False,
                 dtype=torch.float32, use_flash: bool = True, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.qkv = Dense(hidden_size, 3 * hidden_size, qkv_bias, dtype, device)
        self.out_proj = Dense(hidden_size, hidden_size, True, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, e = x.shape
        hd = self.hidden_size // self.num_heads
        qkv = self.qkv(x)
        # qkv-major: q, k and v are strided views into the fused projection
        q = qkv[..., :e].reshape(b, s, self.num_heads, hd)
        k = qkv[..., e:2 * e].reshape(b, s, self.num_heads, hd)
        v = qkv[..., 2 * e:].reshape(b, s, self.num_heads, hd)
        if self.use_flash:
            out = flash_attention(q, k, v)
        else:
            out = sdpa(q, k, v)
        return self.out_proj(out.reshape(b, s, e))


class TransformerBlock(nn.Module):
    """Pre-LN block: x += attn(LN(x)); x += mlp(LN(x))."""

    def __init__(self, hidden_size: int, mlp_dim: int, num_heads: int,
                 qkv_bias: bool = False, dtype=torch.float32,
                 use_flash: bool = True, device=None):
        super().__init__()
        self.norm1 = LayerNorm(hidden_size, dtype=dtype, device=device)
        self.attn = SelfAttentionBlock(hidden_size, num_heads, qkv_bias, dtype,
                                       use_flash, device)
        self.norm2 = LayerNorm(hidden_size, dtype=dtype, device=device)
        self.mlp_fc1 = Dense(hidden_size, mlp_dim, True, dtype, device)
        self.mlp_fc2 = Dense(mlp_dim, hidden_size, True, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        y = F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none")
        return x + self.mlp_fc2(y)


class ViT3D(nn.Module):
    """Full ViT returning (final normed tokens, per-block hidden states)."""

    def __init__(self, cfg: VisionConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.patch_embedding = PatchEmbed3D(cfg, dtype, device)
        if cfg.classification:
            self.cls_token = nn.Parameter(
                torch.empty(1, 1, cfg.hidden_size, device=device))
        self.blocks = nn.ModuleList(
            TransformerBlock(cfg.hidden_size, cfg.mlp_dim, cfg.num_heads,
                             cfg.qkv_bias, dtype, cfg.use_flash_attention,
                             device)
            for _ in range(cfg.num_layers))
        self.norm = LayerNorm(cfg.hidden_size, dtype=dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.cfg.classification:
            self.cls_token.zero_()

    def forward(self, x: torch.Tensor):
        x = self.patch_embedding(x)
        if self.cfg.classification:
            cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, -1)
            x = torch.cat([cls, x], dim=1)
        hidden_states = []
        for block in self.blocks:
            x = block(x)
            hidden_states.append(x)
        return self.norm(x), hidden_states


class ViT3DTower(nn.Module):
    """Feature-selecting wrapper: picks the output layer and strips the cls
    token for ``select_feature='patch'``."""

    def __init__(self, cfg: VisionConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.vision_tower = ViT3D(cfg, dtype, device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        last, hidden = self.vision_tower(images)
        if self.cfg.select_layer == -1:
            feats = last
        elif self.cfg.select_layer < -1:
            feats = hidden[self.cfg.select_layer]
        else:
            raise ValueError(f"Unexpected select layer: {self.cfg.select_layer}")
        if self.cfg.select_feature == "patch":
            if self.cfg.classification:
                feats = feats[:, 1:]
        elif self.cfg.select_feature != "cls_patch":
            raise ValueError(
                f"Unexpected select feature: {self.cfg.select_feature}")
        return feats
