"""3D promptable segmentation head, SegVol (counterpart of
``u2tokenizer_tpu/models/seg.py``).

The reference vendors the SegVol stack in its remote modelling code
(modeling_u2Llama.py: ImageEncoderViT, PromptEncoder, MaskDecoder, SegVol;
the Dice and BCE losses) and drives it from the '[SEG]' token's hidden
state (src/demo/demo.py:64 ``generate(..., seg_enable=True)``). As in the
JAX package:

  * ``SegImageEncoder3D``: the patch embedding as a reshaped matmul, a
    learned position embedding, pre-LN blocks of global self-attention
    over every patch token (plain ``ops.attention.sdpa``, as the JAX
    package's XLA attention), a final norm and the ``neck`` to the prompt
    width; (B, 1, D, H, W) -> (B, Dg, Hg, Wg, C);
  * ``PromptEncoder3D``: the projected '[SEG]' state is the sparse prompt,
    a learned no-mask embedding the dense one, and random Fourier features
    of the grid's cell centres its positional encoding (``pe_gaussian`` is
    a trained parameter, kept in fp32 by ``cast_for_inference``);
  * ``MaskDecoder3D``: the SAM two-way transformer, learned IoU and mask
    tokens, two x2 transposed-convolution upscales and the hypernetwork;
  * ``SegVol3D``: the three, then a trilinear resize of the logits to the
    input's shape; ``SegProjector``: LLM hidden -> prompt width.

flax's GELU default is the tanh approximation, which the head keeps (the
ViT and the projector take the exact one). ``ConvTranspose3d`` keeps
flax's kernel layout (2, 2, 2, in, out); flax's transposed convolution
writes input voxel i's kernel tap 1 - a at output 2i + a, so the upscale
is one product with the spatially flipped kernel. ``trilinear_resize`` is
``jax.image.resize(..., "trilinear")``: a triangle kernel, widened by the
factor where an axis shrinks (antialiasing), normalised over the taps
inside the input, contracted one axis at a time.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import SegConfig
from ..ops.attention import sdpa
from .layers import Dense, LayerNorm, lecun_normal_


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu`` default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _normal_(w: torch.Tensor, std: float, generator: torch.Generator):
    """flax's ``initializers.normal(std)``: untruncated."""
    return nn.init.normal_(w, 0.0, std, generator=generator)


class ConvTranspose3d(nn.Module):
    """flax ``nn.ConvTranspose(out, (2, 2, 2), (2, 2, 2), 'SAME')`` on
    channels-last (B, D, H, W, in) -> (B, 2D, 2H, 2W, out). ``kernel`` is
    flax's (2, 2, 2, in, out); init lecun-normal over its fan-in 8 * in,
    zero bias."""

    def __init__(self, in_features: int, out_features: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(2, 2, 2, in_features,
                                               out_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, 8 * self.kernel.shape[3], generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, _ = x.shape
        k = self.kernel.flip(0, 1, 2).to(self.dtype)
        y = torch.einsum("bdhwi,xyzio->bdxhywzo", x.to(self.dtype), k)
        y = y.reshape(b, 2 * d, 2 * h, 2 * w, k.shape[-1])
        return y + self.bias.to(self.dtype)


class SegImageEncoder3D(nn.Module):
    def __init__(self, cfg: SegConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        pd, ph, pw = cfg.patch_size
        c, n = cfg.encoder_dim, math.prod(cfg.feat_shape)
        layers = range(cfg.encoder_layers)
        self.patch_embed = Dense(pd * ph * pw, c, True, dtype, device)
        self.pos_embed = nn.Parameter(torch.empty(1, n, c, device=device))
        self.norm1 = nn.ModuleList(LayerNorm(c, dtype=dtype, device=device)
                                   for _ in layers)
        self.qkv = nn.ModuleList(Dense(c, 3 * c, True, dtype, device)
                                 for _ in layers)
        self.attn_out = nn.ModuleList(Dense(c, c, True, dtype, device)
                                      for _ in layers)
        self.norm2 = nn.ModuleList(LayerNorm(c, dtype=dtype, device=device)
                                   for _ in layers)
        self.mlp1 = nn.ModuleList(Dense(c, 4 * c, True, dtype, device)
                                  for _ in layers)
        self.mlp2 = nn.ModuleList(Dense(4 * c, c, True, dtype, device)
                                  for _ in layers)
        self.norm = LayerNorm(c, dtype=dtype, device=device)
        self.neck = Dense(c, cfg.prompt_dim, True, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.pos_embed, 0.02, generator)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """(B, 1, D, H, W) -> (B, Dg, Hg, Wg, prompt_dim)."""
        cfg = self.cfg
        b = image.shape[0]
        pd, ph, pw = cfg.patch_size
        dg, hg, wg = cfg.feat_shape
        x = image.reshape(b, 1, dg, pd, hg, ph, wg, pw)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, dg * hg * wg,
                                                      pd * ph * pw)
        x = self.patch_embed(x) + self.pos_embed.to(self.dtype)
        hd = cfg.encoder_dim // cfg.encoder_heads
        for i in range(cfg.encoder_layers):
            q, k, v = self.qkv[i](self.norm1[i](x)).chunk(3, dim=-1)
            shape = (b, -1, cfg.encoder_heads, hd)
            o = sdpa(q.reshape(shape), k.reshape(shape), v.reshape(shape))
            x = x + self.attn_out[i](o.reshape(b, -1, cfg.encoder_dim))
            x = x + self.mlp2[i](gelu(self.mlp1[i](self.norm2[i](x))))
        x = self.neck(self.norm(x))
        return x.reshape(b, dg, hg, wg, cfg.prompt_dim)


class PromptEncoder3D(nn.Module):
    """Text prompt + the grid's random-Fourier positional encoding."""

    keep_fp32 = ("pe_gaussian",)

    def __init__(self, cfg: SegConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        p = cfg.prompt_dim
        self.pe_gaussian = nn.Parameter(torch.empty(3, p // 2, device=device))
        self.no_mask_embed = nn.Parameter(torch.empty(1, p, device=device))
        self.text_proj = Dense(p, p, True, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.pe_gaussian, 1.0, generator)
        _normal_(self.no_mask_embed, 0.02, generator)

    def _fourier(self, coords: torch.Tensor) -> torch.Tensor:
        """[0, 1] coords (..., 3) -> (..., prompt_dim) sin/cos features."""
        proj = (2.0 * coords - 1.0) @ self.pe_gaussian.to(coords.dtype)
        proj = 2.0 * math.pi * proj
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)

    def dense_pe(self) -> torch.Tensor:
        """(1, Dg*Hg*Wg, prompt_dim) encoding of the feature grid."""
        dev = self.pe_gaussian.device
        axes = [(torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n
                for n in self.cfg.feat_shape]
        grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
        return self._fourier(grid.reshape(1, -1, 3)).to(self.dtype)

    def forward(self, text_embedding: Optional[torch.Tensor], batch: int):
        """-> (sparse (B, n, prompt_dim), dense (B, Dg*Hg*Wg, prompt_dim))."""
        p = self.cfg.prompt_dim
        n = math.prod(self.cfg.feat_shape)
        if text_embedding is None:
            sparse = torch.zeros(batch, 0, p, dtype=self.dtype,
                                 device=self.pe_gaussian.device)
        else:
            sparse = self.text_proj(text_embedding)
            if sparse.dim() == 2:
                sparse = sparse[:, None, :]
        dense = self.no_mask_embed.to(self.dtype)[None].expand(batch, n, p)
        return sparse, dense


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int, downsample: int = 1,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.heads = heads
        inner = dim // downsample
        self.q_proj = Dense(dim, inner, True, dtype, device)
        self.k_proj = Dense(dim, inner, True, dtype, device)
        self.v_proj = Dense(dim, inner, True, dtype, device)
        self.out_proj = Dense(inner, dim, True, dtype, device)

    def forward(self, q, k, v):
        b = q.shape[0]
        inner = self.q_proj.weight.shape[0]
        shape = (b, -1, self.heads, inner // self.heads)
        o = sdpa(self.q_proj(q).reshape(shape), self.k_proj(k).reshape(shape),
                 self.v_proj(v).reshape(shape))
        return self.out_proj(o.reshape(b, -1, inner))


class TwoWayBlock(nn.Module):
    def __init__(self, cfg: SegConfig, skip_first_pe: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.skip_first_pe = skip_first_pe
        p, h = cfg.prompt_dim, cfg.decoder_heads
        self.self_attn = _Attention(p, h, 1, dtype, device)
        self.norm1 = LayerNorm(p, dtype=dtype, device=device)
        self.cross_t2i = _Attention(p, h, 2, dtype, device)
        self.norm2 = LayerNorm(p, dtype=dtype, device=device)
        self.mlp1 = Dense(p, 4 * p, True, dtype, device)
        self.mlp2 = Dense(4 * p, p, True, dtype, device)
        self.norm3 = LayerNorm(p, dtype=dtype, device=device)
        self.cross_i2t = _Attention(p, h, 2, dtype, device)
        self.norm4 = LayerNorm(p, dtype=dtype, device=device)

    def forward(self, tokens, image, token_pe, image_pe):
        q = tokens if self.skip_first_pe else tokens + token_pe
        tokens = self.norm1(tokens + self.self_attn(q, q, tokens))
        q = tokens + token_pe
        tokens = self.norm2(tokens + self.cross_t2i(q, image + image_pe,
                                                    image))
        tokens = self.norm3(tokens + self.mlp2(torch.relu(self.mlp1(tokens))))
        q = tokens + token_pe
        image = self.norm4(image + self.cross_i2t(image + image_pe, q, tokens))
        return tokens, image


class MaskDecoder3D(nn.Module):
    def __init__(self, cfg: SegConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        p = cfg.prompt_dim
        self.iou_token = nn.Parameter(torch.empty(1, 1, p, device=device))
        self.mask_token = nn.Parameter(torch.empty(1, 1, p, device=device))
        self.block = nn.ModuleList(
            TwoWayBlock(cfg, i == 0, dtype, device)
            for i in range(cfg.decoder_layers))
        self.final_t2i = _Attention(p, cfg.decoder_heads, 2, dtype, device)
        self.norm_final = LayerNorm(p, dtype=dtype, device=device)
        self.iou_head = Dense(p, 1, True, dtype, device)
        self.up1 = ConvTranspose3d(p, p // 4, dtype, device)
        self.up_norm = LayerNorm(p // 4, dtype=dtype, device=device)
        self.up2 = ConvTranspose3d(p // 4, p // 8, dtype, device)
        self.hyper = nn.ModuleList(Dense(p, p, True, dtype, device)
                                   for _ in range(2))
        self.hyper_out = Dense(p, p // 8, True, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.iou_token, 0.02, generator)
        _normal_(self.mask_token, 0.02, generator)

    def forward(self, image_emb, image_pe, sparse, dense):
        """image_emb, dense: (B, N, C) -> (mask logits (B, 1, 4Dg, 4Hg,
        4Wg), iou (B, 1))."""
        c = self.cfg
        b, _, p = image_emb.shape
        out_tokens = torch.cat([self.iou_token, self.mask_token], dim=1)
        tokens = torch.cat([out_tokens.to(self.dtype).expand(b, 2, p),
                            sparse.to(self.dtype)], dim=1)
        token_pe = tokens  # SAM's initial tokens are their own encoding
        image = image_emb + dense
        pe = image_pe.expand(image.shape)
        for blk in self.block:
            tokens, image = blk(tokens, image, token_pe, pe)
        q = tokens + token_pe
        tokens = self.norm_final(tokens + self.final_t2i(q, image + pe, image))
        iou_pred = self.iou_head(tokens[:, 0])
        mask_tok = tokens[:, 1]

        x = image.reshape(b, *c.feat_shape, p)
        x = gelu(self.up_norm(self.up1(x)))
        x = gelu(self.up2(x))
        h = mask_tok
        for layer in self.hyper:
            h = torch.relu(layer(h))
        h = self.hyper_out(h)
        logits = torch.einsum("bdhwc,bc->bdhw", x, h)[:, None]
        return logits, iou_pred


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize``'s linear kernel along
    one axis, in fp32: antialiased (the triangle widened by n_in / n_out)
    where the axis shrinks, each column normalised over its taps, columns
    whose sample lies outside the input zeroed."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs()
    w = (1.0 - x / kernel_scale).clamp_min(0.0)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def trilinear_resize(x: torch.Tensor, size: Tuple[int, int, int]
                     ) -> torch.Tensor:
    """(B, C, D, H, W) -> (B, C, *size), ``jax.image.resize(x, ...,
    "trilinear")`` in both directions: one axis at a time in x's dtype,
    with the weights rounded to it, as XLA contracts a bf16 input."""
    y = x
    for axis, n_out in zip((2, 3, 4), size):
        n_in = y.shape[axis]
        if n_in == n_out:
            continue
        w = _resize_weights(n_in, n_out, y.device).to(y.dtype)
        y = torch.tensordot(y.movedim(axis, -1), w, dims=1).movedim(-1, axis)
    return y


class SegVol3D(nn.Module):
    """The promptable pipeline (modeling_u2Llama.py SegVol)."""

    def __init__(self, cfg: SegConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = SegImageEncoder3D(cfg, dtype, device)
        self.prompt_encoder = PromptEncoder3D(cfg, dtype, device)
        self.mask_decoder = MaskDecoder3D(cfg, dtype, device)

    def forward(self, image: torch.Tensor,
                text_embedding: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, 1, D, H, W) + optional (B, prompt_dim) prompt -> (B, 1, D,
        H, W) mask logits."""
        b = image.shape[0]
        feats = self.image_encoder(image).reshape(b, -1, self.cfg.prompt_dim)
        sparse, dense = self.prompt_encoder(text_embedding, b)
        low_res, _ = self.mask_decoder(feats, self.prompt_encoder.dense_pe(),
                                       sparse, dense)
        return trilinear_resize(low_res, tuple(image.shape[2:]))


class SegProjector(nn.Module):
    """LLM '[SEG]' hidden state -> seg text prompt (the reference's
    model.seg_projector.{0,2}): Dense, GELU, Dense."""

    def __init__(self, in_dim: int, out_dim: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.fc1 = Dense(in_dim, out_dim, True, dtype, device)
        self.fc2 = Dense(out_dim, out_dim, True, dtype, device)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(hidden)))


# ---------------------------------------------------------------------------
# losses (modeling_u2Llama.py BinaryDiceLoss / BCELoss), in fp32
# ---------------------------------------------------------------------------

def dice_loss(logits: torch.Tensor, target: torch.Tensor,
              smooth: float = 1.0) -> torch.Tensor:
    """Soft binary Dice over sigmoid(logits); mean over the batch."""
    p = torch.sigmoid(logits.float()).reshape(logits.shape[0], -1)
    t = target.float().reshape(target.shape[0], -1)
    num = 2.0 * (p * t).sum(-1) + smooth
    den = (p * p).sum(-1) + (t * t).sum(-1) + smooth
    return (1.0 - num / den).mean()


def bce_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    z, t = logits.float(), target.float()
    return (z.clamp_min(0) - z * t + torch.log1p(torch.exp(-z.abs()))).mean()


def seg_loss(logits: torch.Tensor, target: torch.Tensor,
             bce_weight: float = 1.0, dice_weight: float = 1.0
             ) -> torch.Tensor:
    return (bce_weight * bce_loss(logits, target)
            + dice_weight * dice_loss(logits, target))
