"""Decoder-only LM stack (counterpart of
``u2tokenizer_tpu/models/llm/decoder.py``), Qwen3/Llama/Phi-3 family:
RMSNorm, GQA attention with RoPE and optional per-head q/k RMSNorm, SwiGLU
MLP, tied or separate fp32 LM head. Phi-2's switches are ported as the JAX
package has them: LayerNorm (``norm_type``), a tanh-GELU MLP ``fc1``/``fc2``
(``mlp_type``), attention and MLP reading one pre-norm (``parallel_block``),
RoPE over the leading dims of each head only (``partial_rotary_factor``),
and biases on the projections and the LM head. Weights are float (bf16 for
serving) or weight-only int8/int4 (``QDense``, ``models.quantize``), with
``cfg.lora_rank`` > 0 a low-rank fp32 adapter on every attention and MLP
projection over any of them (QLoRA, ``train.lora``).

Attention routing mirrors the JAX package's:
  * a prefill (S > 1, ``lens`` given, attending its own fresh K/V) goes to
    ``flash_attention(causal=True)``, kernel K2 on the GPU;
  * a single-token decode over the int8 or int4 cache with
    ``decode_bounds`` goes to ``decode_attention_quantized``, kernel K3 on
    the GPU (the JAX package takes its kernel for the int4 cache only
    behind a switch, and otherwise the same function in XLA);
  * with a case-shared prefix cache (``prefix_kv``, fan-out decoding) a
    cached step or block attends [prefix ; own cache] through
    ``gqa_sdpa_fanout``;
  * anything else runs the plain masked attention of ``ops.attention``.

The KV cache is updated in place (the JAX package returns a new one); the
functions still return it so the call sites read like their counterparts.
``write_index`` is a Python int (every row writes at that slot) or a (B,)
int32 tensor on the cache's device: row b's S tokens go to slots
``write_index[b] + [0, S)`` by an indexed copy that reads no offset on the
host, and such a per-row block (a speculative verify block, a chunk of a
chunked prefill) attends the whole cache under ``mask``, not its fresh
K/V. On CUDA an index past the buffer is a device assert, so callers size
the cache with the slack their blocks need.

``remat`` (True or "nothing") checkpoints each decoder layer while
gradients are recorded, the counterpart of the JAX package's
``nn.remat(DecoderLayer, policy=nothing_saveable)``: the layer keeps only
its input and runs its forward again in the backward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...config import LLMConfig
from ...ops.attention import (gqa_sdpa, gqa_sdpa_fanout,
                              gqa_sdpa_headmajor, gqa_sdpa_quantized,
                              pack_nibbles, quantize_kv, unpack_nibbles)
from ...ops.decode_attention import decode_attention_quantized
from ...ops.flash_attention import flash_attention
from ...ops.rotary import apply_rope, rope_cos_sin
from ..layers import Dense, LayerNorm


@dataclass
class KVCache:
    """Per-layer head-major buffers: k/v (B, Hkv, max_len, D), each head's
    keys contiguous. With ``dtype="int8"`` or ``"int4"`` values are stored
    quantized with per-(position, head) bf16 scales in (B, Hkv, max_len)
    buffers. torch has no int4 dtype, so the int4 cache is packed: k/v
    (B, Hkv, max_len, D/2) int8, two values a byte along D, the low nibble
    the even d, each in [-7, 7] and read sign-extended
    (``ops.attention.pack_nibbles``)."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    k_scale: Optional[List[torch.Tensor]] = None
    v_scale: Optional[List[torch.Tensor]] = None

    @classmethod
    def create(cls, cfg: LLMConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> "KVCache":
        shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
        zeros = lambda sh, dt: [torch.zeros(sh, dtype=dt, device=device)
                                for _ in range(cfg.num_layers)]
        if dtype in ("int8", torch.int8, "int4"):
            if dtype == "int4":
                shape = shape[:-1] + (cfg.head_dim // 2,)
            sshape = (batch, cfg.num_kv_heads, max_len)
            return cls(k=zeros(shape, torch.int8), v=zeros(shape, torch.int8),
                       k_scale=zeros(sshape, torch.bfloat16),
                       v_scale=zeros(sshape, torch.bfloat16))
        return cls(k=zeros(shape, dtype), v=zeros(shape, dtype))

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2]


def quant_mode(quantized) -> Optional[str]:
    """``LLMConfig.quantized_weights`` (False, True, "int8" or "int4") ->
    None, "int8" or "int4"."""
    if not quantized:
        return None
    return "int4" if quantized == "int4" else "int8"


def int4_group(in_features: int, group: int = 128) -> int:
    """Quantization group length along the input dim (per-channel when the
    group does not divide the input width)."""
    return group if in_features % group == 0 else in_features


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 weight values pairwise along the group axis:
    (ng, g, out) -> (ng, g/2, out) int8, low nibble = even index, as the
    JAX package's ``pack_int4``."""
    return pack_nibbles(q, dim=1)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4``: (ng, g/2, out) -> (ng, g, out) int8 with
    sign-extended nibble values."""
    return unpack_nibbles(packed, dim=1)


class QDense(Dense):
    """Dense with optional weight-only quantization (the JAX package's
    ``QDense``), in one of three modes:

      * float (``mode`` None): ``Dense``, weight (out, in);
      * "int8": weight (out, in) int8, the JAX package's (in, out) kernel
        transposed, and ``scale`` (out,) fp32 per output channel;
        y = (x W^T in ``dtype``) * scale, then the bias. With
        ``out_tiles`` > 1 and at least 128 tokens the product runs over
        that many slices of the output columns, the same contraction;
      * "int4": weight (ng, g/2, out) int8 of packed nibble pairs
        (``pack_int4``, the JAX package's layout, not transposed) and
        ``scale`` (ng, out) fp32 per (group, output). Below g tokens it
        contracts each group, then the scales; from g tokens on it
        dequantizes the weight and contracts once. The two orders round
        differently in bf16, so both are kept, as in the JAX package.

    Quantized weights and scales are parameters that take no gradient, so
    ``state_dict`` carries them. ``models.quantize.quantize_llm_weights``
    turns a float layer into a quantized one; a layer built quantized
    holds zeros and unit scales until weights are loaded, as the JAX
    package's init does.

    ``lora_rank`` r > 0 adds the JAX package's low-rank branch over any
    mode: y += (x @ lora_a @ lora_b) * lora_scale in ``dtype``, before the
    bias, with fp32 ``lora_a`` (in, r) drawn from N(0, 1/r) and ``lora_b``
    (r, out) zero, so that the layer starts at its base (``add_lora``
    attaches the pair to a built layer)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, device=None, quantized=False,
                 out_tiles: int = 0, lora_rank: int = 0,
                 lora_scale: float = 1.0):
        super().__init__(in_features, out_features, bias, dtype, device)
        self.out_tiles = out_tiles
        self.mode = None
        self.lora_rank = 0
        if lora_rank:
            self.add_lora(lora_rank, lora_scale)
        mode = quant_mode(quantized)
        if mode == "int4":
            g = int4_group(in_features)
            if g % 2:
                raise ValueError(f"int4 needs an even group, got {g}")
            ng = in_features // g
            self.set_weight(
                mode, torch.zeros(ng, g // 2, out_features, dtype=torch.int8,
                                  device=device),
                torch.ones(ng, out_features, device=device))
        elif mode == "int8":
            self.set_weight(
                mode, torch.zeros(out_features, in_features, dtype=torch.int8,
                                  device=device),
                torch.ones(out_features, device=device))

    def set_weight(self, mode: Optional[str], weight: torch.Tensor,
                   scale: Optional[torch.Tensor] = None) -> None:
        """Replace the weight: float (out, in) with ``mode`` None, else the
        quantized weight and its scales in the layouts above."""
        self.mode = mode
        if mode is None:
            self.weight = nn.Parameter(weight)
            self.scale = None
        else:
            self.weight = nn.Parameter(weight, requires_grad=False)
            self.scale = nn.Parameter(scale, requires_grad=False)

    def add_lora(self, rank: int, scale: float,
                 generator: Optional[torch.Generator] = None) -> None:
        """Attach a fresh adapter pair of rank ``rank`` (``lora_a`` drawn
        from ``generator`` when given, else left for ``reset_parameters``;
        ``lora_b`` zero)."""
        in_f = self.weight.shape[1] if self.mode != "int4" else \
            self.weight.shape[0] * self.weight.shape[1] * 2
        out_f = self.weight.shape[0] if self.mode != "int4" else \
            self.weight.shape[2]
        dev = self.weight.device
        self.lora_rank, self.lora_scale = rank, scale
        self.lora_a = nn.Parameter(torch.zeros(in_f, rank, device=dev))
        self.lora_b = nn.Parameter(torch.zeros(rank, out_f, device=dev))
        if generator is not None:
            self._draw_lora(generator)

    @torch.no_grad()
    def _draw_lora(self, generator: torch.Generator) -> None:
        self.lora_a.normal_(0.0, self.lora_rank ** -0.5, generator=generator)
        self.lora_b.zero_()

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.mode is None:
            super().reset_parameters(generator)
        else:
            self.weight.zero_()
            self.scale.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()
        if self.lora_rank:
            self._draw_lora(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode is None and not self.lora_rank:
            return super().forward(x)
        dt = self.dtype
        x = x.to(dt)
        tokens = x.numel() // x.shape[-1]
        if self.mode is None:
            y = F.linear(x, self.weight.to(dt))
        elif self.mode == "int4":
            ng, half, _ = self.weight.shape
            xg = x.reshape(*x.shape[:-1], ng, 2 * half)
            w = unpack_int4(self.weight).to(dt)
            if tokens < 2 * half:  # decode: per-group partials, then scales
                part = torch.einsum("...gi,gio->...go", xg, w)
                # batched over o, this einsum leaves o outermost in memory;
                # the decode kernel K3 takes q contiguous
                y = torch.einsum("...go,go->...o", part,
                                 self.scale.to(dt)).contiguous()
            else:  # prefill: dequantize, then one contraction over (g, i)
                w = w * self.scale.to(dt)[:, None, :]
                y = torch.einsum("...gi,gio->...o", xg, w)
        elif (self.out_tiles > 1 and tokens >= 128
              and self.weight.shape[0] % self.out_tiles == 0):
            y = torch.cat([F.linear(x, w.to(dt)) * s.to(dt) for w, s in zip(
                self.weight.chunk(self.out_tiles),
                self.scale.chunk(self.out_tiles))], dim=-1)
        else:
            y = F.linear(x, self.weight.to(dt)) * self.scale.to(dt)
        if self.lora_rank:
            y = y + (x @ self.lora_a.to(dt) @ self.lora_b.to(dt)) * \
                torch.tensor(self.lora_scale, dtype=dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (xf * self.weight.float()).to(self.dtype)


def make_norm(cfg: LLMConfig, dtype=torch.bfloat16, device=None) -> nn.Module:
    """The decoder's norm: flax's LayerNorm (Phi-2) or RMSNorm, both with
    epsilon ``rms_norm_eps``."""
    cls = LayerNorm if cfg.norm_type == "layernorm" else RMSNorm
    return cls(cfg.hidden_size, cfg.rms_norm_eps, dtype, device)


def rope_dim(cfg: LLMConfig) -> int:
    """The leading dims of a head that RoPE rotates: head_dim times
    ``partial_rotary_factor``, rounded down to an even number."""
    rot = int(cfg.head_dim * cfg.partial_rotary_factor)
    return rot - rot % 2


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """RoPE over the leading ``cos.shape[-1]`` dims of x's heads; the rest
    pass through (Phi-2's partial rotary)."""
    rot = cos.shape[-1]
    if rot == x.shape[-1]:
        return apply_rope(x, cos, sin)
    return torch.cat([apply_rope(x[..., :rot], cos, sin), x[..., rot:]], -1)


def lora_args(cfg: LLMConfig) -> dict:
    """The adapter arguments of a decoder projection: rank and the scale
    alpha / r (the JAX package's ``lora_scale``)."""
    return {"lora_rank": cfg.lora_rank,
            "lora_scale": cfg.lora_alpha / max(cfg.lora_rank, 1)}


class Attention(nn.Module):
    def __init__(self, cfg: LLMConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        hd, e = cfg.head_dim, cfg.hidden_size
        bias, quant, lora = cfg.attention_bias, cfg.quantized_weights, \
            lora_args(cfg)
        self.q_proj = QDense(e, cfg.num_heads * hd, bias, dtype, device, quant,
                             **lora)
        self.k_proj = QDense(e, cfg.num_kv_heads * hd, bias, dtype, device,
                             quant, **lora)
        self.v_proj = QDense(e, cfg.num_kv_heads * hd, bias, dtype, device,
                             quant, **lora)
        self.o_proj = QDense(cfg.num_heads * hd, e, bias, dtype, device, quant,
                             **lora)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, cfg.rms_norm_eps, dtype, device)
            self.k_norm = RMSNorm(hd, cfg.rms_norm_eps, dtype, device)

    def forward(self, x, rope, mask, cache_kv=None, write_index=None,
                lens=None, decode_bounds=None, prefix_kv=None,
                prefix_mask=None):
        """x (B, S, E); rope the (cos, sin) tables of the positions, each
        (B, S, rope_dim); mask bool (B, 1, S, Sk); cache_kv
        (k, v, k_scale, v_scale) head-major buffers written in place at
        ``write_index`` (an int, or a (B,) int32 tensor: per row); lens
        (B,) right-pad valid lengths; decode_bounds (prompt_len (B,),
        end (B,), s_prompt int); prefix_kv (k, v, k_scale, v_scale) a
        prefix cache of C = B / n rows shared by each group of n rows
        (row c*n + j reads case c) with prefix_mask (C, Sp) its valid
        keys."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        q = self.q_proj(x).reshape(b, s, cfg.num_heads, hd)
        k = self.k_proj(x).reshape(b, s, cfg.num_kv_heads, hd)
        v = self.v_proj(x).reshape(b, s, cfg.num_kv_heads, hd)
        if cfg.qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        cos, sin = rope
        q = _rope(q, cos, sin)
        k = _rope(k, cos, sin)

        quantized_decode = cached_decode = False
        k_att, v_att = k, v
        if cache_kv is not None:
            ck, cv, ks, vs = cache_kv
            per_row = torch.is_tensor(write_index) and write_index.dim() == 1
            write = _row_writer(write_index, b, s) if per_row else \
                _slice_writer(write_index, s)
            if ks is not None:  # int8/int4 cache: quantize on write
                kind = "int4" if ck.shape[-1] != hd else "int8"  # int4: D/2
                k_q, k_s = quantize_kv(k, dtype=kind)
                v_q, v_s = quantize_kv(v, dtype=kind)
                if kind == "int4":
                    k_q, v_q = pack_nibbles(k_q), pack_nibbles(v_q)
                write(ck, k_q)
                write(cv, v_q)
                write(ks, k_s[..., 0])
                write(vs, v_s[..., 0])
                quantized_decode = s == 1 or per_row
            else:
                write(ck, k)
                write(cv, v)
            if s == 1 or per_row:
                # a single-token step or a per-row block attends the whole
                # cache under the mask. A prefill (written at offset 0)
                # attends its fresh k/v, exact even with a quantized cache.
                k_att, v_att = ck, cv
                cached_decode = True

        use_flash = (cfg.use_flash_attention and lens is not None and s > 1
                     and not cached_decode)
        if prefix_kv is not None and cached_decode:
            pk, pv, pks, pvs = prefix_kv
            out = gqa_sdpa_fanout(q, pk, pv, ck, cv, pk_scale=pks,
                                  pv_scale=pvs, sk_scale=ks, sv_scale=vs,
                                  prefix_mask=prefix_mask, suffix_mask=mask)
        elif quantized_decode:
            if (s == 1 and decode_bounds is not None
                    and cfg.use_flash_attention):
                plen, end, s_prompt = decode_bounds
                out = decode_attention_quantized(q, ck, ks, cv, vs, plen, end,
                                                 s_prompt)
            else:
                out = gqa_sdpa_quantized(q, ck, ks, cv, vs, mask=mask)
        elif use_flash:
            out = flash_attention(q, k_att, v_att, lens, causal=True)
        elif cached_decode:
            out = gqa_sdpa_headmajor(q, k_att.to(self.dtype),
                                     v_att.to(self.dtype), mask=mask)
        else:
            out = gqa_sdpa(q, k_att.to(self.dtype), v_att.to(self.dtype),
                           mask=mask)
        return self.o_proj(out.reshape(b, s, cfg.num_heads * hd)), cache_kv


def _slice_writer(w: int, s: int):
    """Writes (B, S, Hkv, ...) values into head-major (B, Hkv, L, ...)
    buffers at slots [w, w + S) of every row."""
    def write(buf, val):
        buf[:, :, w:w + s] = val.transpose(1, 2).to(buf.dtype)
    return write


def _row_writer(write_index: torch.Tensor, b: int, s: int):
    """Writes (B, S, Hkv, ...) values into head-major (B, Hkv, L, ...)
    buffers at slots write_index[b] + [0, S) of row b: one indexed copy
    (``index_put_``) on the buffer's device, with no host read."""
    rows = torch.arange(b, device=write_index.device)[:, None]
    slots = write_index.long()[:, None] + torch.arange(
        s, device=write_index.device)[None, :]

    def write(buf, val):
        # indices (B, 1) and (B, S) around a full slice: buf[r, :, p]
        # addresses (B, S, Hkv, ...) elements, val's own layout
        buf[rows, :, slots] = val.to(buf.dtype)
    return write


class MLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x)); or Phi-2's fc2(gelu(fc1(x)))
    with tanh GELU (HF ``gelu_new``) and ``mlp_bias``."""

    def __init__(self, cfg: LLMConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        e, m = cfg.hidden_size, cfg.intermediate_size
        quant, lora = cfg.quantized_weights, lora_args(cfg)
        self.gelu = cfg.mlp_type == "gelu"
        if self.gelu:
            self.fc1 = QDense(e, m, cfg.mlp_bias, dtype, device, quant, **lora)
            self.fc2 = QDense(m, e, cfg.mlp_bias, dtype, device, quant, **lora)
            return
        self.gate_proj = QDense(e, m, False, dtype, device, quant, **lora)
        self.up_proj = QDense(e, m, False, dtype, device, quant, **lora)
        self.down_proj = QDense(m, e, False, dtype, device, quant, **lora)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gelu:
            return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DecoderLayer(nn.Module):
    """Pre-norm attention then MLP; with ``parallel_block`` (Phi-2) both
    read the one pre-norm: x + attn(y) + mlp(y), and there is no
    ``post_attention_layernorm``."""

    def __init__(self, cfg: LLMConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.parallel = cfg.parallel_block
        self.input_layernorm = make_norm(cfg, dtype, device)
        self.self_attn = Attention(cfg, dtype, device)
        if not self.parallel:
            self.post_attention_layernorm = make_norm(cfg, dtype, device)
        self.mlp = MLP(cfg, dtype, device)

    def forward(self, x, rope, mask, cache_kv=None, write_index=None,
                lens=None, decode_bounds=None, prefix_kv=None,
                prefix_mask=None):
        y = self.input_layernorm(x)
        attn_out, cache_kv = self.self_attn(
            y, rope, mask, cache_kv, write_index, lens, decode_bounds,
            prefix_kv, prefix_mask)
        if self.parallel:
            return x + attn_out + self.mlp(y), cache_kv
        x = x + attn_out
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, cache_kv


def remat_enabled(remat) -> bool:
    """TrainConfig.remat -> whether decoder layers are checkpointed: True or
    "nothing" (full recompute) or False or "off". The JAX package's policies
    that keep matmul outputs are not ported."""
    if remat in (True, "nothing"):
        return True
    if remat in (False, "off"):
        return False
    if remat in ("dots", "dots_no_batch"):
        raise NotImplementedError(f"remat policy {remat!r} is not ported yet")
    raise ValueError(f"unknown remat policy {remat!r}")


class DecoderModel(nn.Module):
    """Embedding table + decoder layers + final norm. With
    ``cfg.quantized_weights`` the table is int8 (V, E) with a (V, 1) fp32
    ``embed_scale`` per row, rows rescaled on lookup, in every mode."""

    def __init__(self, cfg: LLMConfig, dtype=torch.bfloat16, device=None,
                 remat=False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat_enabled(remat)
        shape = (cfg.vocab_size, cfg.hidden_size)
        if cfg.quantized_weights:
            self.set_embedding(
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.ones(cfg.vocab_size, 1, device=device))
        else:
            self.set_embedding(torch.empty(shape, device=device))
        self.layers = nn.ModuleList(DecoderLayer(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        self.norm = make_norm(cfg, dtype, device)

    @property
    def quantized(self) -> bool:
        return self.embed_scale is not None

    def set_embedding(self, table: torch.Tensor,
                      scale: Optional[torch.Tensor] = None) -> None:
        """Replace the table: float, or int8 with its (V, 1) row scales."""
        if scale is None:
            self.embed_tokens = nn.Parameter(table)
            self.embed_scale = None
        else:
            self.embed_tokens = nn.Parameter(table, requires_grad=False)
            self.embed_scale = nn.Parameter(scale, requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.quantized:
            self.embed_tokens.zero_()
            self.embed_scale.fill_(1.0)
        else:
            self.embed_tokens.normal_(0.0, 0.02, generator=generator)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        if self.quantized:
            return (self.embed_tokens[input_ids].to(self.dtype)
                    * self.embed_scale[input_ids].to(self.dtype))
        return F.embedding(input_ids, self.embed_tokens).to(self.dtype)

    def forward(self, inputs_embeds, positions, mask, cache=None,
                write_index=None, lens=None, decode_bounds=None,
                prefix_cache=None, prefix_mask=None):
        cfg = self.cfg
        x = inputs_embeds.to(self.dtype)
        # one rotary table for all layers, over the dims that rotate
        scaling = (cfg.rope_scaling_type, cfg.rope_scaling_factor,
                   cfg.rope_low_freq_factor, cfg.rope_high_freq_factor,
                   cfg.rope_original_max_position)
        rope = rope_cos_sin(positions, rope_dim(cfg), cfg.rope_theta,
                            scaling=scaling)
        for i, layer in enumerate(self.layers):
            args = (x, rope, mask, _layer_kv(cache, i), write_index, lens,
                    decode_bounds, _layer_kv(prefix_cache, i), prefix_mask)
            if self.remat and torch.is_grad_enabled():
                x, _ = checkpoint(layer, *args, use_reentrant=False)
            else:
                x, _ = layer(*args)
        return self.norm(x), cache


def _layer_kv(cache: Optional[KVCache], i: int):
    """Layer i's (k, v, k_scale, v_scale) of ``cache``, or None."""
    if cache is None:
        return None
    return (cache.k[i], cache.v[i],
            cache.k_scale[i] if cache.quantized else None,
            cache.v_scale[i] if cache.quantized else None)


class CausalLM(nn.Module):
    """DecoderModel + LM head (tied to the embedding table or separate).
    With quantized weights an untied ``lm_head`` is int8 in both modes,
    as in the JAX package."""

    def __init__(self, cfg: LLMConfig, dtype=torch.bfloat16, device=None,
                 remat=False):
        super().__init__()
        self.cfg = cfg
        self.model = DecoderModel(cfg, dtype, device, remat)
        if not cfg.tie_word_embeddings:
            quant = cfg.quantized_weights
            self.lm_head = QDense(cfg.hidden_size, cfg.vocab_size,
                                  cfg.lm_head_bias, dtype, device,
                                  "int8" if quant == "int4" else quant,
                                  cfg.lm_head_tiles)

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.model.embed(input_ids)

    def lm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Hidden states -> fp32 vocabulary logits."""
        if self.cfg.tie_word_embeddings:
            logits = hidden.float() @ self.model.embed_tokens.float().t()
            if self.model.quantized:  # row scales factor out of the product
                logits = logits * self.model.embed_scale.float().t()
            return logits
        return self.lm_head(hidden).float()

    def forward(self, inputs_embeds, positions, mask, cache=None,
                write_index=None, lens=None, compute_logits: bool = True,
                decode_bounds=None, prefix_cache=None, prefix_mask=None):
        hidden, cache = self.model(inputs_embeds, positions, mask, cache,
                                   write_index, lens, decode_bounds,
                                   prefix_cache, prefix_mask)
        logits = self.lm_logits(hidden) if compute_logits else None
        return logits, hidden, cache

    def forward_embeds(self, inputs_embeds, attention_mask=None, cache=None,
                       write_index=None, positions=None, mask=None, lens=None,
                       compute_logits: bool = True):
        """The generation entry of ``U2CausalLM.forward_embeds`` for a
        text-only model (a GREEN judge, say): a causal mask, and with
        ``attention_mask`` its padded keys masked and ``lens`` taken from
        it, when ``mask`` and ``lens`` are not given."""
        b, s, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        if mask is None:
            mask = torch.ones(s, s, dtype=torch.bool, device=dev).tril()[
                None, None]
            if attention_mask is not None:
                mask = mask & attention_mask[:, None, None, :].bool()
                if lens is None:
                    lens = attention_mask.sum(-1).to(torch.int32)
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=dev).expand(b, s)
        return self(inputs_embeds, positions, mask, cache, write_index, lens,
                    compute_logits)

    def decode_step(self, token_embeds, positions, mask, cache, write_index,
                    decode_bounds=None, prefix_cache=None, prefix_mask=None,
                    compute_logits: bool = True):
        """One decode step or verify block against the cache (and a
        case-shared ``prefix_cache``, fan-out decoding)."""
        return self(token_embeds, positions, mask, cache, write_index,
                    decode_bounds=decode_bounds, prefix_cache=prefix_cache,
                    prefix_mask=prefix_mask, compute_logits=compute_logits)
