"""Decoder-only LM stack (counterpart of
``u2tokenizer_tpu/models/llm/decoder.py``), Qwen3/Llama family: RMSNorm,
GQA attention with RoPE and optional per-head q/k RMSNorm, SwiGLU MLP,
tied or separate fp32 LM head. Weights are float (bf16 for serving);
weight-only int8/int4 and the Phi-2 switches are not ported yet.

Attention routing mirrors the JAX package's:
  * a prefill (S > 1, ``lens`` given, attending its own fresh K/V) goes to
    ``flash_attention(causal=True)``, kernel K2 on the GPU;
  * a single-token decode over the int8 cache with ``decode_bounds`` goes to
    ``decode_attention_quantized``, kernel K3 on the GPU;
  * anything else runs the plain masked attention of ``ops.attention``.

The KV cache is updated in place (the JAX package returns a new one); the
functions still return it so the call sites read like their counterparts.

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
from ...ops.attention import (gqa_sdpa, gqa_sdpa_headmajor,
                              gqa_sdpa_quantized, quantize_kv)
from ...ops.decode_attention import decode_attention_quantized
from ...ops.flash_attention import flash_attention
from ...ops.rotary import apply_rope, rope_cos_sin
from ..layers import Dense

QDense = Dense  # float weights only in this port (see module docstring)


@dataclass
class KVCache:
    """Per-layer head-major buffers: k/v (B, Hkv, max_len, D), each head's
    keys contiguous. With ``dtype="int8"`` values are stored quantized with
    per-(position, head) bf16 scales in (B, Hkv, max_len) buffers."""

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
        if dtype in ("int8", torch.int8):
            sshape = (batch, cfg.num_kv_heads, max_len)
            return cls(k=zeros(shape, torch.int8), v=zeros(shape, torch.int8),
                       k_scale=zeros(sshape, torch.bfloat16),
                       v_scale=zeros(sshape, torch.bfloat16))
        if dtype == "int4":
            raise NotImplementedError("the int4 KV cache is not ported yet")
        return cls(k=zeros(shape, dtype), v=zeros(shape, dtype))

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2]


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


def _check_supported(cfg: LLMConfig) -> None:
    unsupported = {
        "quantized_weights": cfg.quantized_weights, "lora_rank": cfg.lora_rank,
        "parallel_block": cfg.parallel_block,
        "norm_type": cfg.norm_type != "rmsnorm",
        "mlp_type": cfg.mlp_type != "swiglu",
        "partial_rotary_factor": cfg.partial_rotary_factor != 1.0,
    }
    bad = [name for name, on in unsupported.items() if on]
    if bad:
        raise NotImplementedError(f"LLMConfig options not ported yet: {bad}")


class Attention(nn.Module):
    def __init__(self, cfg: LLMConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        hd, e = cfg.head_dim, cfg.hidden_size
        bias = cfg.attention_bias
        self.q_proj = QDense(e, cfg.num_heads * hd, bias, dtype, device)
        self.k_proj = QDense(e, cfg.num_kv_heads * hd, bias, dtype, device)
        self.v_proj = QDense(e, cfg.num_kv_heads * hd, bias, dtype, device)
        self.o_proj = QDense(cfg.num_heads * hd, e, bias, dtype, device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, cfg.rms_norm_eps, dtype, device)
            self.k_norm = RMSNorm(hd, cfg.rms_norm_eps, dtype, device)

    def forward(self, x, rope, mask, cache_kv=None,
                write_index: Optional[int] = None, lens=None,
                decode_bounds=None):
        """x (B, S, E); rope the (cos, sin) tables of the positions, each
        (B, S, D); mask bool (B, 1, S, Sk); cache_kv
        (k, v, k_scale, v_scale) head-major buffers written in place at
        ``write_index``; lens (B,) right-pad valid lengths; decode_bounds
        (prompt_len (B,), end (B,), s_prompt int)."""
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
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        quantized_decode = cached_decode = False
        k_att, v_att = k, v
        if cache_kv is not None:
            ck, cv, ks, vs = cache_kv
            w = write_index
            if ks is not None:  # int8 cache: quantize on write
                k_q, k_s = quantize_kv(k)
                v_q, v_s = quantize_kv(v)
                ck[:, :, w:w + s] = k_q.transpose(1, 2)
                cv[:, :, w:w + s] = v_q.transpose(1, 2)
                ks[:, :, w:w + s] = k_s[..., 0].transpose(1, 2)
                vs[:, :, w:w + s] = v_s[..., 0].transpose(1, 2)
                quantized_decode = s == 1
            else:
                ck[:, :, w:w + s] = k.transpose(1, 2).to(ck.dtype)
                cv[:, :, w:w + s] = v.transpose(1, 2).to(cv.dtype)
            if s == 1:
                # single-token decode: attend the whole cache under the mask.
                # A prefill (written at offset 0) attends its fresh k/v,
                # exact even with a quantized cache.
                k_att, v_att = ck, cv
                cached_decode = True

        use_flash = (cfg.use_flash_attention and lens is not None and s > 1
                     and k_att.shape[1] == s)
        if quantized_decode:
            if decode_bounds is not None and cfg.use_flash_attention:
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


class MLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, cfg: LLMConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        e, m = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = QDense(e, m, False, dtype, device)
        self.up_proj = QDense(e, m, False, dtype, device)
        self.down_proj = QDense(m, e, False, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LLMConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       dtype, device)
        self.self_attn = Attention(cfg, dtype, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, dtype, device)
        self.mlp = MLP(cfg, dtype, device)

    def forward(self, x, rope, mask, cache_kv=None, write_index=None,
                lens=None, decode_bounds=None):
        attn_out, cache_kv = self.self_attn(
            self.input_layernorm(x), rope, mask, cache_kv, write_index,
            lens, decode_bounds)
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
    """Embedding table + decoder layers + final norm."""

    def __init__(self, cfg: LLMConfig, dtype=torch.bfloat16, device=None,
                 remat=False):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat_enabled(remat)
        self.embed_tokens = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.hidden_size, device=device))
        self.layers = nn.ModuleList(DecoderLayer(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embed_tokens.normal_(0.0, 0.02, generator=generator)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(input_ids, self.embed_tokens).to(self.dtype)

    def forward(self, inputs_embeds, positions, mask, cache=None,
                write_index=None, lens=None, decode_bounds=None):
        cfg = self.cfg
        x = inputs_embeds.to(self.dtype)
        # one rotary table for all layers
        scaling = (cfg.rope_scaling_type, cfg.rope_scaling_factor,
                   cfg.rope_low_freq_factor, cfg.rope_high_freq_factor,
                   cfg.rope_original_max_position)
        rope = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            scaling=scaling)
        for i, layer in enumerate(self.layers):
            cache_kv = None
            if cache is not None:
                cache_kv = (cache.k[i], cache.v[i],
                            cache.k_scale[i] if cache.quantized else None,
                            cache.v_scale[i] if cache.quantized else None)
            args = (x, rope, mask, cache_kv, write_index, lens, decode_bounds)
            if self.remat and torch.is_grad_enabled():
                x, _ = checkpoint(layer, *args, use_reentrant=False)
            else:
                x, _ = layer(*args)
        return self.norm(x), cache


class CausalLM(nn.Module):
    """DecoderModel + LM head (tied to the embedding table or separate)."""

    def __init__(self, cfg: LLMConfig, dtype=torch.bfloat16, device=None,
                 remat=False):
        super().__init__()
        self.cfg = cfg
        self.model = DecoderModel(cfg, dtype, device, remat)
        if not cfg.tie_word_embeddings:
            self.lm_head = QDense(cfg.hidden_size, cfg.vocab_size,
                                  cfg.lm_head_bias, dtype, device)

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.model.embed(input_ids)

    def lm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Hidden states -> fp32 vocabulary logits."""
        if self.cfg.tie_word_embeddings:
            return hidden.float() @ self.model.embed_tokens.float().t()
        return self.lm_head(hidden).float()

    def forward(self, inputs_embeds, positions, mask, cache=None,
                write_index=None, lens=None, compute_logits: bool = True,
                decode_bounds=None):
        hidden, cache = self.model(inputs_embeds, positions, mask, cache,
                                   write_index, lens, decode_bounds)
        logits = self.lm_logits(hidden) if compute_logits else None
        return logits, hidden, cache
