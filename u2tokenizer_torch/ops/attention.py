"""Plain attention ops.

The JAX package computes these in XLA, outside any Pallas kernel, so the
port keeps them as plain PyTorch. The hot attention shapes go to the
hand-written kernels in ``flash_attention.py`` and ``decode_attention.py``.
Layouts follow the JAX package: activations (B, S, H, D), KV cache
head-major (B, Hkv, S, D).
"""

from __future__ import annotations

from typing import Optional

import torch


def _neg(dtype) -> float:
    return torch.finfo(dtype).min


def _scalar(x: float, dtype) -> float:
    """``x`` rounded to ``dtype``, as ``jnp.asarray(x, dtype)`` is before it
    scales the scores."""
    return float(torch.tensor(x, dtype=dtype))


def sdpa(q, k, v, *, bias=None, mask=None, scale: Optional[float] = None,
         softmax_in_fp32: bool = True) -> torch.Tensor:
    """q (B, Sq, H, D), k (B, Sk, H, D), v (B, Sk, H, Dv) -> (B, Sq, H, Dv).
    ``bias`` is additive and ``mask`` boolean (False = masked), both
    broadcastable to (B, H, Sq, Sk)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * _scalar(scale, q.dtype)
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    if mask is not None:
        scores = scores.masked_fill(~mask, _neg(scores.dtype))
    if softmax_in_fp32:
        probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    else:
        probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def gqa_sdpa(q, k, v, *, mask=None, scale: Optional[float] = None):
    """Grouped-query attention: q (B, Sq, H, D), k/v (B, Sk, Hkv, D)."""
    b, sq, h, d = q.shape
    hkv, sk = k.shape[2], k.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    group = h // hkv
    qg = q.reshape(b, sq, hkv, group, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * _scalar(scale, q.dtype)
    if mask is not None:
        m = mask.expand(b, h, sq, sk).reshape(b, hkv, group, sq, sk)
        scores = scores.masked_fill(~m, _neg(scores.dtype))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, h, d)


def gqa_sdpa_headmajor(q, k, v, *, mask=None, scale: Optional[float] = None):
    """GQA attention with head-major K/V (B, Hkv, Sk, D), the cache layout."""
    b, sq, h, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    group = h // hkv
    qg = q.reshape(b, sq, hkv, group, d)
    scores = torch.einsum("bqhgd,bhkd->bhgqk", qg, k) * _scalar(scale, q.dtype)
    if mask is not None:
        m = mask.expand(b, h, sq, sk).reshape(b, hkv, group, sq, sk)
        scores = scores.masked_fill(~m, _neg(scores.dtype))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bhkd->bqhgd", probs, v)
    return out.reshape(b, sq, h, d)


def relative_position_bias(table: torch.Tensor, seq_len: int,
                           max_seq_len: int) -> torch.Tensor:
    """Learned relative-position bias: ``table`` (2*max_seq_len - 1, H);
    entry (i, j) is table[j - i + max_seq_len - 1]. Returns (1, H, S, S).
    Raises when ``seq_len`` exceeds ``max_seq_len``: the table holds no
    offset past it (the JAX package's lookup fills those entries with
    NaN)."""
    if seq_len > max_seq_len:
        raise ValueError(
            f"relative position bias over {seq_len} positions: the table "
            f"holds offsets for at most max_seq_len = {max_seq_len}; use "
            "attn_type 'rope' or 'vanilla' for longer sequences")
    pos = torch.arange(seq_len, device=table.device)
    rel = pos[None, :] - pos[:, None] + (max_seq_len - 1)
    return table[rel].permute(2, 0, 1)[None]


def quantize_kv(x: torch.Tensor, eps: float = 1e-6, dtype="int8"):
    """Per-(position, head) symmetric quantization of K/V rows.

    x: (B, S, H, D) -> (int8 values, (B, S, H, 1) bf16 scales), in ``x``'s
    dtype until the cast, round half to even (``torch.round``), like
    ``jnp.round``. ``dtype`` "int8" (or ``torch.int8``) takes 127 levels,
    "int4" 7; the int4 values come back one to an int8 and are packed for
    the cache by ``pack_nibbles``."""
    levels = 7.0 if dtype == "int4" else 127.0
    scale = x.abs().amax(dim=-1, keepdim=True) / levels
    scale = torch.clamp(scale, min=eps)
    q = torch.clamp(torch.round(x / scale), -levels, levels).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def pack_nibbles(q: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Pack int4 values (any integer dtype, in [-8, 7]) pairwise along
    ``dim`` into int8 bytes, the low nibble the even index: size n -> n/2.

    This is the port's int4 storage, since torch has no int4 dtype. The
    int4 KV cache holds k/v as (B, Hkv, S, D/2) int8 packed along D; the
    int4 weights hold (ng, g/2, out) packed along the group axis, the
    layout of the JAX package's ``pack_int4``."""
    q = q.to(torch.int8).movedim(dim, -1)
    packed = (q[..., 0::2] & 0x0F) | (q[..., 1::2] << 4)
    return packed.movedim(-1, dim).contiguous()


def unpack_nibbles(packed: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inverse of ``pack_nibbles``: int8 bytes -> int8 values in [-8, 7],
    each nibble sign-extended, size n -> 2n along ``dim``."""
    d = dim % packed.dim()
    lo = ((packed & 0x0F) ^ 8) - 8  # the low nibble, sign-extended
    hi = packed >> 4                 # an arithmetic shift sign-extends
    return torch.stack([lo, hi], dim=d + 1).flatten(d, d + 1)


def gqa_sdpa_quantized(q, k_int, k_scale, v_int, v_scale, *, mask=None,
                       scale: Optional[float] = None):
    """GQA attention over the quantized head-major cache: k/v (B, Hkv, Sk, D)
    int8, or (B, Hkv, Sk, D/2) packed int4 (``pack_nibbles``, unpacked
    here first), with (B, Hkv, Sk) scales. k-scales fold into the scores
    and v-scales into the probabilities."""
    b, sq, h, d = q.shape
    if k_int.shape[-1] != d:
        k_int, v_int = unpack_nibbles(k_int), unpack_nibbles(v_int)
    hkv, sk = k_int.shape[1], k_int.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    group = h // hkv
    qg = q.reshape(b, sq, hkv, group, d)
    scores = torch.einsum("bqhgd,bhkd->bhgqk", qg,
                          k_int.to(q.dtype)) * _scalar(scale, q.dtype)
    scores = scores * k_scale.to(q.dtype)[:, :, None, None, :]
    if mask is not None:
        m = mask.expand(b, h, sq, sk).reshape(b, hkv, group, sq, sk)
        scores = scores.masked_fill(~m, _neg(scores.dtype))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    probs = probs * v_scale.to(q.dtype)[:, :, None, None, :]
    out = torch.einsum("bhgqk,bhkd->bqhgd", probs, v_int.to(q.dtype))
    return out.reshape(b, sq, h, d)


def gqa_sdpa_fanout(q, pk, pv, sk, sv, *, pk_scale=None, pv_scale=None,
                    sk_scale=None, sv_scale=None, prefix_mask=None,
                    suffix_mask=None, scale: Optional[float] = None):
    """GQA attention over a prefix cache shared by groups of rows plus a
    per-row suffix cache, with one softmax over both: q (B, Sq, H, D) with
    B = C * n, row c*n + j of case c; pk/pv (C, Hkv, Sp, D) the prefix,
    sk/sv (B, Hkv, St, D) the suffix, head-major. Either cache may be
    int8, or packed int4 (``pack_nibbles``), with (C or B, Hkv, S) scales
    that fold into the scores and probabilities as in
    ``gqa_sdpa_quantized``. prefix_mask (C, Sp) marks valid prefix keys;
    suffix_mask broadcasts to (B, H, Sq, St). Equal to attending the
    concatenated [prefix ; suffix] cache, with the prefix read once a
    case (the JAX package's ``gqa_sdpa_fanout``)."""
    b, sq, h, d = q.shape
    if pk.shape[-1] != d:
        pk, pv = unpack_nibbles(pk), unpack_nibbles(pv)
    if sk.shape[-1] != d:
        sk, sv = unpack_nibbles(sk), unpack_nibbles(sv)
    c, hkv, sp = pk.shape[0], pk.shape[1], pk.shape[2]
    st = sk.shape[2]
    n = b // c
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    group = h // hkv
    neg = _neg(torch.float32)
    sc = _scalar(scale, q.dtype)

    qg = q.reshape(c, n, sq, hkv, group, d)
    ps = torch.einsum("cnqhgd,chkd->cnhgqk", qg, pk.to(q.dtype)) * sc
    if pk_scale is not None:
        ps = ps * pk_scale.to(q.dtype)[:, None, :, None, None, :]
    ps = ps.float()
    if prefix_mask is not None:
        ps = ps.masked_fill(~prefix_mask[:, None, None, None, None, :], neg)
    ps = ps.reshape(b, hkv, group, sq, sp)

    qs = q.reshape(b, sq, hkv, group, d)
    ss = torch.einsum("bqhgd,bhkd->bhgqk", qs, sk.to(q.dtype)) * sc
    if sk_scale is not None:
        ss = ss * sk_scale.to(q.dtype)[:, :, None, None, :]
    ss = ss.float()
    if suffix_mask is not None:
        m = suffix_mask.expand(b, h, sq, st).reshape(b, hkv, group, sq, st)
        ss = ss.masked_fill(~m, neg)

    probs = torch.softmax(torch.cat([ps, ss], dim=-1), dim=-1).to(q.dtype)
    pp, sp_probs = probs[..., :sp], probs[..., sp:]
    ppg = pp.reshape(c, n, hkv, group, sq, sp)
    if pv_scale is not None:
        ppg = ppg * pv_scale.to(q.dtype)[:, None, :, None, None, :]
    out_p = torch.einsum("cnhgqk,chkd->cnqhgd", ppg, pv.to(q.dtype))
    if sv_scale is not None:
        sp_probs = sp_probs * sv_scale.to(q.dtype)[:, :, None, None, :]
    out_s = torch.einsum("bhgqk,bhkd->bqhgd", sp_probs, sv.to(q.dtype))
    return out_p.reshape(b, sq, h, d) + out_s.reshape(b, sq, h, d)
