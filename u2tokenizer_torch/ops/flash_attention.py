"""Flash attention: forward kernels K1 (non-causal) and K2 (causal), and the
backward kernels K4a (row logsumexp), K4b (dq) and K4c (dk/dv).

Replaces the Pallas kernels of ``u2tokenizer_tpu/ops/flash_attention.py``:
``_kernel`` (K1), ``_kernel_causal_chunked`` (K2), ``_lse_kernel`` (K4a),
``_dq_kernel`` (K4b) and ``_dkv_kernel`` (K4c). The CUDA sources are
``u2tokenizer_torch/csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``, which
share their building blocks in ``csrc/hopper.cuh``; their headers say what
bounds each kernel on the H100 (FLOPs) and what the design does about it.
All five are wgmma kernels of one warpgroup a block: score tiles and the
O, dQ, dK and dV accumulators stay in registers (K1/K2 keep the online
softmax's running max and sum there too, K4a its running max and sum
alone), P and dS feed the next product as register operands, and the K
(K4a), K/V (K1, K2, K4b) or Q/dO (K4c) tiles arrive by TMA while the
previous one is used; the launcher builds the
TMA maps from the strides these wrappers pass, so q/k/v may stay strided
views.

``flash_attention`` takes the framework's (B, S, H, D) layout and is
differentiable. Its backward computes ``dd = rowsum(dO * O)`` and then
K4a -> K4b -> K4c, as ``_flash_bwd_raw`` does on the TPU, at every sequence
length. For CUDA tensors every step launches the hand-written kernel (bf16,
D in {64, 128}) or raises; for CPU tensors it computes the plain version of
the same function (``flash_attention_reference`` and the three
``flash_bwd_*_reference``). ``launches`` counts kernel launches by kernel
name.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
KERNELS = ("flash_fwd_noncausal", "flash_fwd_causal")
BWD_KERNELS = ("flash_bwd_lse", "flash_bwd_dq", "flash_bwd_dkv")
launches = {name: 0 for name in KERNELS + BWD_KERNELS}


def _full_lens(q, k, lens):
    if lens is None:
        return torch.full((q.shape[0],), k.shape[1], dtype=torch.int32,
                          device=q.device)
    return lens


def _masked_scores(q, k, lens, causal: bool, scale: float) -> torch.Tensor:
    """fp32 (B, Hkv, G, Sq, Sk) scaled scores; keys j >= lens[b] (and
    j > i if causal) are -1e30."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, hkv, h // hkv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    kv_idx = torch.arange(sk, device=q.device)
    mask = (kv_idx[None, :] < lens[:, None])[:, None, None, None, :]
    if causal:
        q_idx = torch.arange(sq, device=q.device)
        mask = mask & (kv_idx[None, :] <= q_idx[:, None])
    return torch.where(mask, scores, torch.full_like(scores, NEG_INF))


def flash_attention_reference(q, k, v, lens=None, *, causal: bool = False,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: q (B, Sq, H, D), k/v (B, Sk, Hkv, D), lens (B,) valid
    key counts. Scores in fp32, keys j >= lens[b] (and j > i if causal)
    masked to -1e30, probabilities cast to v's dtype before the value
    product, as the TPU kernel's reference does."""
    b, sq, h, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    lens = _full_lens(q, k, lens)
    p = torch.softmax(_masked_scores(q, k, lens, causal, scale),
                      dim=-1).to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return o.reshape(b, sq, h, d).to(q.dtype)


# --- plain versions of the backward kernels (fp32 arithmetic) ---

def flash_bwd_lse_reference(q, k, lens, *, causal: bool,
                            scale: float) -> torch.Tensor:
    """K4a: fp32 (B, H, Sq) logsumexp over keys of the masked scaled
    scores (``_lse_kernel``)."""
    b, sq, h, _ = q.shape
    lse = torch.logsumexp(_masked_scores(q, k, lens, causal, scale), dim=-1)
    return lse.reshape(b, h, sq)


def flash_bwd_probs(q, k, v, do, lse, dd, lens, *, causal: bool,
                    scale: float):
    """fp32 (P, dS), each (B, Hkv, G, Sq, Sk): P = exp(S - lse) recomputed
    from the saved logsumexp (masked keys give 0), dS = P * (dO V^T - dd)."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    p = torch.exp(_masked_scores(q, k, lens, causal, scale)
                  - lse.reshape(b, hkv, g, sq, 1))
    dog = do.float().reshape(b, sq, hkv, g, d)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    return p, p * (dp - dd.reshape(b, hkv, g, sq, 1))


def flash_bwd_dq_reference(q, k, v, do, lse, dd, lens, *, causal: bool,
                           scale: float) -> torch.Tensor:
    """K4b: dq (B, Sq, H, D) in q's dtype = sum_k dS K * scale
    (``_dq_kernel``)."""
    b, sq, h, d = q.shape
    _, ds = flash_bwd_probs(q, k, v, do, lse, dd, lens, causal=causal,
                            scale=scale)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    return dq.reshape(b, sq, h, d).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, dd, lens, *, causal: bool,
                            scale: float):
    """K4c: (dk, dv), each (B, Sk, Hkv, D) in k's dtype: dv = sum_q P^T dO,
    dk = sum_q dS^T Q * scale, summed over the GQA group's q heads
    (``_dkv_kernel``)."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    p, ds = flash_bwd_probs(q, k, v, do, lse, dd, lens, causal=causal,
                            scale=scale)
    qg = q.float().reshape(b, sq, hkv, h // hkv, d)
    dog = do.float().reshape(b, sq, hkv, h // hkv, d)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    return dk.to(k.dtype), dv.to(v.dtype)


# --- CUDA wrappers ---

def _entry(lib: str, name: str, n_ptr: int, n_int: int):
    fn = getattr(_build.library(lib), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * n_ptr + [i] * n_int
                       + [ctypes.c_float, p, p])
        fn.restype = ctypes.c_int
    return fn


def _check_operand(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: expected bfloat16, got {x.dtype}")
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3]):
        raise ValueError(f"{name}: head dim must be contiguous and the other "
                         f"strides multiples of 8, got {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _check_attention(q, k, v, lens, **others) -> None:
    """Raise unless q/k/v (and ``others``, each shaped like q) form GQA
    attention the kernels take, on one CUDA device, with int32 lens."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    for name, x in (("q", q), ("k", k), ("v", v), *others.items()):
        _check_operand(x, name)
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if d not in (64, 128):
        raise ValueError(f"head dim {d} not supported (64 or 128)")
    if k.shape != (b, sk, hkv, d) or v.shape != k.shape or h % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not form GQA attention")
    for name, x in others.items():
        if x.shape != q.shape:
            raise ValueError(f"{name} {tuple(x.shape)} is not shaped like q "
                             f"{tuple(q.shape)}")
    if (lens.dtype != torch.int32 or lens.shape != (b,)
            or lens.device != q.device or not lens.is_contiguous()):
        raise ValueError("lens must be a contiguous (B,) int32 tensor on "
                         "q's device")


def _check_stats(q, **stats) -> None:
    b, sq, h, _ = q.shape
    for name, x in stats.items():
        if (x.dtype != torch.float32 or x.shape != (b, h, sq)
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"{name} must be a contiguous fp32 (B, H, Sq) "
                             f"tensor on q's device")


def _strides(*tensors):
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *(s for x in tensors for s in x.stride()[:3]))


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _flash_cuda(q, k, v, lens, causal: bool, scale: float) -> torch.Tensor:
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    _check_attention(q, k, v, lens)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = _strides(q, k, v, out)
    name = KERNELS[int(causal)]
    err = _entry("flash_fwd", name, 5, 6)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), b, h, hkv, sq, sk, d, scale,
        ctypes.addressof(strides), _stream(q))
    _build.check(err, name)
    launches[name] += 1
    return out


def flash_bwd_lse(q, k, lens, *, causal: bool, scale: float) -> torch.Tensor:
    """K4a on the GPU: fp32 (B, H, Sq) row logsumexp."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    _check_attention(q, k, k, lens)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = _strides(q, k)
    err = _entry("flash_bwd", "flash_bwd_lse", 4, 7)(
        q.data_ptr(), k.data_ptr(), lens.data_ptr(), lse.data_ptr(), b, h,
        hkv, sq, sk, d, int(causal), scale, ctypes.addressof(strides),
        _stream(q))
    _build.check(err, "flash_bwd_lse")
    launches["flash_bwd_lse"] += 1
    return lse


def flash_bwd_dq(q, k, v, do, lse, dd, lens, *, causal: bool,
                 scale: float) -> torch.Tensor:
    """K4b on the GPU: dq (B, Sq, H, D) bf16."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    _check_attention(q, k, v, lens, do=do)
    _check_stats(q, lse=lse, dd=dd)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = _strides(q, k, v, do, dq)
    err = _entry("flash_bwd", "flash_bwd_dq", 8, 7)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dd.data_ptr(), lens.data_ptr(), dq.data_ptr(), b, h,
        hkv, sq, sk, d, int(causal), scale, ctypes.addressof(strides),
        _stream(q))
    _build.check(err, "flash_bwd_dq")
    launches["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, dd, lens, *, causal: bool,
                  scale: float):
    """K4c on the GPU: (dk, dv), each (B, Sk, Hkv, D) bf16."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    _check_attention(q, k, v, lens, do=do)
    _check_stats(q, lse=lse, dd=dd)
    dk = torch.empty((b, sk, hkv, d), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    strides = _strides(q, k, v, do, dk, dv)
    err = _entry("flash_bwd", "flash_bwd_dkv", 9, 7)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dd.data_ptr(), lens.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, h, hkv, sq, sk, d, int(causal), scale,
        ctypes.addressof(strides), _stream(q))
    _build.check(err, "flash_bwd_dkv")
    launches["flash_bwd_dkv"] += 1
    return dk, dv


def flash_attention_backward(q, k, v, lens, out, do, *, causal: bool,
                             scale: float):
    """(dq, dk, dv) of ``flash_attention`` for the output gradient ``do``:
    dd = rowsum(dO * O) in fp32, then K4a -> K4b -> K4c (their plain
    versions for CPU tensors)."""
    dd = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    if q.device.type == "cpu":
        lse = flash_bwd_lse_reference(q, k, lens, causal=causal, scale=scale)
        dq = flash_bwd_dq_reference(q, k, v, do, lse, dd, lens,
                                    causal=causal, scale=scale)
        dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, dd, lens,
                                         causal=causal, scale=scale)
        return dq, dk, dv
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    do = do.contiguous()
    lse = flash_bwd_lse(q, k, lens, causal=causal, scale=scale)
    dq = flash_bwd_dq(q, k, v, do, lse, dd, lens, causal=causal, scale=scale)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, dd, lens, causal=causal,
                           scale=scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward K1/K2, backward K4a-c; saves q, k, v, lens and the output."""

    @staticmethod
    def forward(ctx, q, k, v, lens, causal: bool, scale: float):
        if q.device.type == "cpu":
            out = flash_attention_reference(q, k, v, lens, causal=causal,
                                            scale=scale)
        elif q.device.type == "cuda":
            out = _flash_cuda(q, k, v, lens, causal, scale)
        else:
            raise ValueError(f"flash_attention: unsupported device "
                             f"{q.device}")
        ctx.save_for_backward(q, k, v, lens, out)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lens, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, lens, out, do,
                                              causal=ctx.causal,
                                              scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, lens=None, *, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, Hkv, D), lens (B,) int32 valid key
    counts (all keys when None) -> (B, Sq, H, D). Non-causal runs K1,
    causal runs K2; the gradient runs K4a-c. Rows past a row's ``lens``
    attend its valid keys."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _FlashAttention.apply(q, k, v, _full_lens(q, k, lens), causal,
                                 scale)
