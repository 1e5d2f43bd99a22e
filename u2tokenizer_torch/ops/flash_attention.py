"""Flash-attention forward: kernels K1 (non-causal) and K2 (causal).

Replaces the Pallas kernels ``_kernel`` (K1) and ``_kernel_causal_chunked``
(K2) of ``u2tokenizer_tpu/ops/flash_attention.py``. The CUDA source is
``u2tokenizer_torch/csrc/flash_fwd.cu``; its header says what bounds each
kernel on the H100 (FLOPs) and what the design does about it.

``flash_attention`` takes the framework's (B, S, H, D) layout. For a CUDA
tensor it launches the hand-written kernel (bf16, D in {64, 128}) or
raises; for a CPU tensor it computes ``flash_attention_reference``, the
plain version of the same function. ``launches`` counts kernel launches:
``launches["flash_fwd_noncausal"]`` for K1, ``["flash_fwd_causal"]`` for K2.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
KERNELS = ("flash_fwd_noncausal", "flash_fwd_causal")
launches = {name: 0 for name in KERNELS}


def flash_attention_reference(q, k, v, lens=None, *, causal: bool = False,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: q (B, Sq, H, D), k/v (B, Sk, Hkv, D), lens (B,) valid
    key counts. Scores in fp32, keys j >= lens[b] (and j > i if causal)
    masked to -1e30, probabilities cast to v's dtype before the value
    product, as the TPU kernel's reference does."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if lens is None:
        lens = torch.full((b,), sk, dtype=torch.int32, device=q.device)
    group = h // hkv
    qg = q.float().reshape(b, sq, hkv, group, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    kv_idx = torch.arange(sk, device=q.device)
    mask = (kv_idx[None, :] < lens[:, None])[:, None, None, None, :]
    if causal:
        q_idx = torch.arange(sq, device=q.device)
        mask = mask & (kv_idx[None, :] <= q_idx[:, None])
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return o.reshape(b, sq, h, d).to(q.dtype)


def _entry(name: str):
    fn = getattr(_build.library("flash_fwd"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p, p]
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


def _flash_cuda(q, k, v, lens, causal: bool, scale: float) -> torch.Tensor:
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_operand(x, name)
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if d not in (64, 128):
        raise ValueError(f"head dim {d} not supported (64 or 128)")
    if k.shape != (b, sk, hkv, d) or v.shape != k.shape or h % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not form GQA attention")
    if lens is None:
        lens = torch.full((b,), sk, dtype=torch.int32, device=q.device)
    if (lens.dtype != torch.int32 or lens.shape != (b,)
            or lens.device != q.device or not lens.is_contiguous()):
        raise ValueError("lens must be a contiguous (B,) int32 tensor on "
                         "q's device")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    name = KERNELS[int(causal)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry(name)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       lens.data_ptr(), out.data_ptr(), b, h, hkv, sq, sk, d,
                       scale, ctypes.addressof(strides), stream)
    _build.check(err, name)
    launches[name] += 1
    return out


def flash_attention(q, k, v, lens=None, *, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, Hkv, D), lens (B,) int32 valid key
    counts (all keys when None) -> (B, Sq, H, D). Non-causal runs K1,
    causal runs K2. Rows past a row's ``lens`` attend its valid keys."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, lens, causal=causal,
                                         scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _flash_cuda(q, k, v, lens, causal, scale)
