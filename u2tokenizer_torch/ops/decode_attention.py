"""Single-token decode attention over the int8 KV cache: kernel K3.

Replaces the Pallas kernel ``_decode_kernel`` of
``u2tokenizer_tpu/ops/decode_attention.py``. The CUDA source is
``u2tokenizer_torch/csrc/decode_attention.cu``; its header says what bounds
the kernel on the H100 (bytes) and what the design does about it.

For a CUDA tensor ``decode_attention_quantized`` launches the kernel or
raises; for a CPU tensor it computes ``decode_attention_reference``, the
plain version of the same function. ``launches["decode_attention_int8"]``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .attention import gqa_sdpa_quantized

KERNEL = "decode_attention_int8"
launches = {KERNEL: 0}
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on the H100


def visible_keys(prompt_len, end, s_prompt: int, sk: int) -> torch.Tensor:
    """(B, Sk) bool: key j is visible iff j < prompt_len[b] or
    s_prompt <= j < end[b]."""
    kv = torch.arange(sk, device=prompt_len.device)
    return (kv[None, :] < prompt_len[:, None]) | (
        (kv[None, :] >= s_prompt) & (kv[None, :] < end[:, None]))


def decode_attention_reference(q, k_int, k_scale, v_int, v_scale, prompt_len,
                               end, s_prompt: int,
                               scale: Optional[float] = None):
    """Plain version: the quantized GQA attention under the two-interval
    decode mask."""
    visible = visible_keys(prompt_len, end, s_prompt, k_int.shape[2])
    return gqa_sdpa_quantized(q, k_int, k_scale, v_int, v_scale,
                              mask=visible[:, None, None, :], scale=scale)


def _entry():
    fn = getattr(_build.library("decode_attention"), KERNEL)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _decode_cuda(q, k_int, k_scale, v_int, v_scale, prompt_len, end,
                 s_prompt: int, scale: float):
    b, one, h, d = q.shape
    hkv, sk = k_int.shape[1], k_int.shape[2]
    expect = (
        (q, torch.bfloat16, (b, 1, h, d)),
        (k_int, torch.int8, (b, hkv, sk, d)),
        (v_int, torch.int8, (b, hkv, sk, d)),
        (k_scale, torch.bfloat16, (b, hkv, sk)),
        (v_scale, torch.bfloat16, (b, hkv, sk)),
        (prompt_len, torch.int32, (b,)),
        (end, torch.int32, (b,)),
    )
    for x, dtype, shape in expect:
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"decode attention: expected {dtype} {shape}, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous() or x.device != q.device:
            raise ValueError("decode attention: operands must be contiguous "
                             "and on one device")
        if x.data_ptr() % 16 and x.dim() == 4:
            raise ValueError("decode attention: data must be 16-byte aligned")
    group = h // hkv
    if d not in (64, 128) or h % hkv or group not in (1, 2, 4, 8):
        raise ValueError(f"decode attention: D={d}, H={h}, Hkv={hkv} not "
                         "supported (D in 64/128, group in 1/2/4/8)")
    smem = (group * sk + (256 // (d // 16)) * group * d) * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"decode attention: cache length {sk} needs {smem} "
                         "bytes of shared memory")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(q.data_ptr(), k_int.data_ptr(), k_scale.data_ptr(),
                   v_int.data_ptr(), v_scale.data_ptr(), prompt_len.data_ptr(),
                   end.data_ptr(), out.data_ptr(), b, h, hkv, sk, d,
                   int(s_prompt), scale, stream)
    _build.check(err, KERNEL)
    launches[KERNEL] += 1
    return out


def decode_attention_quantized(q, k_int, k_scale, v_int, v_scale,
                               prompt_len, end, s_prompt: int,
                               scale: Optional[float] = None):
    """q (B, 1, H, D); k/v (B, Hkv, S, D) int8 head-major cache; scales
    (B, Hkv, S) bf16; prompt_len, end (B,) int32 -> (B, 1, H, D)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_int, k_scale, v_int, v_scale,
                                          prompt_len, end, s_prompt, scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention: unsupported device {q.device}")
    return _decode_cuda(q, k_int, k_scale, v_int, v_scale, prompt_len, end,
                        s_prompt, scale)
