"""Single-token decode attention over the quantized KV cache: kernel K3.

Replaces the Pallas kernel ``_decode_kernel`` of
``u2tokenizer_tpu/ops/decode_attention.py``, which serves the int8 and the
int4 cache alike. The CUDA source
``u2tokenizer_torch/csrc/decode_attention.cu`` has one template over the
element width and two entries, ``decode_attention_int8`` for the int8
cache (B, Hkv, S, D) and ``decode_attention_int4`` for the packed int4
cache (B, Hkv, S, D/2) (``attention.pack_nibbles``: low nibble = even d);
its header says what bounds the kernel on the H100 (bytes) and what the
design does about it: each (row, kv head) is split over its visible cache
rows into ``split_count`` blocks of one launch, which merge their partial
softmaxes through a workspace (``_workspace``, allocated once per device).

For a CUDA tensor ``decode_attention_quantized`` launches the entry that
the cache's last dimension names, or raises; for a CPU tensor it computes
``decode_attention_reference``, the plain version of the same function.
``launches[name]`` counts each entry's launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .attention import _scalar, unpack_nibbles

KERNELS = {8: "decode_attention_int8", 4: "decode_attention_int4"}
launches = {name: 0 for name in KERNELS.values()}
# head dims csrc/decode_attention.cu instantiates (80: Phi-2, 96: Phi-3)
HEAD_DIMS = (64, 80, 96, 128)
# n_split: about TARGET_BLOCKS_PER_SM blocks of 128 threads an SM, at
# least MIN_SPLIT_ROWS cache slots a split, and at most MAX_SPLIT (the
# kernel's merge keeps a weight per split in shared memory). On the H100
# (PERF.md, PR 6) the serving paths' calls read fastest near these: B=4
# at 8 splits, B=1 at 12-16, B=112 unsplit.
TARGET_BLOCKS_PER_SM, MIN_SPLIT_ROWS, MAX_SPLIT, H100_SMS = 2, 128, 64, 132
# a (row, kv head) with fewer visible rows is taken by one block in the
# plain version's order of rounding (csrc/decode_attention.cu's EXACT_ROWS)
EXACT_ROWS = 512


def split_count(b: int, hkv: int, sk: int, sms: int = H100_SMS) -> int:
    """How many blocks split each (row, kv head) of a launch, from static
    shapes only (no read of prompt_len or end): enough blocks for
    ``TARGET_BLOCKS_PER_SM`` an SM, at most one per ``MIN_SPLIT_ROWS``
    slots of the cache, and at most ``MAX_SPLIT``."""
    want = -(-TARGET_BLOCKS_PER_SM * sms // (b * hkv))
    return max(1, min(want, sk // MIN_SPLIT_ROWS, MAX_SPLIT))


def visible_keys(prompt_len, end, s_prompt: int, sk: int) -> torch.Tensor:
    """(B, Sk) bool: key j is visible iff j < prompt_len[b] or
    s_prompt <= j < end[b]."""
    kv = torch.arange(sk, device=prompt_len.device)
    return (kv[None, :] < prompt_len[:, None]) | (
        (kv[None, :] >= s_prompt) & (kv[None, :] < end[:, None]))


def decode_attention_reference(q, k_int, k_scale, v_int, v_scale, prompt_len,
                               end, s_prompt: int,
                               scale: Optional[float] = None):
    """Plain version, over the int8 or the packed int4 cache, in the
    kernel's (and the TPU kernel's) order of rounding: q times the scale in
    q's dtype, scores in fp32 with the k-scale folded in, the softmax over
    the visible keys in fp32, the probabilities times the v-scale rounded
    to q's dtype, the value sum in fp32, the output in q's dtype."""
    b, _, h, d = q.shape
    if scale is None:
        scale = 1.0 / d ** 0.5
    if k_int.shape[-1] != d:
        k_int, v_int = unpack_nibbles(k_int), unpack_nibbles(v_int)
    hkv, sk = k_int.shape[1], k_int.shape[2]
    qs = (q * _scalar(scale, q.dtype)).float().reshape(b, hkv, h // hkv, d)
    scores = torch.einsum("bhgd,bhkd->bhgk", qs, k_int.float())
    scores = scores * k_scale.float()[:, :, None, :]
    visible = visible_keys(prompt_len, end, s_prompt, sk)
    scores = scores.masked_fill(~visible[:, None, None, :], -math.inf)
    p = torch.softmax(scores, dim=-1) * v_scale.float()[:, :, None, :]
    out = torch.einsum("bhgk,bhkd->bhgd", p.to(q.dtype).float(),
                       v_int.float())
    return out.to(q.dtype).reshape(b, 1, h, d)


def _entry(name: str):
    fn = getattr(_build.library("decode_attention"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 7 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def check_operands(q, k_int, k_scale, v_int, v_scale, prompt_len,
                   end) -> str:
    """What the kernel takes, checked before a launch: returns the entry's
    name (``KERNELS``), or raises on a dtype, shape, layout or size it does
    not take."""
    b, one, h, d = q.shape
    hkv, sk, row = k_int.shape[1:]
    if row not in (d, d // 2):
        raise ValueError(f"decode attention: a cache row of {row} bytes is "
                         f"neither int8 nor packed int4 at D={d}")
    bits = 8 * row // d
    expect = (
        (q, torch.bfloat16, (b, 1, h, d)),
        (k_int, torch.int8, (b, hkv, sk, row)),
        (v_int, torch.int8, (b, hkv, sk, row)),
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
    if d not in HEAD_DIMS or h % hkv or group not in (1, 2, 4, 8):
        raise ValueError(f"decode attention: D={d}, H={h}, Hkv={hkv} not "
                         f"supported (D in {HEAD_DIMS}, group in 1/2/4/8)")
    return KERNELS[bits]


_workspaces = {}


def _workspace(device, n_floats: int, n_counters: int):
    """The device's fp32 workspace of at least ``n_floats`` and its int32
    split counters (zero, and left zero by every launch) of at least
    ``n_counters``: allocated at first use and grown, never per call."""
    ws, counters = _workspaces.get(device, (None, None))
    if ws is None or ws.numel() < n_floats:
        ws = torch.empty(max(n_floats, 1), dtype=torch.float32, device=device)
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(n_counters, dtype=torch.int32, device=device)
    _workspaces[device] = (ws, counters)
    return ws, counters


_sms = {}


def sm_count(device) -> int:
    """The SMs of a CUDA device (``split_count``'s ``sms``)."""
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device]


def _decode_cuda(q, k_int, k_scale, v_int, v_scale, prompt_len, end,
                 s_prompt: int, scale: float):
    name = check_operands(q, k_int, k_scale, v_int, v_scale, prompt_len, end)
    b, _, h, d = q.shape
    hkv, sk = k_int.shape[1], k_int.shape[2]
    n_split = split_count(b, hkv, sk, sm_count(q.device))
    ws, counters = _workspace(q.device, b * h * n_split * (d + 2), b * hkv)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry(name)(q.data_ptr(), k_int.data_ptr(), k_scale.data_ptr(),
                   v_int.data_ptr(), v_scale.data_ptr(), prompt_len.data_ptr(),
                   end.data_ptr(), out.data_ptr(), ws.data_ptr(),
                   counters.data_ptr(), b, h, hkv, sk, d, int(s_prompt),
                   n_split, scale, stream)
    _build.check(err, name)
    launches[name] += 1
    return out


def decode_attention_quantized(q, k_int, k_scale, v_int, v_scale,
                               prompt_len, end, s_prompt: int,
                               scale: Optional[float] = None):
    """q (B, 1, H, D); k/v the head-major cache, (B, Hkv, S, D) int8 or
    (B, Hkv, S, D/2) packed int4; scales (B, Hkv, S) bf16; prompt_len,
    end (B,) int32 -> (B, 1, H, D)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_int, k_scale, v_int, v_scale,
                                          prompt_len, end, s_prompt, scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention: unsupported device {q.device}")
    return _decode_cuda(q, k_int, k_scale, v_int, v_scale, prompt_len, end,
                        s_prompt, scale)
