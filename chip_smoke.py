#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--max-new N] [--kernels-only]

Run from the root of a checkout. It

  1. prints the card's name and power limit (nvidia-smi) and builds the
     hand-written kernels from ``u2tokenizer_torch/csrc`` with nvcc;
  2. checks each kernel against its plain PyTorch version on the card at
     the shapes the serving and training paths give it, with ragged lengths
     in one row, shows that the same limits reject a mask off by one key
     (and, for K3's int4 form, nibbles swapped or read unsigned), and times
     the kernel, the plain version and, where one PyTorch call computes the
     same function, that call (CUDA events, median of 7), with the
     kernel's own device time beside (torch.profiler, ``device_ms``) and a
     bound that counts FLOPs, bytes and exponentials (``bound_ms``); K3 at
     steps 0, 383 and 767 of both serving paths, with a 3-token prompt in
     the batch and at B=1, each also called twice for the same bits, with
     a ``decode_calls`` line of its split counts and times; the flash
     forward K1/K2 and backward K4a-c at every call the paths make (K1
     and K2 also at the quantized path's ViT group of 128 chunks and its
     112-row prefill, held there on the batch's last 8 rows) and at two
     small shapes on the edges of their 64-row tiles (untimed), with one
     line for K1/K2 and one for K4a-c that set the kernels beside their
     bound and SDPA at each call (the backward as K4b + K4c and as the
     whole K4a + K4b + K4c against SDPA's whole backward); K2 also at the
     μ²Llama-3.2-1B prefill (D=64, GQA group 4, timed) and the Qwen3-8B
     one (D=128, group 4), K3 at both presets' heads and K4a-c at the
     μ²Llama SFT call (D=64, causal, group 4), these untimed;
  3. drives the serving path twice, each time full-width μ²Qwen3-1.7B with
     random weights from a fixed seed cast to bf16, CT volumes of
     (8, 32, 256, 256), a 1024-token prompt (the last row 900), 64 question
     tokens and a greedy decode: first bf16 weights, the int8 KV cache, 4
     volumes and 256 tokens (``--max-new``); then, 768 tokens, the
     configuration of the JAX package's
     ``bench.py``: decoder weights quantized to int8, the int4 KV cache,
     112 volumes, the ViT over groups of 128 chunks. Each asserts the
     output and that every kernel ran on its path the expected number of
     times, then profiles 8 decode steps (torch.profiler: the card's busy
     share, kernels per step);
  4. drives the report path of the released μ²Llama-3.2-1B configuration
     (DiffTS, DMTP, D=64, GQA group 4) at full width and depth: a seeded
     512x512x300 int16 CT written as .nii and ingested by
     ``U2VolumeTransform`` on the card (held to the CPU's), random weights
     from seed 0 written by ``save_hf_checkpoint`` and loaded back by
     ``U2InferenceModel``, one greedy report of 256 tokens through
     ``inference`` (K1 12 and K2 16 launches), its tokens bit for bit
     those of ``make_multimodal_generate_fn`` on the exported in-memory
     model (timed by stage), two sampled reports (top-p 0.9) of one seed
     from two instances, and ``nucleus_sample`` over the 128,256-entry
     vocabulary against the exact nucleus by chi-square;
  5. drives speculative decoding (``drive_speculative``): the default
     sampled report of ``U2InferenceModel`` (no ``do_sample`` or
     ``speculative``: top-p 0.9 through the speculative loop) on the same
     checkpoint with its launches (K1 12, K2 16), a second instance of the
     seed by stage (the same text, ms a verify step) and the
     ``speculative=False`` report beside it; greedy speculative against
     the report phase's plain greedy tokens under a near-tie rule
     (``TIE_ULPS``) that must reject a planted fault of the verify block;
     fan-out, one case x 8 sampled samples of 256 tokens, speculative and
     plain, with every K2 call at the case batch; and ``bench.py``'s forced-content
     speculative configuration (μ²Qwen3-1.7B, int8 weights, int4 cache,
     B=112, scripts of ``report_token_scripts(112, 776, vocab, seed=7)``):
     the script emitted exactly, the verify steps equal to the host replay
     of the loop's drafting, reports/min beside the plain quantized run's;
  6. drives serving (``drive_serving``) on the same checkpoint and CT:
     ``python -m u2tokenizer_torch.cli serve --slots 8`` as a process that
     must answer /health and one report; twelve questions one at a time
     through the single-request model ``cli serve`` builds (the reference
     tokens, and the sequential reports/min); the server ``cli serve
     --slots 8 --max-new-tokens 256`` builds, started by
     ``serve_background``: the CT uploaded (ingest on the card), the
     twelve questions from twelve client threads at once and one streamed
     (K1 12 and K2 16 launches a request, K3 none), each report's tokens
     under the near-tie rule against its B=1 tokens; the slot decode's
     first 8 steps' logits against B=1 (5e-2) for two requests, one
     admitted mid-flight, with planted faults of the slot path, of which
     one at least must be rejected; a profile of 8 dispatches with every
     slot busy; ``--speculative auto`` on the twelve; and ``serve-llm``
     on the Llama-3.2-1B preset (greedy chat under the near-tie rule, a
     completion, a sampled n=8 fan-out);
  7. checks a reduced-depth, full-width model on the card against the same
     weights run in fp32 on the CPU through the plain versions: bf16
     weights with the int8 cache, int8 or int4 weights (quantized once on
     the CPU) with the int4 cache, and μ²Llama-3.2-1B with the bf16 cache;
     and (μ²Qwen3) with the chunked prefill, the shared-prefix prefill
     and a verify block written per row;
  8. drives the SFT training path: full-width μ²Qwen3-1.7B with fp32
     parameters and bf16 compute, AdamW at the ``TrainConfig`` defaults,
     decoder layers rematerialised, 6 steps of ``run_training`` on one
     seeded (1, 8, 32, 256, 256) volume and a 1024-token row (900 valid),
     a checkpoint at the end; asserts finite, falling loss, moving
     parameters and the kernel launches of every step; profiles one step;
  9. runs one train step of the reduced-depth model on the card and on the
     CPU from the same weights and compares the loss and each parameter's
     gradient; shows that the same limits reject planted faults of the
     flash backward's wiring;
 10. prints one JSON line per kernel table, the card line, and last
     ``{"ok": true, "device": {...}}``.

Float32 matrix products run in full fp32 (TF32 off for matmuls and cuDNN).
Exits non-zero, with no result line, when there is no CUDA device, when the
port is not importable, or when any check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
EX2_PER_SM_CLOCK = 16      # MUFU.EX2 a clock on each SM (Hopper)
# exponentials a second: EX2_PER_SM_CLOCK x SMs x the SM's max clock, set
# by ``exp_peak`` from the card before the first bound is taken
PEAK_EXP2 = None
# Kernel vs plain version, per element:
#     |out - ref| <= atol + rtol * |ref| + mtol * sum_j p_j |v_j|.
# Both outputs are bf16 rounded from fp32 sums taken in another order, so
# they may differ by about one bf16 ulp (2^-8 relative): rtol. The flash
# kernels round the unnormalised probabilities to bf16 where the plain
# version rounds the normalised ones, two errors of up to 2^-9 relative on
# each term p_j v_j: mtol = 2^-8 of the terms' absolute sum. It matters
# where a few keys carry all the weight and cancel, as in K2's early causal
# rows (0.0156 at |ref| ~0.5). atol covers the typical |ref| of 0.04. K3
# takes a (row, kv head) with fewer than 512 visible rows in its plain
# version's order of rounding (fp32 scores, bf16 probabilities), so the two
# differ only by the order of fp32 sums and one rounding of the bf16
# output: rtol, and atol 1e-3 for outputs near zero. Longer ones it splits
# over the sequence and rounds each probability before normalising: up to
# 2^-8 relative on each of 512 or more terms, which average out inside the
# same limits. A one-key change
# to the mask moves outputs by more, and each check below shows it: the
# kernel must fail these limits against a plain version whose mask is off
# by one key (and, for K3's int4 form, that reads the nibbles wrongly).
#
# The backward kernels take the same inputs as their plain versions (the
# plain lse and dd), so each is held alone. K4a's lse is fp32 from fp32 sums
# of exact bf16 products, as in its plain version: atol 1e-4 and rtol 1e-5
# cover summation order and the fast exp/log on |lse| < 10; a key more or
# less moves some rows' lse by over 1e-2. K4b and K4c round P and dS to
# bf16 before their products, where the plain versions (like the TPU
# kernel) keep them fp32: two errors of up to 2^-9 relative on each term,
# so mtol = 2^-8 of the terms' absolute sum (sum |dS||K| s for dq,
# sum |dS||Q| s for dk, sum P|dO| for dv); their bf16 outputs differ by
# about one ulp (rtol); atol 1e-3 covers outputs near zero.
TOL = {"flash_fwd_noncausal": (4e-3, 1e-2, 2.0 ** -8),
       "flash_fwd_causal": (4e-3, 1e-2, 2.0 ** -8),
       "decode_attention_int8": (1e-3, 1e-2, 0.0),
       "decode_attention_int4": (1e-3, 1e-2, 0.0),
       "flash_bwd_lse": (1e-4, 1e-5, 0.0),
       "flash_bwd_dq": (1e-3, 1e-2, 2.0 ** -8),
       "flash_bwd_dkv": (1e-3, 1e-2, 2.0 ** -8)}
PROMPT, MAX_NEW, BATCH, VISION_MICROBATCH = 1024, 768, 4, 8
# the μ²Llama report and speculative phases decode 256 tokens (the users'
# 768 cut when the serving phase came, for the script's time)
REPORT_TOKENS = 256
# the B=4 bf16 path decodes 256 tokens, the B=112 path 768, so that the
# script stays near half its time limit on a slow host
B4_MAX_NEW = 256
RAGGED = 900               # the last row's prompt length
QUESTION = 64              # question tokens, the μ²tokenizer's text condition
# The serving configuration of the JAX package's bench.py: int8 decoder
# weights, int4 KV cache, 112 volumes, the ViT over groups of 128 chunks.
QUANT_BATCH, QUANT_WEIGHTS, QUANT_CACHE, QUANT_MICROBATCH = 112, "int8", \
    "int4", 128
TRAIN_STEPS = 6
TRAIN_VALID, TRAIN_PROMPT = 900, 320  # the training row: valid, unlabelled
# Train step of the reduced model, card (bf16 compute) against CPU (fp32),
# held parameter by parameter: the cosine of each gradient to its fp32
# counterpart and the ratio of their norms. bf16 rounds every activation
# and gradient to 2^-9 relative; those errors average out in the loss and
# in most leaves' gradients. The limits sit between the sound step's worst
# leaf and the planted faults of the backward's wiring (``planted_faults``),
# and the check fails unless each fault is rejected. Left out (and
# reported) are the leaves that ``judged`` names: the μ²tokenizer's key
# biases, whose gradient is zero in exact arithmetic (softmax is invariant
# to the q.b_k they add to a row of scores) and rounding noise in both
# runs; and its aggregator's queries (TTA layers, query tokens), whose
# gradient reaches the loss only through the μ²tokenizer's attention
# softmaxes over bf16 scores, and which are as far off the CPU's when the
# card runs the plain attention in place of the kernels.
TRAIN_LOSS_TOL, TRAIN_COS_MIN, TRAIN_NORM_TOL = 1e-3, 0.995, 3e-2


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, inner: int = 1, reps: int = 7, warmup: int = 2):
    """Median over ``reps`` of the per-call time of ``inner`` back-to-back
    calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def device_ms(torch, fn, kernel: str, calls: int = 7):
    """The median device time (ms) of the kernel whose ``__global__`` name
    is ``kernel`` over ``calls`` calls of ``fn`` (after one unprofiled),
    from torch.profiler's trace of the card; each call launches it once.
    The trace may miss a launch at the end of the window (seen on the H100
    with 4 ms launches), so it must hold at least half of them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels, _ = device_time(torch, prof)
    times = [e.time_range.elapsed_us() for e in kernels
             if f"::{kernel}<" in e.name]
    if not calls // 2 <= len(times) <= calls:
        raise AssertionError(f"device_ms: {len(times)} launches of {kernel} "
                             f"in the trace of {calls} calls")
    return statistics.median(times) / 1e3


def ptxas_summary(report: str) -> dict:
    """Per kernel (mangled name) of an ``nvcc -Xptxas -v`` report:
    registers a thread, the spill line, and how often ptxas injected a
    warpgroup wait or arrive around wgmma."""
    out, name = {}, None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        injected = re.search(r"is injected .* in function '(\S+)'", line)
        if entry:
            name = entry.group(1)
            out.setdefault(name, {"injected": 0})
        elif injected:
            out.setdefault(injected.group(1), {"injected": 0})["injected"] += 1
        elif name and "spill" in line:
            out[name]["spill"] = line.strip()
        elif name and "registers" in line:
            out[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return out


def exp_peak(torch) -> dict:
    """Set PEAK_EXP2 from the card: its SM count (torch) and the SMs' max
    clock (nvidia-smi), and return both."""
    global PEAK_EXP2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    PEAK_EXP2 = EX2_PER_SM_CLOCK * sms * mhz * 1e6
    return {"sms": sms, "sm_clock_max_mhz": mhz, "peak_exp2_per_s": PEAK_EXP2}


def bound_ms(flops: float, nbytes: float, exps: float = 0.0):
    """The least time (ms) the card could take: the largest of the FLOPs
    at the bf16 tensor-core peak, the bytes at the memory's peak and the
    exponentials at the special-function units' peak; and which one."""
    times = {"operations": flops / PEAK_BF16_FLOPS,
             "bytes": nbytes / PEAK_BYTES, "exp": exps / PEAK_EXP2}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def excess(torch, out, ref, mass, name: str):
    """(max abs error, max over elements of error / its limit); ``mass`` is
    sum_j p_j |v_j|, or None where TOL[name] gives it no weight."""
    atol, rtol, mtol = TOL[name]
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    limit = atol + rtol * ref.abs()
    if mtol:
        limit = limit + mtol * mass.float()
    return err.max().item(), (err / limit).max().item()


def compare(torch, out, ref, name: str, mutants, mass=None) -> dict:
    """Hold ``out`` to ``ref`` under TOL[name], and show that the same
    limits reject each of ``mutants``: plain versions whose mask is off by
    one key, or that read the cache wrongly."""
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    err, ratio = excess(torch, out, ref, mass, name)
    if ratio > 1:
        raise AssertionError(f"{name}: max abs error {err:.4g}, {ratio:.3g}x "
                             f"the limit atol + rtol|ref| = {TOL[name]}")
    caught = {}
    for label, mutant in mutants.items():
        m_err, m_ratio = excess(torch, out, mutant, mass, name)
        if m_ratio <= 1:
            raise AssertionError(f"{name}: the limits {TOL[name]} do not tell "
                                 f"the kernel from a plain version with "
                                 f"{label} (max abs diff {m_err:.4g})")
        caught[label] = {"max_abs_diff": m_err, "x_limit": m_ratio}
    return {"max_abs_err": err, "x_limit": ratio, "tol": list(TOL[name]),
            "mutants": caught}


# Attention calls of the main paths: the ViT's (8 chunks, 2049 tokens, 12
# heads of 64, q/k/v strided views of the fused qkv), the decoder's prefill
# (4 rows, 1024 tokens, 16 q / 8 kv heads of 128) and the training path's
# decoder call (one row of 1024, 900 valid). The flash backward is also
# held at two small shapes at the edges of its 64-row tiles: 193 = 3*64 + 1
# tokens (one row into a tile), rows valid for 65 and 63 keys (one past and
# one short of a tile) and the last for 128 (a tile boundary, so the lens
# mutants cross it), at group 1 with fused q/k/v and at group 2.
VIT_CALL = dict(causal=False, b=VISION_MICROBATCH, s=2049, h=12, hkv=12,
                d=64, lens=[2049] * (VISION_MICROBATCH - 1) + [1777],
                fused=True)
PREFILL_CALL = dict(causal=True, b=BATCH, s=PROMPT, h=16, hkv=8, d=128,
                    lens=[PROMPT] * (BATCH - 1) + [RAGGED], fused=False)
TRAIN_DECODER_CALL = dict(PREFILL_CALL, b=1, lens=[TRAIN_VALID])
# The quantized serving path's calls of K1 and K2: the ViT over groups of
# 128 chunks (all 2049 tokens valid) and the prefill of 112 rows (the last
# 900). There the plain version over the whole batch would need tens of GB
# of fp32 scores, so it holds the batch's last HELD_ROWS rows (the ragged
# one among them) and is timed on those.
QUANT_VIT_CALL = dict(VIT_CALL, b=QUANT_MICROBATCH,
                      lens=[2049] * QUANT_MICROBATCH)
QUANT_PREFILL_CALL = dict(PREFILL_CALL, b=QUANT_BATCH,
                          lens=[PROMPT] * (QUANT_BATCH - 1) + [RAGGED])
HELD_ROWS = 8
EDGE_CALLS = [dict(causal=False, b=3, s=193, h=2, hkv=2, d=64,
                   lens=[65, 63, 128], fused=True),
              dict(causal=True, b=3, s=193, h=4, hkv=2, d=128,
                   lens=[65, 63, 128], fused=False)]


# The μ²Llama-3.2-1B report (``drive_report``): 256 <im_patch> tokens and
# this question make the prompt, padded to 1024; K2 at its prefill is
# (1, 1024, 32, 64) queries over 8 kv heads, GQA group 4, D=64.
REPORT_QUESTION = "Describe the findings of this chest CT ."
REPORT_PROMPT_LEN = 256 + len(REPORT_QUESTION.split())
LLAMA_PREFILL_CALL = dict(causal=True, b=1, s=PROMPT, h=32, hkv=8, d=64,
                          lens=[REPORT_PROMPT_LEN], fused=False)
# Kernel forms that the presets reach and no path of this script drives,
# held untimed: K2 at the Qwen3-8B prefill (D=128, group 4), K4a-c at the
# μ²Llama-3.2-1B SFT call (D=64, causal, group 4), and K3 at both presets'
# heads (``DECODE_PRESET_HEADS``).
QWEN8B_PREFILL_CALL = dict(causal=True, b=2, s=PROMPT, h=32, hkv=8, d=128,
                           lens=[PROMPT, RAGGED], fused=False)
LLAMA_TRAIN_CALL = dict(LLAMA_PREFILL_CALL, lens=[TRAIN_VALID])
DECODE_PRESET_HEADS = {"qwen3_8b": (32, 8, 128), "llama_3_2_1b": (32, 8, 64)}


def attention_inputs(torch, call: dict, seed: int):
    """q, k, v, lens (a list) and lens_t (int32 on the card) at ``call``,
    from a seeded generator, which is returned too."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, s, h, hkv, d = (call[key] for key in ("b", "s", "h", "hkv", "d"))
    if call["fused"]:
        qkv = torch.randn(b, s, 3 * h * d, generator=g, device="cuda",
                          dtype=torch.bfloat16)
        q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].reshape(b, s, h, d)
                   for i in range(3))
    else:
        q = torch.randn(b, s, h, d, generator=g, device="cuda",
                        dtype=torch.bfloat16)
        k, v = (torch.randn(b, s, hkv, d, generator=g, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
    lens = list(call["lens"])
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, k, v, lens, lens_t, g


def visible_pairs(causal: bool, s: int, lens) -> int:
    """(query, key) pairs the mask lets through, per head: query row i
    sees min(i+1, len) keys (causal) or len keys."""
    if causal:
        return sum(sum(min(i + 1, n) for i in range(s)) for n in lens)
    return s * sum(lens)


def sdpa_mask(torch, lens_t, s: int, causal: bool):
    """The boolean (B, 1, 1 or S, S) mask of SDPA's call: keys j < lens[b]
    (and j <= i when causal)."""
    keys = torch.arange(s, device="cuda")
    mask = (keys[None, :] < lens_t[:, None])[:, None, None, :]
    if causal:
        mask = mask & (keys[None, :] <= keys[:, None])[None, None]
    return mask


def check_flash(torch, F, fa, call: dict, seed: int, timed: bool = True,
                held: int = 0):
    """K1 (a non-causal ``call``) or K2 (a causal one) on the batch of
    ``attention_inputs``, held against its plain version, whose mask the
    same limits must tell from one with lens[-1] one key off (a shift
    past the sequence leaves the mask as it is and is not made). With
    ``held`` only the batch's last ``held`` rows are held, and the plain
    version is timed on those. With ``timed`` False only the check runs
    and the times are None."""
    causal = call["causal"]
    q, k, v, lens, lens_t, _ = attention_inputs(torch, call, seed)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    name = fa.KERNELS[int(causal)]
    out = fa.flash_attention(q, k, v, lens_t, causal=causal)
    rows = slice(b - held, b) if held else slice(0, b)
    hq, hk, hv, hl = q[rows], k[rows], v[rows], lens_t[rows]
    ref = fa.flash_attention_reference(hq, hk, hv, hl, causal=causal)
    mutants = {}
    for shift in (-1, 1):
        if not 0 < lens[-1] + shift <= s:
            continue
        off = hl.clone()
        off[-1] += shift
        mutants[f"lens[-1]{shift:+d}"] = fa.flash_attention_reference(
            hq, hk, hv, off, causal=causal)
    mass = fa.flash_attention_reference(hq, hk, hv.abs(), hl, causal=causal)
    torch.cuda.synchronize()
    check = compare(torch, out[rows], ref, name, mutants, mass)
    del out, ref, mutants, mass

    ms = dev_ms = plain_ms = library_ms = None
    if timed:
        ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, lens_t,
                                                       causal=causal))
        dev_ms = device_ms(torch, lambda: fa.flash_attention(
            q, k, v, lens_t, causal=causal), "flash_fwd_kernel")
        plain_ms = time_ms(torch, lambda: fa.flash_attention_reference(
            hq, hk, hv, hl, causal=causal), reps=3)
        mask = sdpa_mask(torch, lens_t, s, causal)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=hkv != h))
        del mask, qt, kt, vt

    # work this data needs; each tensor is read or written once
    pairs = h * visible_pairs(causal, s, lens)  # one exponential each
    flops = 4.0 * d * pairs
    nbytes = 2.0 * b * s * d * (2 * h + 2 * hkv)
    bms, by = bound_ms(flops, nbytes, pairs)
    return {"name": name, "route": "cuda",
            "source": "u2tokenizer_torch/csrc/flash_fwd.cu",
            "replaces": ("u2tokenizer_tpu/ops/flash_attention.py:73"
                         if causal else
                         "u2tokenizer_tpu/ops/flash_attention.py:45"),
            "max_abs_err": check.pop("max_abs_err"), "ms": ms,
            "device_ms": dev_ms,
            "plain_ms": plain_ms, "plain_rows": rows.stop - rows.start,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "library_call": "SDPA, the same mask", "check": check,
            "shape": {"q": list(q.shape), "k": list(k.shape),
                      "lens": lens if b <= 8 else
                      f"{lens[0]} x{b - 1}, {lens[-1]}"}}


def flash_fwd_summary(calls: dict) -> dict:
    """Per call of K1 or K2: its time, its share of the bound
    (bound_ms / ms) and its ratio to SDPA's call with the same mask."""
    return {label: {"kernel": e["name"], "ms": e["ms"],
                    "device_ms": e["device_ms"],
                    "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
                    "share_of_bound": e["bound_ms"] / e["ms"],
                    "device_share_of_bound": e["bound_ms"] / e["device_ms"],
                    "sdpa_ms": e["library_ms"],
                    "over_sdpa": e["ms"] / e["library_ms"],
                    "shape": e["shape"]}
            for label, e in calls.items()}


def time_flash_bwd(torch, F, fa, q, k, v, do, lse, dd, lens_t, kw):
    """CUDA-event times (ms) of K4a, K4b and K4c, their device times
    (torch.profiler), the plain versions' times, and SDPA's whole backward
    with the same mask."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    causal = kw["causal"]
    args = (q, k, v, do, lse, dd)
    ms = {"lse": time_ms(torch, lambda: fa.flash_bwd_lse(q, k, lens_t, **kw)),
          "dq": time_ms(torch, lambda: fa.flash_bwd_dq(*args, lens_t, **kw)),
          "dkv": time_ms(torch, lambda: fa.flash_bwd_dkv(*args, lens_t,
                                                         **kw))}
    dev_ms = {"lse": device_ms(torch, lambda: fa.flash_bwd_lse(
        q, k, lens_t, **kw), "lse_kernel"),
              "dq": device_ms(torch, lambda: fa.flash_bwd_dq(
                  *args, lens_t, **kw), "dq_kernel"),
              "dkv": device_ms(torch, lambda: fa.flash_bwd_dkv(
                  *args, lens_t, **kw), "dkv_kernel")}
    plain_ms = {
        "lse": time_ms(torch, lambda: fa.flash_bwd_lse_reference(
            q, k, lens_t, **kw), reps=3),
        "dq": time_ms(torch, lambda: fa.flash_bwd_dq_reference(
            *args, lens_t, **kw), reps=3),
        "dkv": time_ms(torch, lambda: fa.flash_bwd_dkv_reference(
            *args, lens_t, **kw), reps=3)}
    mask = sdpa_mask(torch, lens_t, s, causal)
    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                       enable_gqa=hkv != h)
    dot = do.transpose(1, 2).contiguous()
    library_ms = time_ms(torch, lambda: torch.autograd.grad(
        o, (qt, kt, vt), dot, retain_graph=True))
    del o, qt, kt, vt
    return ms, dev_ms, plain_ms, library_ms


def check_flash_bwd(torch, F, fa, call: dict, seed: int,
                    timed: bool = True):
    """K4a, K4b and K4c at ``call`` (``attention_inputs``; dO from the same
    seeded generator), each against its plain version on the same lse and
    dd. Returns three kernel entries; their ``library_ms`` is SDPA's whole
    backward (dq, dk and dv together) with the same mask. With ``timed``
    False only the checks run and the times are None."""
    causal = call["causal"]
    q, k, v, lens, lens_t, g = attention_inputs(torch, call, seed)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    scale = 1.0 / d ** 0.5
    do = torch.randn(b, s, h, d, generator=g, device="cuda",
                     dtype=torch.bfloat16)
    out = fa.flash_attention_reference(q, k, v, lens_t, causal=causal)
    dd = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    kw = dict(causal=causal, scale=scale)
    lse_ref = fa.flash_bwd_lse_reference(q, k, lens_t, **kw)
    args = (q, k, v, do, lse_ref, dd)

    lse = fa.flash_bwd_lse(q, k, lens_t, **kw)
    dq = fa.flash_bwd_dq(*args, lens_t, **kw)
    dk, dv = fa.flash_bwd_dkv(*args, lens_t, **kw)
    dq_ref = fa.flash_bwd_dq_reference(*args, lens_t, **kw)
    dk_ref, dv_ref = fa.flash_bwd_dkv_reference(*args, lens_t, **kw)
    p, ds = fa.flash_bwd_probs(*args, lens_t, **kw)
    qg = q.float().abs().reshape(b, s, hkv, h // hkv, d)
    dog = do.float().abs().reshape(b, s, hkv, h // hkv, d)
    mass_dq = (torch.einsum("bhgqk,bkhd->bqhgd", ds.abs(), k.float().abs())
               * scale).reshape(b, s, h, d)
    mass_dk = torch.einsum("bhgqk,bqhgd->bkhd", ds.abs(), qg) * scale
    mass_dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    del p, ds, qg, dog
    mutants = {"lse": {}, "dq": {}, "dk": {}, "dv": {}}
    for shift in (-1, 1):
        off = lens_t.clone()
        off[-1] += shift
        label = f"lens[-1]{shift:+d}"
        mutants["lse"][label] = fa.flash_bwd_lse_reference(q, k, off, **kw)
        mutants["dq"][label] = fa.flash_bwd_dq_reference(*args, off, **kw)
        mutants["dk"][label], mutants["dv"][label] = (
            fa.flash_bwd_dkv_reference(*args, off, **kw))
    torch.cuda.synchronize()
    checks = {
        "lse": compare(torch, lse, lse_ref, "flash_bwd_lse", mutants["lse"]),
        "dq": compare(torch, dq, dq_ref, "flash_bwd_dq", mutants["dq"],
                      mass_dq),
        "dk": compare(torch, dk, dk_ref, "flash_bwd_dkv", mutants["dk"],
                      mass_dk),
        "dv": compare(torch, dv, dv_ref, "flash_bwd_dkv", mutants["dv"],
                      mass_dv)}
    del mutants, mass_dq, mass_dk, mass_dv
    scale_of = {name: {"max_abs_ref": ref.float().abs().max().item(),
                       "mean_abs_ref": ref.float().abs().mean().item()}
                for name, ref in (("lse", lse_ref), ("dq", dq_ref),
                                  ("dk", dk_ref), ("dv", dv_ref))}

    ms = dev_ms = plain_ms = {"lse": None, "dq": None, "dkv": None}
    library_ms = None
    if timed:
        ms, dev_ms, plain_ms, library_ms = time_flash_bwd(
            torch, F, fa, q, k, v, do, lse_ref, dd, lens_t, kw)

    seen = visible_pairs(causal, s, lens)
    q_bytes, kv_bytes, stat_bytes = 2.0 * b * s * h * d, \
        2.0 * b * s * hkv * d, 4.0 * b * h * s
    work = {"lse": (2.0 * d * h * seen, q_bytes + kv_bytes + stat_bytes),
            "dq": (6.0 * d * h * seen,
                   3 * q_bytes + 2 * kv_bytes + 2 * stat_bytes),
            "dkv": (8.0 * d * h * seen,
                    2 * q_bytes + 4 * kv_bytes + 2 * stat_bytes)}
    shape = {"q": list(q.shape), "k": list(k.shape), "lens": lens,
             "causal": causal}
    entries = []
    for key, name, line, err in (
            ("lse", "flash_bwd_lse", 163, checks["lse"]["max_abs_err"]),
            ("dq", "flash_bwd_dq", 204, checks["dq"]["max_abs_err"]),
            ("dkv", "flash_bwd_dkv", 245, max(checks["dk"]["max_abs_err"],
                                              checks["dv"]["max_abs_err"]))):
        bms, by = bound_ms(*work[key], h * seen)  # one exp a pair
        parts = ("dk", "dv") if key == "dkv" else (key,)
        entries.append({
            "name": name, "route": "cuda",
            "source": "u2tokenizer_torch/csrc/flash_bwd.cu",
            "replaces": f"u2tokenizer_tpu/ops/flash_attention.py:{line}",
            "max_abs_err": err, "ms": ms[key], "device_ms": dev_ms[key],
            "plain_ms": plain_ms[key],
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "library_call": "SDPA backward: dq, dk and dv together",
            "check": {part: checks[part] for part in parts},
            "ref_scale": {part: scale_of[part] for part in parts},
            "shape": shape})
    return entries


def flash_bwd_summary(calls: dict) -> dict:
    """Per call: K4b + K4c, and K4a + K4b + K4c (the whole flash
    backward), against SDPA's whole backward, and each kernel's share of
    its bound (bound_ms / ms)."""
    out = {}
    for label, (lse, dq, dkv) in calls.items():
        pair = dq["ms"] + dkv["ms"]
        whole = lse["ms"] + pair
        out[label] = {"k4b_ms": dq["ms"], "k4c_ms": dkv["ms"],
                      "k4a_ms": lse["ms"], "k4b_plus_k4c_ms": pair,
                      "k4a_plus_k4b_plus_k4c_ms": whole,
                      "device_ms": {"k4a": lse["device_ms"],
                                    "k4b": dq["device_ms"],
                                    "k4c": dkv["device_ms"]},
                      "bound_by": {"k4a": lse["bound_by"],
                                   "k4b": dq["bound_by"],
                                   "k4c": dkv["bound_by"]},
                      "k4a_device_share_of_bound":
                          lse["bound_ms"] / lse["device_ms"],
                      "sdpa_backward_ms": dq["library_ms"],
                      "k4b_plus_k4c_over_sdpa": pair / dq["library_ms"],
                      "k4a_plus_k4b_plus_k4c_over_sdpa":
                          whole / dq["library_ms"],
                      "k4b_share_of_bound": dq["bound_ms"] / dq["ms"],
                      "k4c_share_of_bound": dkv["bound_ms"] / dkv["ms"],
                      "k4a_share_of_bound": lse["bound_ms"] / lse["ms"],
                      "shape": dq["shape"]}
    return out


def nibbles(p, torch, order: str):
    """A packed int4 cache read wrongly, as an int8 cache of its values:
    the nibbles of each byte swapped, or read unsigned."""
    if order == "swapped":
        pair = (p >> 4, ((p & 0x0F) ^ 8) - 8)
    else:
        pair = (p & 0x0F, (p >> 4) & 0x0F)
    return torch.stack(pair, dim=-1).flatten(-2)


def check_decode(torch, da, attn, bits: int, b: int,
                 step: int = (MAX_NEW - 1) // 2, prompt=None,
                 timed: bool = True, heads=(16, 8, 128)):
    """K3 at decode step ``step`` of a serving path: ``b`` rows, ``heads``
    (q heads, kv heads, head dim; μ²Qwen3-1.7B's 16 / 8 of 128 by
    default), an int8 (``bits`` 8) or packed int4 (4) cache of 1024 + 768
    slots, the rows' prompts ``prompt`` long (by default 1024, the last row
    900). Holds it to its plain version under TOL, shows that the same
    limits reject prompt_len[-1] and end one key off (and, at int4,
    nibbles read wrongly) and that a second call gives the same bits. With
    ``timed`` it is timed (CUDA events and device time) on caches cycled
    out of L2."""
    h, hkv, d = heads
    s_total = PROMPT + MAX_NEW
    name = da.KERNELS[bits]
    plen_l = list(prompt or [PROMPT] * (b - 1) + [RAGGED])
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(b, 1, h, d, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    # distinct caches, cycled while timing, so that the 50 MB L2 holds none
    # (the serving loop reads 28 layers' caches in turn)
    cache_bytes = 2 * b * hkv * s_total * d * bits // 8
    n_caches = max(2, min(16, math.ceil(8 * 50e6 / cache_bytes))) \
        if timed else 1
    caches = []
    for _ in range(n_caches):
        kf, vf = (torch.randn(b, s_total, hkv, d, generator=g, device="cuda",
                              dtype=torch.bfloat16) for _ in range(2))
        (kq, ks), (vq, vs) = (attn.quantize_kv(x, dtype=f"int{bits}")
                              for x in (kf, vf))
        if bits == 4:
            kq, vq = attn.pack_nibbles(kq), attn.pack_nibbles(vq)
        caches.append(tuple(x.transpose(1, 2).contiguous() for x in
                            (kq, ks[..., 0], vq, vs[..., 0])))
        del kf, vf
    plen = torch.tensor(plen_l, dtype=torch.int32, device="cuda")
    end = torch.full((b,), PROMPT + step + 1, dtype=torch.int32,
                     device="cuda")
    kq, ks, vq, vs = caches[0]
    out = da.decode_attention_quantized(q, kq, ks, vq, vs, plen, end, PROMPT)
    n_split = da.split_count(b, hkv, s_total, da.sm_count(q.device))
    again = da.decode_attention_quantized(q, kq, ks, vq, vs, plen, end,
                                          PROMPT)
    ref = da.decode_attention_reference(q, kq, ks, vq, vs, plen, end, PROMPT)
    visible = da.visible_keys(plen, end, PROMPT, s_total)
    mutants = {}
    for shift in (-1, 1):  # each that moves the mask by a key
        off = plen.clone()
        off[-1] += shift
        if not torch.equal(da.visible_keys(off, end, PROMPT, s_total),
                           visible):
            mutants[f"prompt_len[-1]{shift:+d}"] = \
                da.decode_attention_reference(q, kq, ks, vq, vs, off, end,
                                              PROMPT)
        if not torch.equal(da.visible_keys(plen, end + shift, PROMPT,
                                           s_total), visible):
            mutants[f"end{shift:+d}"] = da.decode_attention_reference(
                q, kq, ks, vq, vs, plen, end + shift, PROMPT)
    if bits == 4:
        for order in ("swapped", "unsigned"):
            mutants[f"nibbles {order}"] = da.decode_attention_reference(
                q, nibbles(kq, torch, order), ks, nibbles(vq, torch, order),
                vs, plen, end, PROMPT)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    check = compare(torch, out, ref, name, mutants)
    del mutants, again

    ms = dev_ms = plain_ms = None
    if timed:
        it = iter(range(1 << 30))

        def run():
            kq, ks, vq, vs = caches[next(it) % len(caches)]
            da.decode_attention_quantized(q, kq, ks, vq, vs, plen, end,
                                          PROMPT)

        ms = time_ms(torch, run, inner=32)
        dev_ms = device_ms(torch, run, "decode_attn_kernel", calls=32)
        plain_ms = time_ms(torch, lambda: da.decode_attention_reference(
            q, kq, ks, vq, vs, plen, end, PROMPT), inner=4)
    rows = int(visible.sum())  # visible cache rows
    # per visible row and kv head: D*bits/8 bytes of K and of V, two bf16
    # scales; q read and the output written once; one exponential per
    # visible row and query head
    nbytes = hkv * rows * (2 * d * bits // 8 + 2 * 2) + 2 * (2 * b * h * d)
    flops = 4.0 * d * h * rows
    bms, by = bound_ms(flops, nbytes, h * rows)
    return {"name": name, "route": "cuda",
            "source": "u2tokenizer_torch/csrc/decode_attention.cu",
            "replaces": "u2tokenizer_tpu/ops/decode_attention.py:32",
            "max_abs_err": check.pop("max_abs_err"), "ms": ms,
            "device_ms": dev_ms, "n_split": n_split,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "check": check,
            "shape": {"q": list(q.shape), "k": list(kq.shape),
                      "prompt_len": plen_l if b <= 8 else
                      f"{plen_l[0]} x{b - 1}, {plen_l[-1]}",
                      "end": PROMPT + step + 1, "step": step}}


def decode_summary(calls: dict) -> dict:
    """Per timed call of K3: n_split, time, device time and their shares
    of the bound."""
    return {label: {"kernel": e["name"], "n_split": e["n_split"],
                    "ms": e["ms"], "device_ms": e["device_ms"],
                    "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
                    "share_of_bound": e["bound_ms"] / e["ms"],
                    "device_share_of_bound": e["bound_ms"] / e["device_ms"],
                    "shape": e["shape"]}
            for label, e in calls.items()}


# K3's untimed checks beside the three timed calls (step 383 at int8 and
# int4 B=4 and int4 B=112): the first and last decode steps at each; a
# batch with a 3-token prompt, whose (row, kv head)s are not split (fewer
# visible rows than csrc/decode_attention.cu's EXACT_ROWS), so that the
# other blocks of their grid columns find no rows, at steps 0 and 383;
# and B=1. Each is (bits, batch, step, prompt).
DECODE_EDGE_CALLS = (
    [(bits, b, step, None) for bits, b in ((8, BATCH), (4, BATCH),
                                            (4, QUANT_BATCH))
     for step in (0, MAX_NEW - 1)]
    + [(bits, BATCH, step, [PROMPT] * (BATCH - 1) + [3])
       for bits in (8, 4) for step in (0, (MAX_NEW - 1) // 2)]
    + [(bits, 1, (MAX_NEW - 1) // 2, [RAGGED]) for bits in (8, 4)])


def reset_launches(*modules):
    for module in modules:
        for name in module.launches:
            module.launches[name] = 0


def read_launches(*modules):
    return {name: n for module in modules for name, n in
            module.launches.items()}


def drive_main_path(torch, max_new: int, batch: int, weights: str,
                    cache: str, vision_microbatch: int):
    """One serving run of full-width μ²Qwen3-1.7B through
    ``make_multimodal_generate_fn``: weights cast to bf16 and, unless
    ``weights`` is "bf16", the decoder's quantized in place to int8 or
    int4; a ``cache`` KV cache; ``batch`` volumes; the ViT over groups of
    ``vision_microbatch`` chunks. Times each stage, reads the kernel
    launches of the run and profiles 8 decode steps."""
    from u2tokenizer_torch.config import GenerationConfig, U2ModelConfig
    from u2tokenizer_torch.models.generate import make_multimodal_generate_fn
    from u2tokenizer_torch.models.quantize import (cast_for_inference,
                                                   quantize_llm_weights)
    from u2tokenizer_torch.models.u2_model import U2CausalLM
    from u2tokenizer_torch.ops import decode_attention as da
    from u2tokenizer_torch.ops import flash_attention as fa

    cfg = U2ModelConfig()  # μ²Qwen3-1.7B, full width and depth
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = cast_for_inference(U2CausalLM(cfg, dtype=torch.bfloat16,
                                          device="cuda", seed=0))
    if weights != "bf16":
        quantize_llm_weights(model, weights)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weight_gb = sum(p.numel() * p.element_size()
                    for p in model.parameters()) / 1e9

    g = torch.Generator(device="cuda").manual_seed(0)
    d, h, w = cfg.vision.input_spatial
    images = torch.randn(batch, cfg.num_chunks, d, h, w, generator=g,
                         device="cuda", dtype=torch.bfloat16)
    vocab = cfg.llm.vocab_size
    input_ids = torch.randint(0, vocab, (batch, PROMPT), generator=g,
                              device="cuda")
    question_ids = torch.randint(0, vocab, (batch, QUESTION), generator=g,
                                 device="cuda")
    prompt_len = torch.tensor([PROMPT] * (batch - 1) + [RAGGED],
                              dtype=torch.int32, device="cuda")
    gen = GenerationConfig(max_new_tokens=max_new, do_sample=False,
                           eos_token_id=-2, pad_token_id=0)
    generate = make_multimodal_generate_fn(
        model, gen, cache_dtype=cache, vision_microbatch=vision_microbatch)

    reset_launches(fa, da)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embeds = generate.embeds(input_ids, images, question_ids)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    kv, tok0, done0, hidden = generate.prefill_stage(embeds, prompt_len)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _, _, rest = generate.decode_steps(kv, tok0, done0, prompt_len,
                                       range(max_new - 1))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    tokens = torch.cat([tok0[:, None], rest], dim=1)
    launches = read_launches(fa, da)
    peak = torch.cuda.max_memory_allocated()
    del kv
    profile = profile_decode(torch, generate, embeds, prompt_len)

    assert tuple(embeds.shape) == (batch, PROMPT, cfg.llm.hidden_size)
    assert torch.isfinite(embeds).all(), "non-finite prompt embeddings"
    assert torch.isfinite(hidden).all(), "NaN/inf in the prefill hidden states"
    assert tuple(tokens.shape) == (batch, max_new), tokens.shape
    assert tokens.dtype == torch.int64
    assert ((tokens >= 0) & (tokens < vocab)).all(), "token out of range"
    total = t3 - t0
    return {"model": "mu2Qwen3-1.7B", "batch": batch, "prompt": PROMPT,
            "prompt_len": f"{PROMPT} x{batch - 1}, {RAGGED}",
            "question_tokens": QUESTION, "max_new_tokens": max_new,
            "cache": cache, "weights": weights, "weight_gb": weight_gb,
            "vision_microbatch": vision_microbatch,
            "model_build_s": build_s, "vision_s": t1 - t0,
            "prefill_s": t2 - t1, "decode_s": t3 - t2, "total_s": total,
            "reports_per_min": 60.0 * batch / total,
            "decode_ms_per_step": 1e3 * (t3 - t2) / max(max_new - 1, 1),
            "peak_mem_gb": peak / 1e9,
            "first_tokens": tokens[:4, :8].tolist(), "launches": launches,
            "decode_profile": profile}


def serve_and_check(torch, da, max_new: int, batch: int, weights: str,
                    cache: str, vision_microbatch: int, card: str):
    """``drive_main_path``, printed, with its launches held to what the
    code gives: K1 once per ViT layer per group of chunks, K2 once per
    decoder layer, the cache's K3 form once per decoder layer per decode
    step, no other kernel."""
    run = drive_main_path(torch, max_new, batch, weights, cache,
                          vision_microbatch)
    run["card"] = card
    print(json.dumps({f"serve_{weights}_weights_{cache}_cache": run}),
          flush=True)
    chunks = batch * 8
    groups = (chunks // vision_microbatch if chunks > vision_microbatch
              and chunks % vision_microbatch == 0 else 1)
    expected = {name: 0 for name in run["launches"]}
    expected.update({"flash_fwd_noncausal": 12 * groups,
                     "flash_fwd_causal": 28,
                     da.KERNELS[int(cache[3:])]: 28 * (max_new - 1)})
    if run["launches"] != expected:
        raise AssertionError(f"{weights} weights, {cache} cache: launches "
                             f"{run['launches']} != expected {expected}")
    return run


def device_time(torch, prof):
    """The kernels a profile saw on the card, and their summed time in us
    by the first 90 characters of their names; the ranges that
    record_function marks on the card's timeline (the optimizer step's,
    say) span kernels and are left out."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    by_name = {}
    for e in kernels:
        name = e.name[:90]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    return kernels, by_name


def profile_decode(torch, generate, embeds, prompt_len, steps: int = 8):
    """torch.profiler over ``steps`` decode steps (after 2 unprofiled
    ones): the card's busy share of the wall clock, kernels launched per
    step, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    cache, tok, done, _ = generate.prefill_stage(embeds, prompt_len)
    tok, done, _ = generate.decode_steps(cache, tok, done, prompt_len,
                                         range(2))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate.decode_steps(cache, tok, done, prompt_len,
                              range(2, 2 + steps))
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels, by_name = device_time(torch, prof)
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
            "device_ms_per_step": busy_us / steps / 1e3,
            "device_busy_share": busy_us / wall_us,
            "kernels_per_step": len(kernels) / steps,
            "top_device_ms_per_step": {n: t / steps / 1e3
                                       for n, t in top}}


def reduced_config(num_chunks: int, base=None):
    """``base`` (μ²Qwen3-1.7B by default) at full width, cut to 2 ViT, 1
    μ²tokenizer and 2 decoder layers and ``num_chunks`` depth chunks."""
    from u2tokenizer_torch.config import U2ModelConfig

    base = base or U2ModelConfig()
    return dataclasses.replace(
        base, num_chunks=num_chunks,
        vision=dataclasses.replace(base.vision, num_layers=2),
        u2t=dataclasses.replace(base.u2t, num_layers=1),
        llm=dataclasses.replace(base.llm, num_layers=2))


SHARED_SPLIT, PREFILL_CHUNK, VERIFY_BLOCK = 280, 128, 4


def check_reference(torch, weights: str = "bf16", cache="int8", base=None,
                    variant=None):
    """Full-width model (``base``, μ²Qwen3-1.7B by default) cut to 2 ViT,
    1 μ²tokenizer and 2 decoder layers and 4 chunks: the card (bf16,
    kernels) against the CPU (fp32, plain versions) on the same weights,
    with a ``cache`` KV cache. With ``weights`` "int8" or "int4" the
    decoder's weights are quantized once, on the CPU, and the card loads
    the same integers and scales. Compares the prefill's last-position
    logits and reports greedy token agreement over 4 decode steps.
    ``variant`` "prefill_chunk" prefills in chunks of 128 tokens;
    "shared_prefix" gives both rows one volume, question and first 280
    prompt tokens and prefills them in two phases (the prefix once);
    "verify_block" also compares the logits of a speculative verify block
    of 4 tokens (the CPU's greedy tokens) written per row after the
    prefill, row 0 at slot S and row 1 at S + 1."""
    from u2tokenizer_torch.config import GenerationConfig
    from u2tokenizer_torch.models.generate import make_multimodal_generate_fn
    from u2tokenizer_torch.models.quantize import (cast_for_inference,
                                                   quantize_llm_weights)
    from u2tokenizer_torch.models.u2_model import U2CausalLM

    cfg = reduced_config(num_chunks=4, base=base)
    b, s = 2, 384
    cpu = U2CausalLM(cfg, dtype=torch.float32, device="cpu", seed=1)
    gpu = cast_for_inference(U2CausalLM(cfg, dtype=torch.bfloat16,
                                        device="cuda", seed=2))
    if weights != "bf16":  # the card's model takes the quantized layout
        quantize_llm_weights(cpu, weights)
        quantize_llm_weights(gpu, weights)
    gpu.load_state_dict(cpu.state_dict())

    g = torch.Generator().manual_seed(1)
    d, h, w = cfg.vision.input_spatial
    images = torch.randn(b, cfg.num_chunks, d, h, w, generator=g)
    ids = torch.randint(0, cfg.llm.vocab_size, (b, s), generator=g)
    qids = torch.randint(0, cfg.llm.vocab_size, (b, 32), generator=g)
    plen = torch.tensor([s, 300], dtype=torch.int32)
    option = {}
    if variant == "prefill_chunk":
        option = {"prefill_chunk": PREFILL_CHUNK}
    elif variant == "shared_prefix":
        images[1], qids[1] = images[0], qids[0]
        ids[1, :SHARED_SPLIT] = ids[0, :SHARED_SPLIT]
        option = {"shared_prefix": (2, SHARED_SPLIT)}
    gen = GenerationConfig(max_new_tokens=5, eos_token_id=-2)

    results = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, "cuda")):
        fn = make_multimodal_generate_fn(
            model, gen, cache, prefill_chunk=option.get("prefill_chunk"))
        # the multimodal entry takes no shared_prefix (as the JAX
        # package's): its Generate does
        fn.gen_fn.shared_prefix = option.get("shared_prefix")
        args = [x.to(dev) for x in (ids, images, qids, plen)]
        embeds = fn.embeds(*args[:3])
        kv, tok0, done0, last = fn.prefill_stage(embeds, args[3])
        with torch.inference_mode():
            logits = model.lm_logits(last)[:, 0].float().cpu()
        _, _, rest = fn.decode_steps(kv, tok0, done0, args[3], range(4))
        tokens = torch.cat([tok0[:, None], rest], 1).cpu()
        block = None
        if variant == "verify_block":  # over the decode's slots, masked
            src = tokens if name == "cpu" else results["cpu"][1]
            block = verify_block_logits(torch, model, kv, args[3], s,
                                        src[:, :VERIFY_BLOCK])
        results[name] = (logits, tokens, block)
    (ref, tok_ref, block_ref), (out, tok_out, block_out) = \
        results["cpu"], results["gpu"]
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    agree = (tok_ref == tok_out).float().mean().item()
    line = {"model": "mu2Llama-3.2-1B" if base else "mu2Qwen3-1.7B",
            "weights": weights, "cache": str(cache),
            "variant": variant or "one_shot", "logits_rel_err": rel,
            "logits_tol": 5e-2, "token_agreement": agree,
            "tokens_cpu": tok_ref.tolist(), "tokens_gpu": tok_out.tolist()}
    if block_ref is not None:
        line["verify_block_rel_err"] = ((block_out - block_ref).abs().max()
                                        / block_ref.abs().max()).item()
        rel = max(rel, line["verify_block_rel_err"])
    if not rel <= 5e-2:
        raise AssertionError(f"reduced model, {weights} weights, {cache} "
                             f"cache, {line['variant']}: card vs CPU logits "
                             f"relative error {rel:.4g} over 5e-2")
    return line


def verify_block_logits(torch, model, cache, plen, s: int, tokens):
    """fp32 logits (B, k, V), on the host, of a verify block of the k
    tokens ``tokens`` (B, k) written per row into ``cache`` after the
    prefill, row b at slot s + b (a (B,) write index), with RoPE positions
    plen + j and each query seeing the row's prompt and the block's slots
    up to its own."""
    b, k = tokens.shape
    dev = plen.device
    widx = s + torch.arange(b, dtype=torch.int32, device=dev)
    kv = torch.arange(cache.max_len, device=dev)
    slots = widx[:, None, None] + torch.arange(k, device=dev)[None, :, None]
    key_ok = (kv[None, None, :] < plen[:, None, None]) | (
        (kv[None, None, :] >= widx[:, None, None])
        & (kv[None, None, :] <= slots))
    pos = (plen[:, None] + torch.arange(k, device=dev)[None, :]).int()
    with torch.inference_mode():
        logits, _, _ = model.decode_step(
            model.embed_tokens(tokens.to(dev)), pos, key_ok[:, None], cache,
            widx)
    return logits.float().cpu()


# μ²Llama-3.2-1B report phase: a NIfTI CT through the ingest, a checkpoint
# directory through U2InferenceModel, report text out.
CT_SHAPE = (512, 512, 300)  # (X, Y, Z) voxels, int16
# The card's fp32 ingest against the CPU's: the same fp32 arithmetic in
# other orders of summation (percentile lerp, Gaussian taps, interpolation
# weights); outputs lie in [0, 1], so 1e-4 absolute leaves ~1000 ulps.
INGEST_TOL = 1e-4
SAMPLE_TOP_P, SAMPLE_ROWS, SAMPLE_BATCHES = 0.9, 2048, 8


def released_config():
    """μ²Llama-3.2-1B as the released checkpoint's config.json declares it
    (tests/test_parity_trained_layout.py reads those fields): the Llama
    preset, the ViT declared depth-first (32, 256, 256) with (4, 16, 16)
    patches, the μ²tokenizer in 'rma' with DiffTS and DMTP, top-k 1024,
    256 query tokens."""
    from u2tokenizer_torch.config import (LLMConfig, U2ModelConfig,
                                          U2TokenizerConfig, VisionConfig)

    return U2ModelConfig(
        vision=VisionConfig(image_size=(32, 256, 256),
                            patch_size=(4, 16, 16), depth_axis=0),
        u2t=U2TokenizerConfig(attn_type="rma", enable_diffts=True,
                              enable_dmtp=True, top_k=1024,
                              num_query_tokens=256),
        llm=LLMConfig.llama_3_2_1b())


def synthetic_ct(shape=CT_SHAPE, seed: int = 0):
    """A CT in Hounsfield-like int16 values: air (-1000) outside an
    elliptical body, soft tissue about 40 with seeded noise inside, and
    four bone blobs about 700."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nx, ny, nz = shape
    x = (np.arange(nx) - nx / 2)[:, None, None] / (0.42 * nx)
    y = (np.arange(ny) - ny / 2)[None, :, None] / (0.33 * ny)
    body = (x * x + y * y) <= 1.0
    vol = np.where(body, rng.normal(40.0, 15.0, shape).astype(np.float32),
                   np.float32(-1000.0))
    z = np.arange(nz)[None, None, :]
    for _ in range(4):
        cx, cy = rng.uniform(-0.2, 0.2, 2) * (nx, ny) + (nx / 2, ny / 2)
        cz, r = rng.uniform(0.2, 0.8) * nz, rng.uniform(15, 30)
        blob = ((np.arange(nx)[:, None, None] - cx) ** 2
                + (np.arange(ny)[None, :, None] - cy) ** 2
                + (z - cz) ** 2) <= r * r
        vol[blob] = 700.0 + rng.normal(0.0, 30.0, int(blob.sum()))
    return vol.astype(np.int16)


def check_ingest(torch, tmp: str):
    """The synthetic CT written as an uncompressed .nii with the port's
    writer, through ``U2VolumeTransform()`` on the card (timed, host clock
    around a synchronize, after one untimed call), held to the same
    transform on the CPU within INGEST_TOL. Returns the result line and the
    card's (8, 32, 256, 256) volume."""
    from u2tokenizer_torch.data.nifti import read_nifti_raw, write_nifti
    from u2tokenizer_torch.data.transforms import (U2VolumeTransform,
                                                   percentiles)

    vol = synthetic_ct()
    path = os.path.join(tmp, "ct.nii")
    t0 = time.perf_counter()
    write_nifti(path, vol)
    write_s = time.perf_counter() - t0
    transform = U2VolumeTransform()
    times = []
    for _ in range(2):  # the first call also loads the kernels it uses
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = transform(path)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    # where the second call's time goes: the file read on the host, the
    # upload, the percentiles (one sort), the rest
    t0 = time.perf_counter()
    raw, _, _ = read_nifti_raw(path)
    t1 = time.perf_counter()
    x = torch.from_numpy(raw.astype(raw.dtype.newbyteorder("="))).cuda()
    x = x.float()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    percentiles(x, (0.5, 99.5))
    torch.cuda.synchronize()
    parts = {"read_s": t1 - t0, "upload_s": t2 - t1,
             "percentiles_s": time.perf_counter() - t2}
    del x, raw
    t0 = time.perf_counter()
    ref = U2VolumeTransform(device="cpu")(path)
    cpu_s = time.perf_counter() - t0
    if tuple(out.shape) != (8, 32, 256, 256) or out.dtype != torch.float32:
        raise AssertionError(f"ingest: {tuple(out.shape)} {out.dtype}")
    if not (torch.isfinite(out).all() and out.min() >= 0 and out.max() <= 1):
        raise AssertionError("ingest: values outside [0, 1]")
    err = (out.cpu() - ref).abs().max().item()
    if not err <= INGEST_TOL:
        raise AssertionError(f"ingest: card vs CPU max abs error {err:.3g} "
                             f"over {INGEST_TOL}")
    return {"volume": list(CT_SHAPE), "dtype": "int16",
            "file_mb": os.path.getsize(path) / 1e6, "write_s": write_s,
            "ingest_first_s": times[0], "ingest_s": times[1],
            "ingest_parts": parts,
            "cpu_ingest_s": cpu_s, "max_abs_err_vs_cpu": err,
            "tol": INGEST_TOL, "shape": list(out.shape),
            "nonzero_share": (out > 0).float().mean().item()}, out


@contextlib.contextmanager
def host_memory(sample_s: float = 0.01):
    """Peaks of this process's resident memory (GB) over the block, sampled
    by a thread, and their values before it: VmRSS, RssAnon and RssFile of
    /proc/self/status where the kernel gives them, and /proc/self/statm's
    resident pages less its shared (file-backed) ones; ``readings`` is
    filled when the block ends. VmRSS counts the pages of mapped files that
    were read as well as the process's own memory."""
    import threading

    page = os.sysconf("SC_PAGE_SIZE")

    def read():
        fields = {}
        with open("/proc/self/status") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key in ("VmRSS", "RssAnon", "RssFile"):
                    fields[key] = int(value.split()[0]) / 1e6  # kB -> GB
        with open("/proc/self/statm") as f:
            _, resident, shared = (int(v) for v in f.read().split()[:3])
        fields["statm_shared"] = shared * page / 1e9
        fields["statm_resident_less_shared"] = (resident - shared) * page / 1e9
        return fields

    readings = {"before": read()}
    peak = dict(readings["before"])
    done = threading.Event()

    def watch():
        while not done.wait(sample_s):
            for key, value in read().items():
                peak[key] = max(peak[key], value)

    thread = threading.Thread(target=watch, daemon=True)
    thread.start()
    try:
        yield readings
    finally:
        done.set()
        thread.join()
        readings["peak"] = peak


def full_vocab_tokenizer(vocab: int):
    """A MockTokenizer that knows a word for every id of the vocabulary
    (the question's words first), so that report text shows every token."""
    from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer

    tok = MockTokenizer()
    tok(REPORT_QUESTION)
    tok(" ".join(f"w{i}" for i in range(vocab - len(tok.vocab))))
    return tok


def drive_report(torch, fa, da, volume, tmp: str):
    """The μ²Llama-3.2-1B report path at full width and depth: random
    weights from seed 0 written by ``save_hf_checkpoint`` (fp32), loaded
    back by ``U2InferenceModel`` (bf16, bf16 cache), one greedy report of up
    to REPORT_TOKENS tokens through ``inference`` with the kernel launches
    of that call; its tokens (``generate_tokens``) against
    ``make_multimodal_generate_fn`` on the in-memory model that was
    exported, cast the same way, stage by stage (timed); then two sampled
    reports (top-p 0.9) from two instances of one seed. Returns the greedy
    report's tokens and the result line."""
    from u2tokenizer_torch.eval.inference import U2InferenceModel
    from u2tokenizer_torch.models.generate import make_multimodal_generate_fn
    from u2tokenizer_torch.models.hf_export import save_hf_checkpoint
    from u2tokenizer_torch.models.quantize import cast_for_inference
    from u2tokenizer_torch.models.u2_model import U2CausalLM
    from u2tokenizer_torch.weights import flax_params

    cfg = released_config()
    t0 = time.perf_counter()
    model = U2CausalLM(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    ckpt = os.path.join(tmp, "mu2llama")
    t0 = time.perf_counter()
    save_hf_checkpoint(ckpt, flax_params(model), cfg)
    export_s = time.perf_counter() - t0
    ckpt_gb = sum(e.stat().st_size for e in os.scandir(ckpt)) / 1e9
    cast_for_inference(model)  # the in-memory model, served as the loaded
    tok = full_vocab_tokenizer(cfg.llm.vocab_size)

    gc.collect()
    with host_memory() as host:
        t0 = time.perf_counter()
        im = U2InferenceModel(ckpt, tokenizer=tok, do_sample=False,
                              speculative=False,
                              max_new_tokens=REPORT_TOKENS)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_launches(fa, da)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = im.inference(volume, REPORT_QUESTION)
    torch.cuda.synchronize()
    report_s = time.perf_counter() - t0
    launches = read_launches(fa, da)
    peak = torch.cuda.max_memory_allocated()
    expected = {name: 0 for name in launches}
    expected.update({"flash_fwd_noncausal": cfg.vision.num_layers,
                     "flash_fwd_causal": cfg.llm.num_layers})
    if launches != expected:
        raise AssertionError(f"report launches {launches} != {expected}")

    tokens = im.generate_tokens(volume, REPORT_QUESTION)
    ids, qids, plen = im._encode_prompt(REPORT_QUESTION)
    if plen != REPORT_PROMPT_LEN:
        raise AssertionError(f"prompt of {plen} tokens, not "
                             f"{REPORT_PROMPT_LEN}")
    ref_fn = make_multimodal_generate_fn(model, im.gen_cfg)
    dev = volume.device
    ids_t, qids_t = (torch.from_numpy(x[None]).to(dev) for x in (ids, qids))
    plen_t = torch.tensor([plen], dtype=torch.int32, device=dev)
    images = volume.float()[None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embeds = ref_fn.embeds(ids_t, images, qids_t)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    kv, tok0, done0, _ = ref_fn.prefill_stage(embeds, plen_t)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    max_new = im.gen_cfg.max_new_tokens
    _, _, rest = ref_fn.decode_steps(kv, tok0, done0, plen_t,
                                     range(max_new - 1))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    stages = {"vision_s": t1 - t0, "prefill_s": t2 - t1, "decode_s": t3 - t2,
              "decode_ms_per_step": 1e3 * (t3 - t2) / max(max_new - 1, 1)}
    ref = torch.cat([tok0[:, None], rest], dim=1)[0]
    if not torch.equal(tokens, ref):
        diff = (tokens != ref).nonzero()[:, 0].tolist()
        raise AssertionError(f"loaded model's tokens differ from the "
                             f"exported model's at steps {diff[:8]}")
    vocab = cfg.llm.vocab_size
    if not (tokens.shape == (max_new,) and ((tokens >= 0)
                                            & (tokens < vocab)).all()):
        raise AssertionError(f"report tokens {tokens.shape} out of range")
    del kv, embeds, ref_fn, model, im
    gc.collect()
    torch.cuda.empty_cache()

    sampled = []
    for _ in range(2):
        sim = U2InferenceModel(ckpt, tokenizer=tok, do_sample=True,
                               top_p=SAMPLE_TOP_P, speculative=False, seed=1,
                               max_new_tokens=REPORT_TOKENS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampled.append(sim.inference(volume, REPORT_QUESTION))
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t0
        del sim
        gc.collect()
    if sampled[0] != sampled[1]:
        raise AssertionError("two sampled reports of one seed differ")
    if sampled[0] == text:
        raise AssertionError("the sampled report is the greedy one")
    return tokens, {"model": "mu2Llama-3.2-1B", "n_params": n_params,
            "weights": "bf16", "cache": "bf16", "question": REPORT_QUESTION,
            "prompt_len": plen, "max_new_tokens": max_new,
            "model_build_s": build_s, "export_s": export_s,
            "checkpoint_gb": ckpt_gb, "load_s": load_s,
            "load_host_gb": host,
            "report_s": report_s, **stages,
            "peak_mem_gb": peak / 1e9, "launches": launches,
            "tokens_equal_exported_model": True,
            "report_words": len(text.split()), "report_head": text[:80],
            "sampled": {"top_p": SAMPLE_TOP_P, "seed": 1,
                        "same_text_two_instances": True,
                        "report_s": sample_s,
                        "words": len(sampled[0].split()),
                        "head": sampled[0][:80]}}


# Speculative decoding phase (``drive_speculative``).
SPEC_BLOCK = 8             # the verify block, as make_spec_generate_fn's
FANOUT = 8                 # samples a case, pred_then_green's protocol
FANOUT_TOKENS = 256        # the fan-out phase's depth (the users' 768 cut)
SCRIPT_SEED = 7            # bench.py's report scripts
# Greedy speculative decoding against plain greedy on the card. A verify
# block's logits come from other GEMM shapes than a single step's, so the
# two bf16 computations of one position may order a near tie differently.
# Tokens must agree up to the first position where they differ; there
# the plain path's top-two gap must lie within TIE_ULPS bf16 ulps (2^-8
# relative) of its top logit, and the speculative token must be the plain
# path's second choice. The rule must reject a planted fault of the
# verify block that changes tokens; three are planted and each is read:
# its logits read one position late (so that acceptance compares draft
# f[j] with g[j] in place of g[j-1]), its RoPE positions shifted by one,
# and its attention cut off from the cache (only the block's own slots).
# A random-weight model's greedy tokens settle on one repeated token,
# which the first two leave as it is until the plain path's first near
# tie, where no rule on tokens can tell them from rounding.
TIE_ULPS = 8


def report_text(tok, tokens, pad: int) -> str:
    """Report text as ``U2InferenceModel.inference`` makes it."""
    skip = (pad, tok.eos_token_id)
    return tok.decode([t for t in tokens.tolist() if t not in skip],
                      skip_special_tokens=True).strip()


@contextlib.contextmanager
def capture_decode_logits(model):
    """Keeps the logits of the latest ``model.decode_step`` call in the
    list it yields."""
    step, seen = model.decode_step, []

    def capture(*args, **kw):
        out = step(*args, **kw)
        seen[:] = [out[0]]
        return out

    model.decode_step = capture
    try:
        yield seen
    finally:
        del model.decode_step


VERIFY_FAULTS = ("late_logits", "rope_plus_one", "no_cache")
FAULT_TOKENS = 192


@contextlib.contextmanager
def planted_verify_fault(torch, model, fault: str):
    """A planted fault of verify blocks (``model.decode_step`` calls of
    more than one token): "late_logits", position j's logits replaced by
    position j + 1's (the last kept); "rope_plus_one", the block's RoPE
    positions shifted by one; "no_cache", the block attending only its own
    slots."""
    step = model.decode_step

    def faulty(embeds, positions, mask, cache, write_index, *args, **kw):
        if positions.shape[1] == 1:
            return step(embeds, positions, mask, cache, write_index, *args,
                        **kw)
        if fault == "rope_plus_one":
            positions = positions + 1
        if fault == "no_cache":
            kv = torch.arange(mask.shape[-1], device=mask.device)
            mask = mask & (kv >= write_index[:, None, None, None])
        logits, hidden, cache = step(embeds, positions, mask, cache,
                                     write_index, *args, **kw)
        if fault == "late_logits":
            logits = logits[:, list(range(1, logits.shape[1])) + [-1]]
        return logits, hidden, cache

    model.decode_step = faulty
    try:
        yield
    finally:
        del model.decode_step


def near_tie(torch, plain_fn, embeds, plen, plain, other,
             seen_logits: dict) -> dict:
    """The near-tie rule (TIE_ULPS) for a B=1 greedy decode ``other``
    against the plain tokens ``plain`` of ``plain_fn`` on the same inputs
    (compared over ``other``'s length): the first index where they
    differ, and there the plain path's logits' top two, their gap and the
    limit. ``seen_logits`` keeps the plain logits by index across
    calls."""
    diff = (plain[:len(other)] != other).nonzero()
    if len(diff) == 0:
        return {"first_diff": None, "holds": True}
    i = int(diff[0, 0])
    if i == 0:  # both take token 0 from one prefill
        return {"first_diff": 0, "holds": False}
    if i not in seen_logits:
        with capture_decode_logits(plain_fn.model) as seen:
            kv, tok0, done0, _ = plain_fn.prefill_stage(embeds, plen)
            plain_fn.decode_steps(kv, tok0, done0, plen, range(i))
        seen_logits[i] = seen[0][0, 0].float()
    top = seen_logits[i].topk(2)
    gap = (top.values[0] - top.values[1]).item()
    limit = TIE_ULPS * 2.0 ** -8 * abs(top.values[0].item())
    second = int(other[i]) == int(top.indices[1])
    return {"first_diff": i, "top2": top.indices.tolist(),
            "gap": gap, "limit": limit,
            "other_token_is_second": second,
            "holds": gap <= limit and second
            and int(plain[i]) == int(top.indices[0])}


def staged_spec(torch, spec_fn, ids, images, qids, plen, generator,
                script=None):
    """A ``SpecMultimodalGenerate`` call by stage, timed (host clock
    around a synchronize): (tokens, verify steps, seconds by stage)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embeds = spec_fn.embeds(ids, images, qids)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state = spec_fn.gen_fn.prefill_stage(embeds, ids, plen, generator)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tokens, steps = spec_fn.gen_fn.decode_loop(**state, generator=generator,
                                               script=script)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return tokens, steps, {"vision_s": t1 - t0, "prefill_s": t2 - t1,
                           "decode_s": t3 - t2, "total_s": t3 - t0,
                           "ms_per_verify_step": 1e3 * (t3 - t2)
                           / max(steps, 1)}


def staged_plain(torch, fn, ids, images, qids, plen, generator=None):
    """A ``MultimodalGenerate`` call by stage, timed: (tokens, seconds by
    stage)."""
    max_new = fn.gen_fn.gen.max_new_tokens
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embeds = fn.embeds(ids, images, qids)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    kv, tok0, done0, _ = fn.prefill_stage(embeds, plen, generator)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _, _, rest = fn.decode_steps(kv, tok0, done0, plen, range(max_new - 1),
                                 generator)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return torch.cat([tok0[:, None], rest], 1), embeds, {
        "vision_s": t1 - t0, "prefill_s": t2 - t1, "decode_s": t3 - t2,
        "total_s": t3 - t0,
        "ms_per_step": 1e3 * (t3 - t2) / max(max_new - 1, 1)}


def spec_report_phase(torch, fa, da, volume, ckpt: str, cfg,
                      plain_greedy) -> dict:
    """μ²Llama-3.2-1B from the exported checkpoint: the default sampled
    report (``U2InferenceModel`` with no ``do_sample`` or ``speculative``:
    top-p 0.9, speculative) with its launches, again from a second
    instance of the seed by stage, the ``speculative=False`` sampled
    report by stage, and greedy speculative against ``plain_greedy`` (the
    report phase's greedy tokens of the same checkpoint) under the
    near-tie rule, which must reject a planted fault (each fault over its
    first FAULT_TOKENS tokens)."""
    from u2tokenizer_torch.eval.inference import U2InferenceModel
    from u2tokenizer_torch.models.generate import make_multimodal_generate_fn
    from u2tokenizer_torch.models.speculative import (
        make_spec_multimodal_generate_fn)

    tok = full_vocab_tokenizer(cfg.llm.vocab_size)
    im = U2InferenceModel(ckpt, tokenizer=tok, device="cuda",
                          max_new_tokens=REPORT_TOKENS)
    gen = im.gen_cfg
    reset_launches(fa, da)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = im.inference(volume, REPORT_QUESTION)
    torch.cuda.synchronize()
    report_s = time.perf_counter() - t0
    launches = read_launches(fa, da)
    expected = {name: 0 for name in launches}
    expected.update({"flash_fwd_noncausal": cfg.vision.num_layers,
                     "flash_fwd_causal": cfg.llm.num_layers})
    if launches != expected:
        raise AssertionError(f"default report launches {launches} != "
                             f"{expected}")
    stats = dict(im.spec_stats)
    if not (gen.do_sample and im._speculative and stats["verify_steps"]):
        raise AssertionError(f"the default report did not sample "
                             f"speculatively: {stats}")
    ids, qids, plen = im._encode_prompt(REPORT_QUESTION)
    dev = volume.device
    ids_t, qids_t = (torch.from_numpy(x[None]).to(dev) for x in (ids, qids))
    plen_t = torch.tensor([plen], dtype=torch.int32, device=dev)
    images = volume.float()[None]
    del im
    gc.collect()

    again = U2InferenceModel(ckpt, tokenizer=tok, device="cuda",
                             max_new_tokens=REPORT_TOKENS)
    tokens, steps, stages = staged_spec(torch, again._gen_fn, ids_t, images,
                                        qids_t, plen_t, again._generator)
    if report_text(tok, tokens[0], gen.pad_token_id) != text \
            or steps != stats["verify_steps"]:
        raise AssertionError("two default reports of one seed differ")
    del again
    gc.collect()

    plain_im = U2InferenceModel(ckpt, tokenizer=tok, speculative=False,
                                device="cuda", max_new_tokens=REPORT_TOKENS)
    _, _, plain_stages = staged_plain(torch, plain_im._gen_fn, ids_t, images,
                                      qids_t, plen_t, plain_im._generator)
    del plain_im
    gc.collect()

    greedy = U2InferenceModel(ckpt, tokenizer=tok, do_sample=False,
                              speculative=True, device="cuda",
                              max_new_tokens=REPORT_TOKENS)
    spec_tokens, spec_steps, spec_greedy = staged_spec(
        torch, greedy._gen_fn, ids_t, images, qids_t, plen_t, None)
    plain_fn = make_multimodal_generate_fn(greedy.model, greedy.gen_cfg)
    embeds = plain_fn.embeds(ids_t, images, qids_t)
    seen_logits = {}
    rule = near_tie(torch, plain_fn, embeds, plen_t, plain_greedy,
                    spec_tokens[0], seen_logits)
    if not rule["holds"]:
        raise AssertionError(f"greedy speculative tokens against plain "
                             f"greedy: {rule}")
    faults = {}
    fault_fn = make_spec_multimodal_generate_fn(
        greedy.model, dataclasses.replace(greedy.gen_cfg,
                                          max_new_tokens=FAULT_TOKENS),
        block_len=SPEC_BLOCK)
    for fault in VERIFY_FAULTS:
        with planted_verify_fault(torch, greedy.model, fault):
            fault_tokens = fault_fn(ids_t, images, qids_t, plen_t)[0]
        faults[fault] = near_tie(torch, plain_fn, embeds, plen_t,
                                 plain_greedy, fault_tokens, seen_logits)
        faults[fault]["changes_tokens"] = not torch.equal(
            fault_tokens, spec_tokens[0, :FAULT_TOKENS])
    rejected = [f for f, r in faults.items()
                if r["changes_tokens"] and not r["holds"]]
    if not rejected:
        raise AssertionError(f"the near-tie rule rejects no planted fault "
                             f"of the verify block: {faults}")
    del greedy, plain_fn, fault_fn, embeds, seen_logits
    gc.collect()
    torch.cuda.empty_cache()
    emitted = stats["emitted_tokens"]
    return {"model": "mu2Llama-3.2-1B", "block_len": SPEC_BLOCK,
            "max_new_tokens": gen.max_new_tokens,
            "default_report": {
                "do_sample": gen.do_sample, "top_p": gen.top_p,
                "speculative": True, "report_s": report_s,
                "verify_steps": stats["verify_steps"],
                "emitted_tokens": emitted,
                "mean_acceptance": emitted / stats["verify_steps"],
                "by_stage": stages, "words": len(text.split()),
                "same_text_two_instances": True, "launches": launches},
            "plain_sampled_report": plain_stages,
            "greedy": {"speculative": spec_greedy, "verify_steps": spec_steps,
                       "first_diff": rule["first_diff"] if rule[
                           "first_diff"] is not None else "none",
                       "near_tie": rule, "tie_ulps": TIE_ULPS,
                       "fault_tokens": FAULT_TOKENS,
                       "planted_faults": faults,
                       "faults_rejected": rejected}}


def spec_forced_content_phase(torch, fa, da, plain_run: dict) -> dict:
    """``bench.py``'s forced-content speculative configuration on the
    card: μ²Qwen3-1.7B, int8 decoder weights, int4 cache, 112 volumes, the
    ViT over groups of 128 chunks, 768 tokens scripted by
    ``report_token_scripts(112, 776, vocab, seed=7)``; the inputs of the
    plain quantized run (``drive_main_path``), whose reports/min are set
    beside. Emitted tokens must equal the script and the verify steps the
    host replay of the loop's drafting (the largest row's)."""
    import numpy as np

    from u2tokenizer_torch.config import GenerationConfig, U2ModelConfig
    from u2tokenizer_torch.data.synthetic_reports import (
        forced_content_replay, ngram_acceptance_estimate,
        report_token_scripts)
    from u2tokenizer_torch.models.quantize import (cast_for_inference,
                                                   quantize_llm_weights)
    from u2tokenizer_torch.models.speculative import (
        make_spec_multimodal_generate_fn)
    from u2tokenizer_torch.models.u2_model import U2CausalLM

    cfg = U2ModelConfig()
    batch, max_new = QUANT_BATCH, MAX_NEW
    model = cast_for_inference(U2CausalLM(cfg, dtype=torch.bfloat16,
                                          device="cuda", seed=0))
    quantize_llm_weights(model, QUANT_WEIGHTS)
    g = torch.Generator(device="cuda").manual_seed(0)  # drive_main_path's
    d, h, w = cfg.vision.input_spatial
    images = torch.randn(batch, cfg.num_chunks, d, h, w, generator=g,
                         device="cuda", dtype=torch.bfloat16)
    vocab = cfg.llm.vocab_size
    input_ids = torch.randint(0, vocab, (batch, PROMPT), generator=g,
                              device="cuda")
    question_ids = torch.randint(0, vocab, (batch, QUESTION), generator=g,
                                 device="cuda")
    prompt_len = torch.tensor([PROMPT] * (batch - 1) + [RAGGED],
                              dtype=torch.int32, device="cuda")
    script = report_token_scripts(batch, max_new + SPEC_BLOCK, vocab,
                                  seed=SCRIPT_SEED)
    gen = GenerationConfig(max_new_tokens=max_new, do_sample=False,
                           eos_token_id=-2, pad_token_id=0)
    fn = make_spec_multimodal_generate_fn(
        model, gen, cache_dtype=QUANT_CACHE, block_len=SPEC_BLOCK,
        vision_microbatch=QUANT_MICROBATCH, return_stats=True,
        forced_content=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fa, da)
    tokens, steps, stages = staged_spec(
        torch, fn, input_ids, images, question_ids, prompt_len, None,
        torch.from_numpy(script).cuda())
    launches = read_launches(fa, da)
    peak = torch.cuda.max_memory_allocated()
    if not torch.equal(tokens.cpu(), torch.from_numpy(script[:, :max_new])
                       .long()):
        raise AssertionError("forced content: emitted tokens differ from "
                             "the script")
    prompt = input_ids.cpu().numpy()
    plen = prompt_len.cpu().numpy()
    replay = forced_content_replay(script[:, :max_new], prompt, plen,
                                   SPEC_BLOCK)
    if steps != int(replay.max()):
        raise AssertionError(f"forced content: {steps} verify steps, the "
                             f"drafter's replay {int(replay.max())}")
    expected = {name: 0 for name in launches}
    expected.update({"flash_fwd_noncausal": 12 * batch * cfg.num_chunks
                     // QUANT_MICROBATCH, "flash_fwd_causal": 28})
    if launches != expected:
        raise AssertionError(f"forced content launches {launches} != "
                             f"{expected}")
    total = stages["total_s"]
    del model, fn, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return {"model": "mu2Qwen3-1.7B", "batch": batch, "weights":
            QUANT_WEIGHTS, "cache": QUANT_CACHE, "block_len": SPEC_BLOCK,
            "max_new_tokens": max_new, "script_seed": SCRIPT_SEED,
            "verify_steps": steps, "replay_steps_max": int(replay.max()),
            "replay_steps_mean": float(replay.mean()),
            "mean_acceptance": (max_new - 1) / steps,
            "ngram_acceptance_estimate": ngram_acceptance_estimate(
                script[:, :max_new], SPEC_BLOCK, prompt=prompt),
            **stages, "reports_per_min": 60.0 * batch / total,
            "plain_reports_per_min": plain_run["reports_per_min"],
            "plain_decode_ms_per_step": plain_run["decode_ms_per_step"],
            "peak_mem_gb": peak / 1e9, "launches": launches,
            "tokens_equal_script": True}


def spec_fanout_phase(torch, fa, da, volume, ckpt: str, cfg) -> dict:
    """One case x FANOUT sampled samples of μ²Llama (the pred_then_green
    protocol), FANOUT_TOKENS tokens each:
    ``make_spec_multimodal_generate_fn(fanout=8)`` and plain
    ``make_fanout_multimodal_generate_fn``, timed; each causal K2 call
    must run at the case batch, 1."""
    from u2tokenizer_torch.eval.inference import U2InferenceModel
    from u2tokenizer_torch.models.generate import (
        make_fanout_multimodal_generate_fn)
    from u2tokenizer_torch.models.speculative import (
        make_spec_multimodal_generate_fn)

    tok = full_vocab_tokenizer(cfg.llm.vocab_size)
    im = U2InferenceModel(ckpt, tokenizer=tok, device="cuda")
    gen = dataclasses.replace(im.gen_cfg, max_new_tokens=FANOUT_TOKENS)
    ids, qids, plen = im._encode_prompt(REPORT_QUESTION)
    dev = volume.device
    ids_t, qids_t = (torch.from_numpy(x[None]).to(dev) for x in (ids, qids))
    plen_t = torch.tensor([plen], dtype=torch.int32, device=dev)
    images = volume.float()[None]
    k2_batches = []
    launch = fa._flash_cuda

    def spy(q, k, v, lens, causal, scale):
        if causal:
            k2_batches.append(q.shape[0])
        return launch(q, k, v, lens, causal, scale)

    spec_fn = make_spec_multimodal_generate_fn(
        im.model, gen, block_len=SPEC_BLOCK, return_stats=True,
        fanout=FANOUT)
    plain_fn = make_fanout_multimodal_generate_fn(im.model, gen, FANOUT)
    g = torch.Generator(device="cuda").manual_seed(3)
    reset_launches(fa, da)
    fa._flash_cuda = spy
    try:
        tokens, steps, stages = staged_spec(torch, spec_fn, ids_t, images,
                                            qids_t, plen_t, g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = plain_fn(ids_t, images, qids_t, plen_t, g)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        fa._flash_cuda = launch
    launches = read_launches(fa, da)
    if k2_batches != [1] * (2 * cfg.llm.num_layers):
        raise AssertionError(f"fan-out prefill K2 batches {k2_batches}")
    expected = {name: 0 for name in launches}
    expected.update({"flash_fwd_noncausal": 2 * cfg.vision.num_layers,
                     "flash_fwd_causal": 2 * cfg.llm.num_layers})
    if launches != expected:
        raise AssertionError(f"fan-out launches {launches} != {expected}")
    for t in (tokens, plain):
        if t.shape != (FANOUT, gen.max_new_tokens) or not (
                (t >= 0) & (t < cfg.llm.vocab_size)).all():
            raise AssertionError(f"fan-out tokens {tuple(t.shape)}")
    max_new = gen.max_new_tokens
    del im, spec_fn, plain_fn
    gc.collect()
    torch.cuda.empty_cache()
    return {"model": "mu2Llama-3.2-1B", "cases": 1, "samples": FANOUT,
            "top_p": gen.top_p, "max_new_tokens": max_new,
            "speculative": {**stages, "verify_steps": steps},
            "plain": {"total_s": plain_s,
                      "ms_per_step": 1e3 * plain_s / max(max_new - 1, 1)},
            "k2_batches": sorted(set(k2_batches)), "launches": launches,
            "distinct_samples": len({tuple(r) for r in plain.tolist()})}


def drive_speculative(torch, fa, da, volume, tmp: str, plain_greedy,
                      plain_run: dict, card: str) -> dict:
    """The speculative phase: the default sampled report, greedy
    speculative against the report phase's plain greedy tokens
    ``plain_greedy`` (μ²Llama-3.2-1B from the report phase's checkpoint
    in ``tmp``), fan-out 1 x 8, and ``bench.py``'s forced-content
    speculative configuration at B=112 beside ``plain_run`` (the plain
    quantized serving run); one printed line each. Returns the launches
    of each path."""
    cfg = released_config()
    ckpt = os.path.join(tmp, "mu2llama")
    out = {}
    for name, run in (
            ("spec_report", lambda: spec_report_phase(
                torch, fa, da, volume, ckpt, cfg, plain_greedy)),
            ("spec_fanout", lambda: spec_fanout_phase(torch, fa, da, volume,
                                                      ckpt, cfg)),
            ("spec_forced_content", lambda: spec_forced_content_phase(
                torch, fa, da, plain_run))):
        line = run()
        line["card"] = card
        print(json.dumps({name: line}), flush=True)
        out[name] = (line["default_report"]["launches"]
                     if name == "spec_report" else line["launches"])
    return out


# Serving phase (``drive_serving``): the slot engine and the HTTP server
# at the released μ²Llama-3.2-1B configuration, as ``cli serve --slots 8``
# builds them, with concurrent requests.
SERVING_SLOTS = 8
SERVING_TOKENS = 256       # cli serve --max-new-tokens
SUBPROCESS_TOKENS = 16     # the subprocess server's one report
LLM_TOKENS = 128           # serve-llm's requests
LOGIT_STEPS = 8            # decode steps whose logits are held to B=1's
LOGIT_TOL = 5e-2           # the reduced-depth check's relative limit
# twelve questions, so that twelve requests over eight slots force
# admissions while other slots decode; the first is also streamed
SERVING_QUESTIONS = (
    REPORT_QUESTION, "Is there a pleural effusion ?",
    "Describe the liver and the spleen .",
    "Are there any pulmonary nodules ?",
    "What is the impression of this scan ?",
    "Describe the mediastinum and the heart .",
    "Is there evidence of consolidation in the lungs ?",
    "Describe the bones of the thorax .", "Are the kidneys normal ?",
    "Summarize the abnormal findings .", "Is there lymphadenopathy ?",
    "Describe the airways and the trachea .")
LLM_PROMPTS = ("Rewrite the report : the lungs are clear .",
               "Summarize : no acute findings in the chest .")
# planted faults of the slot path (``planted_slot_fault``), one at least of
# which the logits limit or the near-tie rule must reject. On random
# weights a decode step attends nearly evenly over its ~265 visible keys,
# so a write one slot late (the step misses its own key and sees a zeroed
# one) or RoPE shifted by one moves the logits by about one key's share,
# under LOGIT_TOL, and leaves the first tokens as they are; a prefill
# written into another slot's row is seen at once.
SLOT_FAULTS = ("write_index_late", "rope_plus_one", "prefill_wrong_slot")


def serving_tokenizer(vocab: int):
    """A MockTokenizer with every word the serving phase sends first, then
    a word for every other id of the vocabulary."""
    from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer

    tok = MockTokenizer()
    tok(" ".join(SERVING_QUESTIONS + LLM_PROMPTS))
    tok(" ".join(f"w{i}" for i in range(vocab - len(tok.vocab))))
    return tok


@contextlib.contextmanager
def top_two(torch, model):
    """The top two logits (values, ids) of the last position of every
    ``model.decode_step`` call in the block, kept on the device until the
    block ends; yields a dict filled then with "values" and "ids" (steps,
    2) of row 0."""
    step, seen, out = model.decode_step, [], {}

    def capture(*args, **kw):
        res = step(*args, **kw)
        seen.append(res[0][0, -1].float().topk(2))
        return res

    model.decode_step = capture
    try:
        yield out
    finally:
        del model.decode_step
        out["values"] = torch.stack([t.values for t in seen]).cpu()
        out["ids"] = torch.stack([t.indices for t in seen]).cpu()


def tie_verdict(ref, other, top: dict, eos: int) -> dict:
    """The near-tie rule (TIE_ULPS, as ``near_tie``) for a token list
    ``other`` (a request's emitted tokens, EOS included) against the B=1
    greedy tokens ``ref`` of the same prompt, with ``top`` the top two
    logits of each of ``ref``'s decode steps (step i - 1 gives token i).
    ``other`` must also end where ``ref`` does: at EOS or the budget."""
    n = min(len(ref), len(other))
    i = next((j for j in range(n) if ref[j] != other[j]), None)
    if i is None:
        ended = len(other) == len(ref) or (other and other[-1] == eos)
        return {"first_diff": None, "holds": bool(ended)}
    if i == 0:  # both take token 0 from one prefill
        return {"first_diff": 0, "holds": False}
    v0, v1 = top["values"][i - 1].tolist()
    i0, i1 = top["ids"][i - 1].tolist()
    gap, limit = v0 - v1, TIE_ULPS * 2.0 ** -8 * abs(v0)
    return {"first_diff": i, "top2": [i0, i1], "gap": gap, "limit": limit,
            "other_token_is_second": other[i] == i1,
            "holds": gap <= limit and other[i] == i1 and ref[i] == i0}


def serve_args(ckpt: str, *extra):
    """``cli serve``'s arguments for the report checkpoint."""
    from u2tokenizer_torch import cli

    return cli.build_parser().parse_args(
        ["serve", "--checkpoint", ckpt, "--max-new-tokens",
         str(SERVING_TOKENS), "--host", "127.0.0.1", "--port", "0", *extra])


def http(url: str, payload=None, data=None, headers=None, timeout=300):
    """(status, body bytes) of a GET, or a POST of ``payload`` as JSON or
    of raw ``data``; an HTTP error's status is returned, not raised."""
    import urllib.error
    import urllib.request

    if payload is not None:
        data = json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"}
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def http_ok(url: str, payload=None, **kw) -> dict:
    """The JSON reply of a request that must answer 200."""
    status, body = http(url, payload, **kw)
    if status != 200:
        raise AssertionError(f"{url}: HTTP {status} {body[:300]!r}")
    return json.loads(body)


def sse_deltas(url: str, payload: dict, key):
    """The deltas of a streamed reply (``key(event)`` each): 200, every
    event a ``data:`` line, no error event, ``[DONE]`` last."""
    status, body = http(url, dict(payload, stream=True))
    lines = [ln for ln in body.decode().splitlines() if ln]
    if status != 200 or not lines or lines[-1] != "data: [DONE]" or not all(
            ln.startswith("data: ") for ln in lines):
        raise AssertionError(f"{url}: stream HTTP {status} {body[:300]!r}")
    events = [json.loads(ln[len("data: "):]) for ln in lines[:-1]]
    errors = [e for e in events if "error" in e]
    if errors:
        raise AssertionError(f"{url}: error event {errors[0]}")
    return [key(e) for e in events]


def instrument(inf):
    """Records, for an ``EngineInference``: each caller's question and the
    tokens its request emitted (``rec["tokens"]()``: question -> tokens),
    each engine tick's kind ("admit" or "decode"), seconds and block
    size, and each submit's seconds (ids, ViT and splice, as
    launched)."""
    import threading

    rec = {"raw": {}, "question": {}, "ticks": [], "submit_s": []}
    rec["tokens"] = lambda: {rec["question"][local]: toks
                             for local, toks in rec["raw"].items()}
    lock = threading.Lock()
    submit_local, engine = inf._submit_local, inf.engine
    step, submit = engine.step, engine.submit

    def local_spy(image, q, stream):
        local = submit_local(image, q, stream)
        with lock:
            rec["question"][local] = q
        return local

    class Results(dict):
        def __setitem__(self, local, toks):
            rec["raw"][local] = list(toks)
            super().__setitem__(local, toks)

    def step_spy():
        admit = bool(engine._queue) and len(engine._by_slot) < \
            engine.num_slots
        kb = engine.spec_block_len
        t0 = time.perf_counter()
        out = step()
        rec["ticks"].append(("admit" if admit else "decode",
                             time.perf_counter() - t0, kb))
        return out

    def submit_spy(*args):
        t0 = time.perf_counter()
        out = submit(*args)
        rec["submit_s"].append(time.perf_counter() - t0)
        return out

    inf._submit_local, inf._results = local_spy, Results()
    engine.step, engine.submit = step_spy, submit_spy
    return rec


def tick_readings(rec: dict) -> dict:
    """Median ms of decode dispatches and of admissions, their counts."""
    by = {kind: [1e3 * dt for k, dt, _ in rec["ticks"] if k == kind]
          for kind in ("admit", "decode")}
    return {"ms_per_dispatch": statistics.median(by["decode"]),
            "dispatches": len(by["decode"]),
            "ms_per_admission": statistics.median(by["admit"]),
            "admissions": len(by["admit"]),
            "ms_per_submit": 1e3 * statistics.median(rec["submit_s"])}


def fire(calls) -> tuple:
    """Run the callables at once, one thread each; returns their results
    (an exception is raised here) and each one's (start, end) on the host
    clock."""
    import threading

    n = len(calls)
    results, spans, errors = [None] * n, [None] * n, []
    gate = threading.Barrier(n)

    def run(i):
        gate.wait()
        t0 = time.perf_counter()
        try:
            results[i] = calls[i]()
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)
        spans[i] = (t0, time.perf_counter())

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results, spans


def span_readings(spans) -> dict:
    """Wall clock from the first start to the last end, reports/min over
    it, and the latency of each request (median, max)."""
    wall = max(e for _, e in spans) - min(s for s, _ in spans)
    latency = [e - s for s, e in spans]
    return {"wall_s": wall, "reports_per_min": 60.0 * len(spans) / wall,
            "latency_s_median": statistics.median(latency),
            "latency_s_max": max(latency)}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_subprocess_check(ckpt: str, ct_path: str, log_path: str) -> dict:
    """``python -m u2tokenizer_torch.cli serve --slots 8`` as a process of
    its own (the mock tokenizer): it must answer /health and one
    /v1/report of SUBPROCESS_TOKENS tokens on the CT file; then it is
    stopped."""
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    cmd = [sys.executable, "-m", "u2tokenizer_torch.cli", "serve",
           "--checkpoint", ckpt, "--slots", str(SERVING_SLOTS),
           "--max-new-tokens", str(SUBPROCESS_TOKENS), "--host",
           "127.0.0.1", "--port", str(port)]
    t0 = time.perf_counter()
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(cmd, stdout=log_file,
                                stderr=subprocess.STDOUT,
                                cwd=os.path.dirname(os.path.abspath(
                                    __file__)))
        try:
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"cli serve exited with "
                                         f"{proc.returncode}")
                if time.perf_counter() - t0 > 300:
                    raise AssertionError("cli serve: no /health in 300 s")
                try:
                    if http(url + "/health", timeout=5)[0] == 200:
                        break
                except OSError:
                    pass
                time.sleep(0.5)
            up_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            out = http_ok(url + "/v1/report", {"image_path": ct_path,
                                               "question": REPORT_QUESTION},
                          timeout=120)
            report_s = time.perf_counter() - t1
        except Exception:
            proc.kill()
            proc.wait()
            with open(log_path) as f:
                log(f.read()[-3000:])
            raise
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    words = len(out["report"].split())
    if not 0 < words <= SUBPROCESS_TOKENS:
        raise AssertionError(f"cli serve: a report of {words} words")
    return {"command": " ".join(["python", "-m"] + cmd[2:]),
            "start_to_health_s": up_s, "report_s": report_s,
            "report_words": words, "latency_s": out["latency_s"]}


@contextlib.contextmanager
def planted_slot_fault(torch, model, fault: str):
    """A planted fault of the slot path: "write_index_late", the slot
    decode's per-row write one slot late; "rope_plus_one", its RoPE
    positions shifted by one; "prefill_wrong_slot", each admission's
    prefill written into the next slot's row."""
    from u2tokenizer_torch.models import slot_serving

    step, row_view = model.decode_step, slot_serving._row_view

    def faulty(embeds, positions, mask, cache, write_index, *args, **kw):
        slot_step = (torch.is_tensor(write_index) and write_index.dim() == 1
                     and positions.shape[1] == 1)
        if slot_step and fault == "write_index_late":  # kept in bounds
            write_index = (write_index + 1).clamp_max(cache.max_len - 1)
        if slot_step and fault == "rope_plus_one":
            positions = positions + 1
        return step(embeds, positions, mask, cache, write_index, *args,
                    **kw)

    if fault == "prefill_wrong_slot":
        slot_serving._row_view = lambda cache, slot: row_view(
            cache, (slot + 1) % cache.k[0].shape[0])
    else:
        model.decode_step = faulty
    try:
        yield
    finally:
        slot_serving._row_view = row_view
        model.__dict__.pop("decode_step", None)


def request_inputs(torch, im, question: str, volume):
    """A request's (ids (1, prompt_len), images, question ids) as the slot
    engine takes them, and the padded (ids, images, question ids,
    prompt_len) of ``im``'s B=1 path."""
    ids, qids, plen = im._encode_prompt(question)
    dev = volume.device
    qids_t = torch.from_numpy(qids[None]).to(dev)
    images = volume.float()[None]
    return (ids[None, :plen], images, qids_t), (
        torch.from_numpy(ids[None]).to(dev), images, qids_t,
        torch.tensor([plen], dtype=torch.int32, device=dev))


def plain_logits(torch, im, question: str, volume) -> tuple:
    """The B=1 plain greedy decode of ``question`` through ``im``: the
    fp32 logits of its first LOGIT_STEPS decode steps (steps, V) and its
    first 1 + LOGIT_STEPS tokens."""
    model, fn = im.model, im._gen_fn
    args = request_inputs(torch, im, question, volume)[1]
    step, seen = model.decode_step, []

    def keep(*a, **kw):
        res = step(*a, **kw)
        seen.append(res[0][0, 0].float())
        return res

    embeds = fn.embeds(*args[:3])
    model.decode_step = keep
    try:
        kv, tok0, done0, _ = fn.prefill_stage(embeds, args[3])
        _, _, rest = fn.decode_steps(kv, tok0, done0, args[3],
                                     range(LOGIT_STEPS))
    finally:
        del model.decode_step
    return torch.stack(seen), torch.cat([tok0, rest[0]]).tolist()


def slot_logits_check(torch, im, volume, plain: list, fault=None) -> dict:
    """Two requests on an 8-slot engine over ``im``'s model, the second
    admitted after the first's third decode step: the logits of each
    one's first LOGIT_STEPS decode steps against ``plain`` (``plain_logits``
    of the same questions; relative to its largest), as far as their
    tokens agree, and their first tokens under the near-tie rule. With
    ``fault`` the slot path carries a planted fault
    (``planted_slot_fault``)."""
    from u2tokenizer_torch.models.slot_serving import Engine

    model, gen = im.model, im.gen_cfg
    eng = Engine(model, gen, num_slots=SERVING_SLOTS,
                 prompt_buf=im.max_length)
    reqs = [request_inputs(torch, im, q, volume)[0]
            for q in SERVING_QUESTIONS[:2]]
    rows = []
    with (planted_slot_fault(torch, model, fault) if fault
          else contextlib.nullcontext()):
        step = model.decode_step

        def capture(embeds, positions, mask, cache, write_index, *a, **kw):
            res = step(embeds, positions, mask, cache, write_index, *a,
                       **kw)
            if torch.is_tensor(write_index) and positions.shape[1] == 1:
                rows.append(res[0][:2, 0].float())
            return res

        model.decode_step = capture
        live = []
        try:
            for req, ticks in ((reqs[0], 4), (reqs[1], 1 + LOGIT_STEPS)):
                eng.submit(*req)
                live.append(eng._queue[-1])
                for _ in range(ticks):  # its admission, then decode steps
                    eng.step()
        finally:
            model.__dict__.pop("decode_step", None)
    got = [torch.stack([r[0] for r in rows[:LOGIT_STEPS]]),
           torch.stack([r[1] for r in rows[3:3 + LOGIT_STEPS]])]
    tokens = [req.tokens[:1 + LOGIT_STEPS] for req in live]
    del eng
    err, steps, verdicts = 0.0, 0, []
    for (ref, ref_toks), g, toks in zip(plain, got, tokens):
        # the steps whose inputs agree (step k reads token k) while the
        # request is live
        n = next((k for k in range(len(toks) - 1)
                  if toks[k] != ref_toks[k]), len(toks) - 1)
        if n:
            err = max(err, ((g[:n] - ref[:n]).abs().max()
                            / ref[:n].abs().max()).item())
        steps += n
        top = ref.topk(2)
        verdicts.append(tie_verdict(
            ref_toks[:len(toks)], toks, {"values": top.values.cpu(),
                             "ids": top.indices.cpu()}, gen.eos_token_id))
    holds = err <= LOGIT_TOL and all(v["holds"] for v in verdicts)
    return {"fault": fault, "logits_rel_err": err, "steps_compared": steps,
            "tol": LOGIT_TOL, "tokens": verdicts, "holds": holds}


def profile_slots(torch, im, volume) -> dict:
    """torch.profiler over 8 decode dispatches of an 8-slot engine with
    every slot busy (after 8 admissions and 2 unprofiled dispatches): the
    card's busy share, kernels a dispatch, the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from u2tokenizer_torch.models.slot_serving import Engine

    eng = Engine(im.model, im.gen_cfg, num_slots=SERVING_SLOTS,
                 prompt_buf=im.max_length)
    for q in SERVING_QUESTIONS[:SERVING_SLOTS]:
        eng.submit(*request_inputs(torch, im, q, volume)[0])
    while eng._queue:
        eng.step()
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    if len(eng._by_slot) != SERVING_SLOTS:
        raise AssertionError("profiled dispatches with idle slots")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            eng.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels, by_name = device_time(torch, prof)
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"dispatches": 8, "wall_ms_per_dispatch": wall_us / 8e3,
            "device_ms_per_dispatch": busy_us / 8e3,
            "device_busy_share": busy_us / wall_us,
            "kernels_per_dispatch": len(kernels) / 8,
            "top_device_ms_per_dispatch": {n: t / 8e3 for n, t in top}}


def sequential_references(torch, im, volume) -> tuple:
    """The twelve questions one at a time through ``im`` (``cli serve``'s
    single-request ``U2InferenceModel``, greedy), timed: each one's
    tokens and the top two logits of each decode step."""
    refs = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for q in SERVING_QUESTIONS:
        with top_two(torch, im.model) as top:
            tokens = im.generate_tokens(volume, q).tolist()
        refs[q] = (tokens, top)
    torch.cuda.synchronize()
    return refs, time.perf_counter() - t0


def verdicts_against(refs: dict, tokens: dict, eos: int) -> dict:
    """The near-tie rule for each question's emitted tokens; raises when
    one fails or a question has no tokens."""
    out = {}
    for q, (ref, top) in refs.items():
        if q not in tokens:
            raise AssertionError(f"no tokens recorded for {q!r}")
        out[q] = tie_verdict(ref, tokens[q], top, eos)
        if not out[q]["holds"]:
            raise AssertionError(f"{q!r}: slot tokens fail the near-tie "
                                 f"rule against B=1: {out[q]}")
    return out


def concurrent_http_phase(torch, fa, da, single, ckpt, ct_path, volume, tok,
                          refs) -> tuple:
    """``cli serve --slots 8`` built by ``cli.build_served_model`` and
    started by ``serve_background``: the CT uploaded (ingest on the
    card), then the twelve questions from twelve client threads at once
    with the first also streamed, telemetry polled meanwhile. Returns the
    result line and the launches of the traffic."""
    import threading

    from u2tokenizer_torch import cli
    from u2tokenizer_torch.serve import encode_gray_png, serve_background

    served = cli.build_served_model(
        serve_args(ckpt, "--slots", str(SERVING_SLOTS)), tokenizer=tok)
    rec = instrument(served)
    httpd = serve_background(served, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        if http_ok(url + "/health") != {"status": "ok"}:
            raise AssertionError("/health")
        with open(ct_path, "rb") as f:
            data = f.read()
        t0 = time.perf_counter()
        info = http_ok(url + "/v1/upload", data=data, headers={
            "Content-Type": "application/octet-stream",
            "X-Filename": os.path.basename(ct_path)})
        upload_s = time.perf_counter() - t0
        if [info[k] for k in ("chunks", "depth", "height", "width")] != \
                list(volume.shape):
            raise AssertionError(f"upload: {info}")
        chunk = volume.shape[0] // 2
        status, png = http(f"{url}/v1/volume/{info['volume_id']}/slice/"
                           f"{chunk * volume.shape[1]}")
        if status != 200 or png[:8] != b"\x89PNG\r\n\x1a\n":
            raise AssertionError(f"slice: HTTP {status}")
        same_slice = png == encode_gray_png(volume[chunk, 0])

        polls, stop = [], threading.Event()

        def poll():
            while not stop.wait(0.25):
                polls.append(http_ok(url + "/v1/config")["engine"])

        poller = threading.Thread(target=poll)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(fa, da)
        poller.start()
        ask = lambda q: (lambda: http_ok(url + "/v1/report", {
            "volume_id": info["volume_id"], "question": q}))
        stream = lambda: sse_deltas(url + "/v1/report", {
            "volume_id": info["volume_id"],
            "question": SERVING_QUESTIONS[0]}, lambda e: e["report_delta"])
        replies, spans = fire([ask(q) for q in SERVING_QUESTIONS]
                              + [stream])
        stop.set()
        poller.join()
        launches = read_launches(fa, da)
        peak = torch.cuda.max_memory_allocated()
        config = http_ok(url + "/v1/config")
    finally:
        httpd.shutdown()
        served.close()
    n = len(SERVING_QUESTIONS) + 1  # the streamed request too
    expected = {name: 0 for name in launches}
    expected.update({"flash_fwd_noncausal": single.cfg.vision.num_layers * n,
                     "flash_fwd_causal": single.cfg.llm.num_layers * n})
    if launches != expected:
        raise AssertionError(f"serving launches {launches} != {expected}")
    texts = {q: r["report"] for q, r in zip(SERVING_QUESTIONS, replies)}
    streamed = "".join(replies[-1])
    if streamed.strip() != texts[SERVING_QUESTIONS[0]]:
        raise AssertionError("the streamed report differs from the blocking "
                             "one of the same question")
    eos = single.gen_cfg.eos_token_id
    tokens = rec["tokens"]()
    verdicts = verdicts_against(refs, tokens, eos)
    for q, text in texts.items():
        if text != report_text(tok, torch.tensor(tokens[q]), 0):
            raise AssertionError(f"{q!r}: reply text is not its tokens'")
    emitted = sum(len(t) for t in tokens.values())
    engine = config["engine"]
    if engine["completed_requests"] != n or engine["active_slots"] != 0:
        raise AssertionError(f"telemetry after the traffic: {engine}")
    rates = [p["tokens_per_s"] for p in polls if p["tokens_per_s"] > 0]
    # the twelve blocking requests: wall clock from the first send to the
    # last reply (the streamed one runs beside them)
    return {"requests": len(SERVING_QUESTIONS), "streamed": 1,
            "slots": SERVING_SLOTS, "max_new_tokens": SERVING_TOKENS,
            "upload_mb": len(data) / 1e6, "upload_ingest_s": upload_s,
            "slice_png_equals_ingest": same_slice,
            **span_readings(spans[:-1]),
            "stream_deltas": len(replies[-1]),
            "telemetry_tokens_per_s_median": (statistics.median(rates)
                                              if rates else None),
            "telemetry_tokens_per_s_max": max(rates) if rates else None,
            "emitted_tokens": emitted, **tick_readings(rec),
            "peak_mem_gb": peak / 1e9, "launches": launches,
            "tie_rule": {q[:24]: v["first_diff"]
                         for q, v in verdicts.items()}}, launches, tokens


def spec_slot_phase(torch, ckpt, volume, tok, refs, plain_tokens) -> dict:
    """``cli serve --slots 8 --speculative auto``: the twelve questions
    from twelve threads through ``EngineInference.inference``; tokens
    under the near-tie rule against B=1, and beside the plain slot
    engine's; acceptance, the rungs visited, ms a dispatch."""
    from u2tokenizer_torch import cli

    inf = cli.build_served_model(
        serve_args(ckpt, "--slots", str(SERVING_SLOTS), "--speculative",
                   "auto"), tokenizer=tok)
    try:
        if not (inf.engine.adaptive and inf.speculative):
            raise AssertionError("--speculative auto built no adaptive "
                                 "engine")
        rec = instrument(inf)
        _, spans = fire([(lambda q=q: inf.inference(volume, q))
                         for q in SERVING_QUESTIONS])
        stats = dict(inf.spec_stats)
    finally:
        inf.close()
    tokens = rec["tokens"]()
    verdicts = verdicts_against(refs, tokens, inf.gen_cfg.eos_token_id)
    rungs = sorted({kb for kind, _, kb in rec["ticks"] if kind == "decode"})
    return {"speculative": "auto", "requests": len(SERVING_QUESTIONS),
            "acceptance": stats["emitted_tokens"]
            / max(stats["verify_steps"], 1), **stats,
            "rungs_visited": rungs, **span_readings(spans),
            **tick_readings(rec),
            "tokens_equal_plain_slot_engine": sum(
                tokens[q] == plain_tokens[q] for q in refs),
            "tie_rule": {q[:24]: v["first_diff"]
                         for q, v in verdicts.items()}}


def serve_llm_phase(torch, fa, da) -> tuple:
    """``cli serve-llm --preset llama_3_2_1b`` (seeded weights, bf16)
    built by ``cli.build_llm_server`` and served as ``cmd_serve_llm``
    serves it, on a thread (``serve_background``): one greedy
    chat completion (speculative by default) whose tokens are held to the
    plain greedy decode's under the near-tie rule, one completion, and a
    sampled server's n=8 chat completion (fan-out); LLM_TOKENS tokens
    each. Returns the result line and the launches of the requests."""
    from u2tokenizer_torch import cli
    from u2tokenizer_torch.config import LLMConfig
    from u2tokenizer_torch.models.generate import make_generate_fn
    from u2tokenizer_torch.serve import TextLMServer, serve_background

    tok = serving_tokenizer(LLMConfig.llama_3_2_1b().vocab_size)
    args = cli.build_parser().parse_args(
        ["serve-llm", "--preset", "llama_3_2_1b", "--max-new-tokens",
         str(LLM_TOKENS), "--host", "127.0.0.1", "--port", "0"])
    t0 = time.perf_counter()
    lm = cli.build_llm_server(args, tokenizer=tok)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sampled = TextLMServer(lm.model, tok, max_new_tokens=LLM_TOKENS,
                           do_sample=True, top_p=SAMPLE_TOP_P,
                           name="llama_3_2_1b-sampled", device=lm.device)
    raw = []
    spec_gen = lm._gen

    def keep(*a, **kw):
        out = spec_gen(*a, **kw)
        raw.append(out[0][0].tolist())
        return out

    lm._gen = keep
    # what cmd_serve_llm serves, on a thread
    servers = [serve_background(m, port=0, transform=False)
               for m in (lm, sampled)]
    url, url_s = (f"http://127.0.0.1:{s.server_address[1]}"
                  for s in servers)
    times = {}
    try:
        reset_launches(fa, da)
        chat = {"messages": [{"role": "user", "content": LLM_PROMPTS[0]}]}
        for name, target, payload in (
                ("chat", url + "/v1/chat/completions", chat),
                ("completion", url + "/v1/completions",
                 {"prompt": LLM_PROMPTS[1]}),
                ("fanout_n8", url_s + "/v1/chat/completions",
                 dict(chat, n=FANOUT))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = http_ok(target, payload)
            times[name] = time.perf_counter() - t0
            if name == "fanout_n8":
                choices = [c["message"]["content"] for c in out["choices"]]
            elif name == "chat":
                chat_text = out["choices"][0]["message"]["content"]
        launches = read_launches(fa, da)
        config = http_ok(url + "/v1/config")
    finally:
        for s in servers:
            s.shutdown()
    expected = {name: 0 for name in launches}
    expected["flash_fwd_causal"] = 3 * lm.model.cfg.num_layers
    if launches != expected:
        raise AssertionError(f"serve-llm launches {launches} != {expected}")
    if len(choices) != FANOUT or not all(isinstance(c, str)
                                         for c in choices):
        raise AssertionError(f"fan-out: {len(choices)} choices")
    # the plain greedy decode of the chat prompt, with its top two logits
    plain = make_generate_fn(lm.model, lm.gen_cfg)
    arr, n_ids = lm._encode_prompt(LLM_PROMPTS[0])
    ids = torch.from_numpy(arr).to(lm.device)
    with torch.inference_mode(), top_two(torch, lm.model) as top:
        ref = plain(lm.model.embed_tokens(ids),
                    torch.tensor([n_ids], dtype=torch.int32,
                                 device=lm.device))[0].tolist()
    eos = lm.gen_cfg.eos_token_id
    other = raw[0]
    if eos in other:
        other = other[:other.index(eos) + 1]
    verdict = tie_verdict(ref, other, top, eos)
    if not verdict["holds"]:
        raise AssertionError(f"serve-llm: speculative greedy chat fails the "
                             f"near-tie rule: {verdict}")
    if chat_text != lm._decode_row(raw[0]):
        raise AssertionError("serve-llm: chat text is not its tokens'")
    stats = config.get("spec_stats", {})
    del lm, sampled, plain
    return {"preset": "llama_3_2_1b", "weights": "bf16",
            "max_new_tokens": LLM_TOKENS, "max_length": 2048,
            "build_s": build_s, "request_s": times,
            "spec_stats": stats, "tie_rule": verdict["first_diff"],
            "fanout_choices": len(choices),
            "fanout_distinct": len(set(choices)),
            "launches": launches}, launches


def drive_serving(torch, fa, da, volume, tmp: str, card: str) -> dict:
    """The serving phase at μ²Llama-3.2-1B from the report phase's
    checkpoint (``tmp/mu2llama``) and CT (``tmp/ct.nii``, ``volume`` its
    ingest): ``cli serve`` as a subprocess; the twelve questions one at a
    time (``cli serve``'s single-request model; the reference tokens);
    concurrent over HTTP on 8 slots; the slot decode's logits against
    B=1 with planted faults; a profile of 8 busy dispatches; the
    adaptive speculative slot engine; ``serve-llm``. One printed line
    each; returns the launches of the HTTP traffic of each server."""
    from u2tokenizer_torch import cli

    cfg = released_config()
    ckpt = os.path.join(tmp, "mu2llama")
    ct_path = os.path.join(tmp, "ct.nii")
    line = cli_subprocess_check(ckpt, ct_path,
                                os.path.join(tmp, "cli_serve.log"))
    print(json.dumps({"serving_cli_process": line, "card": card}),
          flush=True)

    tok = serving_tokenizer(cfg.llm.vocab_size)
    single = cli.build_served_model(serve_args(ckpt), tokenizer=tok)
    refs, seq_s = sequential_references(torch, single, volume)
    counts = {}
    http_line, counts["serving_http"], plain_tokens = concurrent_http_phase(
        torch, fa, da, single, ckpt, ct_path, volume, tok, refs)
    http_line["sequential"] = {
        "wall_s": seq_s,
        "reports_per_min": 60.0 * len(SERVING_QUESTIONS) / seq_s,
        "s_per_report": seq_s / len(SERVING_QUESTIONS)}
    http_line["speedup_over_sequential"] = (
        http_line["reports_per_min"]
        / http_line["sequential"]["reports_per_min"])
    http_line["card"] = card
    print(json.dumps({"serving_http": http_line}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    plain = [plain_logits(torch, single, q, volume)
             for q in SERVING_QUESTIONS[:2]]
    sound = slot_logits_check(torch, single, volume, plain)
    if not sound["holds"]:
        raise AssertionError(f"slot decode against B=1: {sound}")
    faults = {}
    for fault in SLOT_FAULTS:
        faults[fault] = slot_logits_check(torch, single, volume, plain,
                                          fault)
        gc.collect()
    rejected = [f for f, r in faults.items() if not r["holds"]]
    if not rejected:
        raise AssertionError("no planted fault of the slot path is rejected")
    print(json.dumps({"serving_slot_logits": {
        "sound": sound, "faults": faults, "rejected": rejected},
        "card": card}), flush=True)
    print(json.dumps({"serving_profile": profile_slots(torch, single,
                                                       volume),
                      "card": card}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    spec = spec_slot_phase(torch, ckpt, volume, tok, refs, plain_tokens)
    spec["card"] = card
    print(json.dumps({"serving_speculative": spec}), flush=True)
    del single, refs
    gc.collect()
    torch.cuda.empty_cache()

    llm, counts["serve_llm"] = serve_llm_phase(torch, fa, da)
    llm["card"] = card
    print(json.dumps({"serving_llm": llm}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def nucleus_readings(torch, row, draws: int, generator):
    """``draws`` draws of ``nucleus_sample`` from one fixed row on its
    device, SAMPLE_ROWS at a time, against the exact renormalised nucleus
    (float64 on the host): Pearson's chi-square and its bound df + 6
    sqrt(2 df); raises on a draw outside the nucleus or past the bound."""
    import numpy as np

    from u2tokenizer_torch.ops.sampling import nucleus_sample

    host = row.cpu().numpy()
    p = np.exp(host.astype(np.float64) - host.max())
    p /= p.sum()
    order = np.argsort(-host, kind="stable")
    cum = np.cumsum(p[order])
    thr = host[order][int(((cum - p[order]) < SAMPLE_TOP_P).sum()) - 1]
    exact = np.where(host >= thr, p, 0.0)
    exact /= exact.sum()
    batch = row[None].expand(SAMPLE_ROWS, -1).contiguous()
    counts = torch.zeros(row.numel(), dtype=torch.int64, device=row.device)
    for _ in range(draws // SAMPLE_ROWS):
        counts += torch.bincount(nucleus_sample(batch, SAMPLE_TOP_P,
                                                generator),
                                 minlength=row.numel())
    counts = counts.cpu().numpy()
    outside = int(counts[exact == 0].sum())
    if outside:
        raise AssertionError(f"nucleus_sample: {outside} draws outside the "
                             f"nucleus")
    keep = exact > 0
    n = counts.sum()
    stat = float(((counts[keep] - n * exact[keep]) ** 2
                  / (n * exact[keep])).sum())
    df = int(keep.sum()) - 1
    bound = df + 6 * math.sqrt(2 * df)
    if not stat <= bound:
        raise AssertionError(f"nucleus_sample: chi-square {stat:.4g} over "
                             f"{bound:.4g} ({df} df)")
    return {"nucleus": int(keep.sum()), "draws": int(n),
            "min_expected": float(n * exact[keep].min()),
            "chi_square": stat, "df": df, "bound": bound}


def check_nucleus_sampler(torch, device="cuda"):
    """``nucleus_sample`` on the card over μ²Llama's 128,256-entry
    vocabulary, on two fixed rows of seeded noise (std 0.3): one with 12
    graded logits 14..12 (a nucleus of about 10 tokens) and one with 700 at
    9..8 (about 650), ``nucleus_readings`` of SAMPLE_ROWS x SAMPLE_BATCHES
    draws each; and the sampler's time at B=1 beside greedy's argmax
    (CUDA events)."""
    import numpy as np

    from u2tokenizer_torch.ops.sampling import greedy, nucleus_sample

    v = 128256
    rng = np.random.default_rng(0)
    g = torch.Generator(device=device).manual_seed(0)
    out = {"vocab": v, "top_p": SAMPLE_TOP_P}
    for label, width, top in (("narrow", 12, (14.0, 12.0)),
                              ("wide", 700, (9.0, 8.0))):
        row = (rng.standard_normal(v) * 0.3).astype(np.float32)
        row[rng.choice(v, width, replace=False)] = np.linspace(*top, width)
        out[label] = nucleus_readings(torch, torch.from_numpy(row).to(device),
                                      SAMPLE_ROWS * SAMPLE_BATCHES, g)
    one = torch.from_numpy(row[None]).to(device)
    out["sample_ms_b1"] = time_ms(torch, lambda: nucleus_sample(
        one, SAMPLE_TOP_P, g), inner=32)
    out["greedy_ms_b1"] = time_ms(torch, lambda: greedy(one), inner=32)
    return out


def training_batch(torch, cfg, seq: int, valid, prompt: int, seed: int = 0):
    """A host batch as the dataset gives it: ``len(valid)`` rows of ``seq``
    tokens (row r valid for ``valid[r]``, right-padded to the model's
    max length), labels -100 over the image rows, the first ``prompt``
    tokens and the padding; volumes, ids and question ids from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    b = len(valid)
    d, h, w = cfg.vision.input_spatial
    vocab = cfg.llm.vocab_size
    ids = torch.randint(0, vocab, (b, seq), generator=g)
    mask = torch.arange(seq)[None, :] < torch.tensor(valid)[:, None]
    labels = torch.where(mask, ids, torch.full_like(ids, -100))
    labels[:, :prompt] = -100
    return {"images": torch.randn(b, cfg.num_chunks, d, h, w, generator=g),
            "input_ids": ids, "question_ids": torch.randint(
                0, vocab, (b, 64), generator=g),
            "attention_mask": mask.to(torch.int32), "labels": labels}


def drive_training(torch, fa, da, steps: int):
    """SFT of full-width μ²Qwen3-1.7B through ``make_trainer`` and
    ``run_training``: ``steps`` steps on one seeded batch, a checkpoint at
    the end into a temporary directory, one more step profiled."""
    from u2tokenizer_torch.config import TrainConfig, U2ModelConfig
    from u2tokenizer_torch.models.u2_model import U2CausalLM
    from u2tokenizer_torch.train.loop import MetricLogger, run_training
    from u2tokenizer_torch.train.sft import make_trainer

    cfg = U2ModelConfig()
    with tempfile.TemporaryDirectory() as out:
        tcfg = TrainConfig(max_steps=steps, log_steps=1, output_dir=out)
        t0 = time.perf_counter()
        model = U2CausalLM(cfg, dtype=torch.bfloat16, device="cuda", seed=0,
                           remat=tcfg.remat)
        state, train_step = make_trainer(model, tcfg, steps)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        batch = training_batch(torch, cfg, tcfg.model_max_length,
                               [TRAIN_VALID], TRAIN_PROMPT)
        probes = {"vision": model.vision_tower.vision_tower.blocks[0].attn.qkv
                  .weight, "llm": model.llm.model.layers[0].mlp.down_proj
                  .weight, "embed": model.llm.model.embed_tokens}
        snap = lambda: {k: p.detach()[:4].clone() for k, p in probes.items()}
        snaps, times = [snap()], []

        def timed_step(state, batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = train_step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            snaps.append(snap())
            return state, metrics

        reset_launches(fa, da)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = run_training(tcfg, state, timed_step,
                             lambda epoch: itertools.repeat(batch, steps),
                             logger=MetricLogger(out))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_launches(fa, da)
        peak = torch.cuda.max_memory_allocated()
        with open(f"{out}/metrics.jsonl") as f:
            records = [json.loads(line) for line in f]
        ckpt_bytes = sum(e.stat().st_size for e in os.scandir(
            f"{out}/checkpoints/{steps}"))
        device_batch = {k: v.to("cuda") for k, v in batch.items()}
        profile = profile_train_step(torch, fa, state, train_step,
                                     device_batch)
    del state, model, train_step, device_batch

    losses = [r["loss"] for r in records]
    norms = [r["grad_norm"] for r in records]
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or grad_norm: {records}")
    unchanged = [k for k in probes if not torch.equal(snaps[1][k], snaps[0][k])]
    if unchanged:  # the first update has lr 0 (optax's count starts at 0)
        raise AssertionError(f"parameters moved at lr 0: {unchanged}")
    still = [k for k in probes if torch.equal(snaps[2][k], snaps[1][k])]
    if still:
        raise AssertionError(f"parameters did not move at lr > 0: {still}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    s_step = statistics.median(times[1:])
    seq = tcfg.model_max_length
    return {"model": "mu2Qwen3-1.7B", "params": "fp32", "compute": "bf16",
            "n_params": n_params,
            "batch": 1, "seq": seq, "valid_tokens": TRAIN_VALID,
            "remat": tcfg.remat, "optimizer": "AdamW",
            "learning_rate": tcfg.learning_rate, "steps": steps,
            "model_build_s": build_s, "step_s": times,
            "s_per_step": s_step, "tokens_per_s": seq / s_step,
            "run_training_s": run_s,
            "checkpoint_and_loop_s": run_s - sum(times),
            "checkpoint_gb": ckpt_bytes / 1e9, "peak_mem_gb": peak / 1e9,
            "loss": losses, "grad_norm": norms,
            "token_accuracy": [r["token_accuracy"] for r in records],
            "launches": launches,
            "launches_per_step": {k: v / steps for k, v in launches.items()},
            "step_profile": profile}


def profile_train_step(torch, fa, state, train_step, batch):
    """torch.profiler over one train step: the card's busy share of its
    wall clock and device time by kernel, with the shares of the flash
    forward and backward (their kernels matched by their ``__global__``
    names); raises if either share reads 0 while the step launched its
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    before = read_launches(fa)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, batch)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels, by_name = device_time(torch, prof)
    busy_us = sum(by_name.values())
    share = lambda *keys: sum(t for n, t in by_name.items()
                              if any(k in n for k in keys)) / max(busy_us, 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    launched = {name: n - before[name]
                for name, n in read_launches(fa).items()}
    bwd_launches = sum(launched[name] for name in fa.BWD_KERNELS)
    fwd_launches = sum(launched[name] for name in fa.KERNELS)
    bwd_share = share("lse_kernel", "dq_kernel", "dkv_kernel")
    fwd_share = share("flash_fwd_kernel")
    if bwd_launches and not bwd_share:
        raise AssertionError(f"the profiled step launched K4 {bwd_launches} "
                             f"times but no kernel named lse_kernel, "
                             f"dq_kernel or dkv_kernel took device time")
    if fwd_launches and not fwd_share:
        raise AssertionError(f"the profiled step launched K1/K2 "
                             f"{fwd_launches} times but no kernel named "
                             f"flash_fwd_kernel took device time")
    return {"wall_ms": wall_us / 1e3, "device_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "kernels": len(kernels), "flash_bwd_launches": bwd_launches,
            "flash_bwd_share": bwd_share,
            "flash_fwd_launches": fwd_launches,
            "flash_fwd_share": fwd_share,
            "top_device_ms": {n: t / 1e3 for n, t in top}}


def planted_faults(torch, fa):
    """Faults of the flash backward's wiring, as replacements of ``fa``'s
    kernel wrappers, that the training reference check must reject: dk
    without its scale, dd left out of dS, dk and dv summed over only the
    first q head of each GQA group, and lse taken over the keys past the
    causal frontier. (A key off by one at the end of ``lens`` is left to
    the kernel checks: in a causal layer only rows that the loss masks see
    it, and in the ViT it is one key of 2049 in one of 8 rows.)"""
    lse, dq, dkv = fa.flash_bwd_lse, fa.flash_bwd_dq, fa.flash_bwd_dkv

    def dk_unscaled(*args, scale, **kw):
        dk, dv = dkv(*args, scale=scale, **kw)
        return dk / scale, dv

    def without_dd(kernel):
        return lambda q, k, v, do, lse_, dd, lens, **kw: kernel(
            q, k, v, do, lse_, torch.zeros_like(dd), lens, **kw)

    def first_head_only(q, k, v, do, lse_, dd, lens, **kw):
        group = q.shape[2] // k.shape[2]
        keep = (torch.arange(q.shape[2], device=q.device) % group
                == 0)[:, None]
        return dkv(q, k, v, do * keep.to(do.dtype), lse_, dd * keep, lens,
                   **kw)

    def lse_not_causal(q, k, lens, *, causal, scale):
        return lse(q, k, lens, causal=False, scale=scale)

    return {"dk unscaled": {"flash_bwd_dkv": dk_unscaled},
            "dd dropped": {"flash_bwd_dq": without_dd(dq),
                           "flash_bwd_dkv": without_dd(dkv)},
            "GQA sum of the first q head": {"flash_bwd_dkv": first_head_only},
            "lse not causal": {"flash_bwd_lse": lse_not_causal}}


def plain_attention(fa):
    """Replacements that run the plain versions of K1, K2 and K4a-c on the
    card in place of the kernels (bf16 in, fp32 arithmetic)."""
    return {"_flash_cuda": lambda q, k, v, lens, causal, scale:
            fa.flash_attention_reference(q, k, v, lens, causal=causal,
                                         scale=scale),
            "flash_bwd_lse": fa.flash_bwd_lse_reference,
            "flash_bwd_dq": fa.flash_bwd_dq_reference,
            "flash_bwd_dkv": fa.flash_bwd_dkv_reference}


@contextlib.contextmanager
def planted(fa, replacements):
    """``fa``'s functions named in ``replacements`` swapped for theirs
    inside the block."""
    saved = {name: getattr(fa, name) for name in replacements}
    for name, fn in replacements.items():
        setattr(fa, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(fa, name, fn)


def gradient_readings(torch, model, ref):
    """Per parameter: the cosine of its gradient to ``ref``'s (flat fp64)
    and the ratio of their norms, summed in fp64."""
    out = {}
    for name, p in model.named_parameters():
        g, r = p.grad.double().flatten().cpu(), ref[name]
        gn, rn = g.norm().item(), r.norm().item()
        if gn == rn == 0:  # no path to the loss (the top-k's score net)
            out[name] = {"cos": 1.0, "norm_ratio": 1.0}
            continue
        out[name] = {"cos": torch.dot(g, r).item() / (gn * rn)
                     if gn * rn else 0.0,
                     "norm_ratio": gn / rn if rn else math.inf}
    return out


def left_out(name: str):
    """Why the training reference check leaves this parameter's gradient
    out (see TRAIN_COS_MIN), or None where it holds it."""
    if name.endswith("wk.bias"):
        return "key_bias"
    if name.startswith(("u2tokenizer.tta_module.",
                        "u2tokenizer.query_tokens")):
        return "aggregator"
    return None


def judged(name: str) -> bool:
    return left_out(name) is None


def misfits(readings):
    """The judged parameters whose gradient the limits reject."""
    return {name: r for name, r in readings.items()
            if judged(name)
            and not (r["cos"] >= TRAIN_COS_MIN
                     and abs(r["norm_ratio"] - 1) <= TRAIN_NORM_TOL)}


def worst_leaves(readings):
    """The lowest cosine and the norm ratio furthest from 1 among the
    judged parameters."""
    some = {n: r for n, r in readings.items() if judged(n)}
    c = min(some, key=lambda n: some[n]["cos"])
    q = max(some, key=lambda n: abs(some[n]["norm_ratio"] - 1))
    return {"min_cos": [c, some[c]["cos"]],
            "worst_norm_ratio": [q, some[q]["norm_ratio"]]}


def left_out_medians(readings):
    """Per group of ``left_out``: its size and the median cosine and norm
    ratio of its parameters' gradients."""
    out = {}
    for group in ("key_bias", "aggregator"):
        some = [r for n, r in readings.items() if left_out(n) == group]
        out[group] = {"leaves": len(some), "median_cos": statistics.median(
            r["cos"] for r in some), "median_norm_ratio": statistics.median(
            r["norm_ratio"] for r in some)}
    return out


def train_reference_readings(torch, fa):
    """One train step of the reduced-depth, full-width model (4 chunks, the
    fewest that give the μ²tokenizer's 1024-token top-k enough candidates;
    2 rows of 384 tokens, one valid for 300) on the CPU (fp32, plain
    versions) and, from the same fp32 weights, on the card (bf16 compute,
    kernels): sound, with the plain attention, and under each of
    ``planted_faults``. Returns the CPU's loss, the card's sound loss, and
    ``gradient_readings`` of the sound step, of the plain attention's and
    of each fault's."""
    from u2tokenizer_torch.config import TrainConfig
    from u2tokenizer_torch.models.u2_model import U2CausalLM
    from u2tokenizer_torch.train.sft import make_trainer

    cfg = reduced_config(num_chunks=4)
    batch = training_batch(torch, cfg, 384, [384, 300], 280, seed=1)
    cpu = U2CausalLM(cfg, dtype=torch.float32, device="cpu", seed=1,
                     remat=True)
    gpu = U2CausalLM(cfg, dtype=torch.bfloat16, device="cuda", seed=2,
                     remat=True)
    gpu.load_state_dict(cpu.state_dict())
    weights = {k: v.clone() for k, v in gpu.state_dict().items()}
    state, step = make_trainer(cpu, TrainConfig(), 1)
    _, metrics = step(state, batch)
    loss_cpu = float(metrics["loss"])
    ref = {n: p.grad.double().flatten() for n, p in cpu.named_parameters()}
    del cpu, state, step
    card_batch = {k: v.to("cuda") for k, v in batch.items()}

    def card_step(replacements):
        gpu.load_state_dict(weights)
        state, step = make_trainer(gpu, TrainConfig(), 1)
        with planted(fa, replacements):
            _, metrics = step(state, card_batch)
        return float(metrics["loss"]), gradient_readings(torch, gpu, ref)

    loss_gpu, sound = card_step({})
    plain = card_step(plain_attention(fa))[1]
    faults = {label: card_step(rep)[1]
              for label, rep in planted_faults(torch, fa).items()}
    return loss_cpu, loss_gpu, sound, plain, faults


def check_train_reference(torch, fa):
    """``train_reference_readings`` held to TRAIN_LOSS_TOL, TRAIN_COS_MIN
    and TRAIN_NORM_TOL; fails unless the same limits reject every planted
    fault."""
    loss_cpu, loss_gpu, sound, plain, faults = train_reference_readings(
        torch, fa)
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    if not rel <= TRAIN_LOSS_TOL:
        raise AssertionError(f"reduced model train step: card vs CPU loss "
                             f"relative error {rel:.4g} over {TRAIN_LOSS_TOL}")
    bad = misfits(sound)
    if bad:
        raise AssertionError(f"reduced model train step: gradients off the "
                             f"CPU's (cosine >= {TRAIN_COS_MIN}, norm ratio "
                             f"within {TRAIN_NORM_TOL} of 1): {bad}")
    caught = {}
    for label, readings in faults.items():
        bad = misfits(readings)
        if not bad:
            raise AssertionError(f"the training reference limits do not "
                                 f"reject the planted fault {label}: "
                                 f"{worst_leaves(readings)}")
        caught[label] = {**worst_leaves(readings),
                         "leaves_rejected": len(bad)}
    return {"loss_cpu": loss_cpu, "loss_gpu": loss_gpu, "loss_rel_err": rel,
            "loss_tol": TRAIN_LOSS_TOL, "grad_cos_min": TRAIN_COS_MIN,
            "grad_norm_tol": TRAIN_NORM_TOL,
            "leaves_held": sum(map(judged, sound)), "leaves": len(sound),
            "held": worst_leaves(sound),
            "left_out": {"kernels": left_out_medians(sound),
                         "plain_attention": left_out_medians(plain)},
            "plain_attention": worst_leaves(plain),
            "planted_faults": caught}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--max-new", type=int, default=B4_MAX_NEW)
    parser.add_argument("--kernels-only", action="store_true",
                        help="build and check the kernels, then stop "
                        "(no result line)")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU")
        return 2
    try:
        import torch.nn.functional as F
        from u2tokenizer_torch.ops import _build
        from u2tokenizer_torch.ops import attention as attn
        from u2tokenizer_torch.ops import decode_attention as da
        from u2tokenizer_torch.ops import flash_attention as fa
    except ImportError as e:
        log(f"chip_smoke: the port is not importable here ({e}); run from "
            "the root of a checkout")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = gpu_line()
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "tf32": False,
                      "exp_bound": exp_peak(torch)}), flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {stem: ptxas_summary(info["ptxas"])
             for stem, info in _build.build_info.items()}
    nvcc = re.search(r"release ([\d.]+)", subprocess.run(
        [_build._nvcc(), "--version"], capture_output=True,
        text=True).stdout)
    print(json.dumps({"build_s": build_s, "nvcc": nvcc and nvcc.group(1),
                      "ptxas": ptxas}), flush=True)

    k1 = check_flash(torch, F, fa, VIT_CALL, 1)
    k2 = check_flash(torch, F, fa, PREFILL_CALL, 2)
    fwd_calls = {
        "vit": k1,
        "vit_quantized": check_flash(torch, F, fa, QUANT_VIT_CALL, 11,
                                     held=HELD_ROWS),
        "prefill": k2,
        "prefill_quantized": check_flash(torch, F, fa, QUANT_PREFILL_CALL,
                                         10, held=HELD_ROWS),
        "decoder_b1": check_flash(torch, F, fa, TRAIN_DECODER_CALL, 9),
        "prefill_mu2llama": check_flash(torch, F, fa, LLAMA_PREFILL_CALL,
                                        16)}
    # K1 and K2 each at both tile-edge shapes, and K2 at the Qwen3-8B
    # prefill, untimed
    edge_fwd = [check_flash(torch, F, fa, dict(call, causal=causal),
                            12 + 2 * i + causal, timed=False)
                for i, call in enumerate(EDGE_CALLS)
                for causal in (False, True)]
    edge_fwd.append(check_flash(torch, F, fa, QWEN8B_PREFILL_CALL, 17,
                                timed=False))
    for k in list(fwd_calls.values()) + edge_fwd:
        print(json.dumps({"kernel_check": k}), flush=True)
    print(json.dumps({"flash_fwd_calls": flash_fwd_summary(fwd_calls),
                      "card": card}), flush=True)
    int8 = check_decode(torch, da, attn, 8, BATCH)
    kernels = [k1, k2, int8]
    int4 = check_decode(torch, da, attn, 4, QUANT_BATCH)
    int4_b4 = check_decode(torch, da, attn, 4, BATCH)
    edge_decode = [check_decode(torch, da, attn, bits, b, step, prompt,
                                timed=False)
                   for bits, b, step, prompt in DECODE_EDGE_CALLS]
    edge_decode += [check_decode(torch, da, attn, bits, 2, timed=False,
                                 heads=heads)
                    for heads in DECODE_PRESET_HEADS.values()
                    for bits in (8, 4)]
    vit_bwd = check_flash_bwd(torch, F, fa, VIT_CALL, 4)
    dec_bwd = check_flash_bwd(torch, F, fa, PREFILL_CALL, 5)
    b1_bwd = check_flash_bwd(torch, F, fa, TRAIN_DECODER_CALL, 6)
    edge_bwd = [e for i, call in enumerate(EDGE_CALLS + [LLAMA_TRAIN_CALL])
                for e in check_flash_bwd(torch, F, fa, call, 7 + i,
                                         timed=False)]
    for k in [int8, int4, int4_b4] + edge_decode + vit_bwd + dec_bwd \
            + b1_bwd + edge_bwd:
        print(json.dumps({"kernel_check": k}), flush=True)
    print(json.dumps({"decode_calls": decode_summary(
        {f"int8_b{BATCH}": int8, f"int4_b{QUANT_BATCH}": int4,
         f"int4_b{BATCH}": int4_b4}), "card": card}), flush=True)
    print(json.dumps({"flash_bwd_calls": flash_bwd_summary(
        {"vit": vit_bwd, "decoder": dec_bwd, "decoder_b1": b1_bwd}),
        "card": card}), flush=True)
    # one entry per kernel: K1 at the ViT's call with the quantized path's
    # beside it, K2 at the B=4 prefill with the quantized path's, the
    # training path's and the μ²Llama report's beside it, each with the
    # largest error of all its checks; K3-int4 at the quantized path's
    # batch with the B=4 call
    # beside it; K4 at the ViT's call with the decoder's (B=4, and the
    # training path's B=1) beside it, its error the largest of all the K4
    # checks
    beside = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
              "bound_by", "library_ms")
    nested = {"vit": ("vit_quantized",),
              "prefill": ("prefill_quantized", "decoder_b1",
                          "prefill_mu2llama")}
    for top, labels in nested.items():
        entry = fwd_calls[top]
        for label in labels:
            entry[f"{label}_call"] = {key: fwd_calls[label][key]
                                      for key in beside + ("plain_rows",)}
        entry["max_abs_err"] = max(
            e["max_abs_err"] for e in list(fwd_calls.values()) + edge_fwd
            if e["name"] == entry["name"])
    for entry in (int8, int4):
        entry["max_abs_err"] = max(e["max_abs_err"] for e in
                                   [int4_b4] + edge_decode + [entry]
                                   if e["name"] == entry["name"])
    int4[f"batch{BATCH}_call"] = {key: int4_b4[key]
                                  for key in beside + ("n_split",)}
    kernels.append(int4)
    for i, (vit, dec, b1) in enumerate(zip(vit_bwd, dec_bwd, b1_bwd)):
        vit["max_abs_err"] = max(e["max_abs_err"] for e in
                                 (vit, dec, b1, *edge_bwd[i::3]))
        vit["decoder_call"] = {key: dec[key] for key in beside}
        vit["decoder_call_b1"] = {key: b1[key] for key in beside}
        kernels.append(vit)
    del int4_b4, vit_bwd, dec_bwd, b1_bwd, edge_bwd, fwd_calls, edge_fwd, \
        edge_decode
    gc.collect()
    torch.cuda.empty_cache()
    if args.kernels_only:
        return 0

    counts = {"serve": serve_and_check(
        torch, da, args.max_new, BATCH, "bf16", "int8", VISION_MICROBATCH,
        card)["launches"]}
    gc.collect()
    torch.cuda.empty_cache()
    quant_run = serve_and_check(
        torch, da, MAX_NEW, QUANT_BATCH, QUANT_WEIGHTS, QUANT_CACHE,
        QUANT_MICROBATCH, card)
    counts["serve_quantized"] = quant_run["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ingest, volume = check_ingest(torch, tmp)
        ingest["card"] = card
        print(json.dumps({"ingest": ingest}), flush=True)
        greedy_tokens, report = drive_report(torch, fa, da, volume, tmp)
        report["card"] = card
        print(json.dumps({"report_mu2llama": report}), flush=True)
        counts["report_mu2llama"] = report["launches"]
        gc.collect()
        torch.cuda.empty_cache()
        counts.update(drive_speculative(torch, fa, da, volume, tmp,
                                        greedy_tokens, quant_run, card))
        gc.collect()
        torch.cuda.empty_cache()
        counts.update(drive_serving(torch, fa, da, volume, tmp, card))
    del volume
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"nucleus_sampler": check_nucleus_sampler(torch),
                      "card": card}), flush=True)
    llama = released_config()
    for weights, cache, base, variant in (
            ("bf16", "int8", None, None), ("int8", "int4", None, None),
            ("int4", "int4", None, None),
            ("bf16", torch.bfloat16, llama, None),
            ("bf16", "int8", None, "prefill_chunk"),
            ("bf16", "int8", None, "shared_prefix"),
            ("int8", "int4", None, "verify_block")):
        print(json.dumps({"reference_check": check_reference(
            torch, weights, cache, base, variant)}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    train = drive_training(torch, fa, da, TRAIN_STEPS)
    counts["train"] = train["launches"]
    # per step: the ViT's 12 layers (not rematerialised) and the decoder's
    # 28, forward again in the backward under remat
    per_step = {name: 0 for name in counts["train"]}
    per_step.update({"flash_fwd_noncausal": 12, "flash_fwd_causal": 56,
                     "flash_bwd_lse": 40, "flash_bwd_dq": 40,
                     "flash_bwd_dkv": 40})
    train["card"] = card
    print(json.dumps({"train_path": train}), flush=True)
    want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    if counts["train"] != want:
        raise AssertionError(f"training launches {counts['train']} != "
                             f"expected {want}")
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"train_reference_check": check_train_reference(
        torch, fa)}), flush=True)

    for k in kernels:
        by_path = {path: n[k["name"]] for path, n in counts.items()}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        for key in ("shape", "check", "ref_scale", "plain_rows"):
            k.pop(key, None)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
