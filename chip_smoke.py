#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--max-new N] [--kernels-only]

Run from the root of a checkout. It

  1. prints the card's name and power limit (nvidia-smi) and builds the
     hand-written kernels from ``u2tokenizer_torch/csrc`` with nvcc;
  2. checks each kernel against its plain PyTorch version on the card at
     the shapes the serving path gives it, with ragged lengths in one row,
     shows that the same limits reject a mask off by one key, and times the kernel, the plain version and, where one PyTorch call
     computes the same function, that call (CUDA events, median of 7);
  3. drives the serving path once: full-width μ²Qwen3-1.7B with random
     weights from a fixed seed, bf16, int8 KV cache, 4 CT volumes of
     (8, 32, 256, 256), a 1024-token prompt (one row 900), greedy decode of
     768 tokens; asserts the output and that every kernel ran on that path
     the expected number of times; then profiles 8 decode steps
     (torch.profiler: the card's busy share, kernels per step);
  4. checks a reduced-depth, full-width model on the card against the same
     weights run in fp32 on the CPU through the plain versions;
  5. prints one JSON line per kernel table, the card line, and last
     ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, when there is no CUDA device, when the
port is not importable, or when any check fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
# Kernel vs plain version, per element:
#     |out - ref| <= atol + rtol * |ref| + mtol * sum_j p_j |v_j|.
# Both outputs are bf16 rounded from fp32 sums taken in another order, so
# they may differ by about one bf16 ulp (2^-8 relative): rtol. The flash
# kernels round the unnormalised probabilities to bf16 where the plain
# version rounds the normalised ones, two errors of up to 2^-9 relative on
# each term p_j v_j: mtol = 2^-8 of the terms' absolute sum. It matters
# where a few keys carry all the weight and cancel, as in K2's early causal
# rows (0.0156 at |ref| ~0.5). K3 rounds as its plain version does. atol
# covers the typical |ref| of 0.04. A one-key change to the mask moves
# outputs by more, and each check below shows it: the kernel must fail
# these limits against a plain version whose mask is off by one key.
TOL = {"flash_fwd_noncausal": (4e-3, 1e-2, 2.0 ** -8),
       "flash_fwd_causal": (4e-3, 1e-2, 2.0 ** -8),
       "decode_attention_int8": (4e-3, 1e-2, 0.0)}
PROMPT, MAX_NEW, BATCH, VISION_MICROBATCH = 1024, 768, 4, 8
RAGGED = 900               # the last row's prompt length


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


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


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
    one key."""
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
                                 f"the kernel from a mask with {label} "
                                 f"(max abs diff {m_err:.4g})")
        caught[label] = {"max_abs_diff": m_err, "x_limit": m_ratio}
    return {"max_abs_err": err, "x_limit": ratio, "tol": list(TOL[name]),
            "off_by_one_key": caught}


def check_flash(torch, F, fa, causal: bool):
    """K1 at the ViT's call (8 chunks, 2049 tokens, 12 heads of 64, q/k/v
    strided views of the fused qkv) or K2 at the prefill (4 rows, 1024
    tokens, 16 q / 8 kv heads of 128)."""
    g = torch.Generator(device="cuda").manual_seed(1 + causal)
    if causal:
        b, s, h, hkv, d = BATCH, PROMPT, 16, 8, 128
        q = torch.randn(b, s, h, d, generator=g, device="cuda",
                        dtype=torch.bfloat16)
        k, v = (torch.randn(b, s, hkv, d, generator=g, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        lens = [s] * (b - 1) + [RAGGED]
    else:
        b, s, h, d = VISION_MICROBATCH, 2049, 12, 64
        hkv = h
        qkv = torch.randn(b, s, 3 * h * d, generator=g, device="cuda",
                          dtype=torch.bfloat16)
        q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].reshape(b, s, h, d)
                   for i in range(3))
        lens = [s] * (b - 1) + [1777]
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    name = fa.KERNELS[int(causal)]
    out = fa.flash_attention(q, k, v, lens_t, causal=causal)
    ref = fa.flash_attention_reference(q, k, v, lens_t, causal=causal)
    mutants = {}
    for shift in (-1, 1):
        off = lens_t.clone()
        off[-1] += shift
        mutants[f"lens[-1]{shift:+d}"] = fa.flash_attention_reference(
            q, k, v, off, causal=causal)
    mass = fa.flash_attention_reference(q, k, v.abs(), lens_t, causal=causal)
    torch.cuda.synchronize()
    check = compare(torch, out, ref, name, mutants, mass)

    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, lens_t,
                                                   causal=causal))
    plain_ms = time_ms(torch, lambda: fa.flash_attention_reference(
        q, k, v, lens_t, causal=causal), reps=3)
    keys = torch.arange(s, device="cuda")
    mask = (keys[None, :] < lens_t[:, None])[:, None, None, :]
    if causal:
        mask = mask & (keys[None, :] <= keys[:, None])[None, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=hkv != h))

    # work this data needs: query row i sees min(i+1, len) keys (causal)
    # or len keys; each tensor is read or written once
    if causal:
        seen = sum(sum(min(i + 1, n) for i in range(s)) for n in lens)
    else:
        seen = s * sum(lens)
    flops = 4.0 * d * h * seen
    nbytes = 2.0 * b * s * d * (2 * h + 2 * hkv)
    bms, by = bound_ms(flops, nbytes)
    return {"name": name, "route": "cuda",
            "source": "u2tokenizer_torch/csrc/flash_fwd.cu",
            "replaces": ("u2tokenizer_tpu/ops/flash_attention.py:73"
                         if causal else
                         "u2tokenizer_tpu/ops/flash_attention.py:45"),
            "max_abs_err": check.pop("max_abs_err"), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms, "check": check,
            "shape": {"q": list(q.shape), "k": list(k.shape), "lens": lens}}


def check_decode(torch, da, attn):
    """K3 at a mid-run decode step: 4 rows, 16 q / 8 kv heads of 128, an
    int8 cache of 1024 + 768 slots, one row's prompt 900 tokens long."""
    b, h, hkv, d = BATCH, 16, 8, 128
    s_total, step = PROMPT + MAX_NEW, (MAX_NEW - 1) // 2
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(b, 1, h, d, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    # distinct caches, cycled while timing, so that the 50 MB L2 holds none
    # (the serving loop reads 28 layers' caches in turn)
    caches = []
    for _ in range(16):
        kf, vf = (torch.randn(b, s_total, hkv, d, generator=g, device="cuda",
                              dtype=torch.bfloat16) for _ in range(2))
        (kq, ks), (vq, vs) = attn.quantize_kv(kf), attn.quantize_kv(vf)
        caches.append(tuple(x.transpose(1, 2).contiguous() for x in
                            (kq, ks[..., 0], vq, vs[..., 0])))
    plen_l = [PROMPT] * (b - 1) + [RAGGED]
    plen = torch.tensor(plen_l, dtype=torch.int32, device="cuda")
    end = torch.full((b,), PROMPT + step + 1, dtype=torch.int32,
                     device="cuda")
    kq, ks, vq, vs = caches[0]
    out = da.decode_attention_quantized(q, kq, ks, vq, vs, plen, end, PROMPT)
    ref = da.decode_attention_reference(q, kq, ks, vq, vs, plen, end, PROMPT)
    mutants = {}
    for shift in (-1, 1):
        off = plen.clone()
        off[-1] += shift
        mutants[f"prompt_len[-1]{shift:+d}"] = da.decode_attention_reference(
            q, kq, ks, vq, vs, off, end, PROMPT)
        mutants[f"end{shift:+d}"] = da.decode_attention_reference(
            q, kq, ks, vq, vs, plen, end + shift, PROMPT)
    torch.cuda.synchronize()
    check = compare(torch, out, ref, da.KERNEL, mutants)

    it = iter(range(1 << 30))

    def run():
        kq, ks, vq, vs = caches[next(it) % len(caches)]
        da.decode_attention_quantized(q, kq, ks, vq, vs, plen, end, PROMPT)

    ms = time_ms(torch, run, inner=32)
    plain_ms = time_ms(torch, lambda: da.decode_attention_reference(
        q, kq, ks, vq, vs, plen, end, PROMPT), inner=4)
    rows = sum(n + step + 1 for n in plen_l)  # visible cache rows
    nbytes = hkv * rows * (2 * d + 2 * 2) + 2 * (2 * b * h * d)
    flops = 4.0 * d * (h // hkv) * hkv * rows
    bms, by = bound_ms(flops, nbytes)
    return {"name": da.KERNEL, "route": "cuda",
            "source": "u2tokenizer_torch/csrc/decode_attention.cu",
            "replaces": "u2tokenizer_tpu/ops/decode_attention.py:32",
            "max_abs_err": check.pop("max_abs_err"), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "check": check,
            "shape": {"q": list(q.shape), "k": list(kq.shape),
                      "prompt_len": plen_l, "end": PROMPT + step + 1}}


def drive_main_path(torch, max_new: int):
    from u2tokenizer_torch.config import GenerationConfig, U2ModelConfig
    from u2tokenizer_torch.models.generate import make_multimodal_generate_fn
    from u2tokenizer_torch.models.u2_model import U2CausalLM
    from u2tokenizer_torch.ops import decode_attention as da
    from u2tokenizer_torch.ops import flash_attention as fa

    cfg = U2ModelConfig()  # μ²Qwen3-1.7B, full width and depth
    t0 = time.perf_counter()
    model = U2CausalLM(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    g = torch.Generator(device="cuda").manual_seed(0)
    d, h, w = cfg.vision.input_spatial
    images = torch.randn(BATCH, cfg.num_chunks, d, h, w, generator=g,
                         device="cuda", dtype=torch.bfloat16)
    vocab = cfg.llm.vocab_size
    input_ids = torch.randint(0, vocab, (BATCH, PROMPT), generator=g,
                              device="cuda")
    question_ids = torch.randint(0, vocab, (BATCH, 64), generator=g,
                                 device="cuda")
    prompt_len = torch.tensor([PROMPT] * (BATCH - 1) + [RAGGED],
                              dtype=torch.int32, device="cuda")
    gen = GenerationConfig(max_new_tokens=max_new, do_sample=False,
                           eos_token_id=-2, pad_token_id=0)
    generate = make_multimodal_generate_fn(
        model, gen, cache_dtype="int8", vision_microbatch=VISION_MICROBATCH)

    for name in fa.launches:
        fa.launches[name] = 0
    da.launches[da.KERNEL] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embeds = generate.embeds(input_ids, images, question_ids)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cache, tok0, done0, hidden = generate.prefill_stage(embeds, prompt_len)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _, _, rest = generate.decode_steps(cache, tok0, done0, prompt_len,
                                       range(max_new - 1))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    tokens = torch.cat([tok0[:, None], rest], dim=1)
    launches = {**fa.launches, **da.launches}
    profile = profile_decode(torch, generate, embeds, prompt_len)

    assert tuple(embeds.shape) == (BATCH, PROMPT, cfg.llm.hidden_size)
    assert torch.isfinite(embeds).all(), "non-finite prompt embeddings"
    assert torch.isfinite(hidden).all(), "NaN/inf in the prefill hidden states"
    assert tuple(tokens.shape) == (BATCH, max_new), tokens.shape
    assert tokens.dtype == torch.int64
    assert ((tokens >= 0) & (tokens < vocab)).all(), "token out of range"
    total = t3 - t0
    return {"model": "mu2Qwen3-1.7B", "batch": BATCH, "prompt": PROMPT,
            "prompt_len": prompt_len.tolist(), "max_new_tokens": max_new,
            "cache": "int8", "weights": "bf16",
            "vision_microbatch": VISION_MICROBATCH,
            "model_build_s": build_s, "vision_s": t1 - t0,
            "prefill_s": t2 - t1, "decode_s": t3 - t2, "total_s": total,
            "reports_per_min": 60.0 * BATCH / total,
            "decode_ms_per_step": 1e3 * (t3 - t2) / max(max_new - 1, 1),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "first_tokens": tokens[:, :8].tolist(), "launches": launches,
            "decode_profile": profile}


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
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
            "device_ms_per_step": busy_us / steps / 1e3,
            "device_busy_share": busy_us / wall_us,
            "kernels_per_step": len(kernels) / steps,
            "top_device_ms_per_step": {n[:90]: t / steps / 1e3
                                       for n, t in top}}


def check_reference(torch):
    """Full-width model cut to 2 ViT, 1 μ²tokenizer and 2 decoder layers
    and 4 chunks: the card (bf16, kernels) against the CPU (fp32, plain
    versions) on the same weights. Compares the prefill's last-position
    logits and reports greedy token agreement over 4 decode steps."""
    from u2tokenizer_torch.config import (GenerationConfig, U2ModelConfig)
    from u2tokenizer_torch.models.generate import make_multimodal_generate_fn
    from u2tokenizer_torch.models.u2_model import U2CausalLM

    base = U2ModelConfig()
    cfg = dataclasses.replace(
        base, num_chunks=4,
        vision=dataclasses.replace(base.vision, num_layers=2),
        u2t=dataclasses.replace(base.u2t, num_layers=1),
        llm=dataclasses.replace(base.llm, num_layers=2))
    b, s = 2, 384
    cpu = U2CausalLM(cfg, dtype=torch.float32, device="cpu", seed=1)
    gpu = U2CausalLM(cfg, dtype=torch.bfloat16, device="cuda", seed=2)
    gpu.load_state_dict(cpu.state_dict())

    g = torch.Generator().manual_seed(1)
    d, h, w = cfg.vision.input_spatial
    images = torch.randn(b, cfg.num_chunks, d, h, w, generator=g)
    ids = torch.randint(0, cfg.llm.vocab_size, (b, s), generator=g)
    qids = torch.randint(0, cfg.llm.vocab_size, (b, 32), generator=g)
    plen = torch.tensor([s, 300], dtype=torch.int32)
    gen = GenerationConfig(max_new_tokens=5, eos_token_id=-2)

    results = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, "cuda")):
        fn = make_multimodal_generate_fn(model, gen, "int8")
        args = [x.to(dev) for x in (ids, images, qids, plen)]
        embeds = fn.embeds(*args[:3])
        cache, tok0, done0, hidden = fn.prefill_stage(embeds, args[3])
        last = hidden[torch.arange(b, device=dev), (args[3] - 1).long()]
        logits = model.lm_logits(last[:, None])[:, 0].float().cpu()
        _, _, rest = fn.decode_steps(cache, tok0, done0, args[3], range(4))
        results[name] = (logits, torch.cat([tok0[:, None], rest], 1).cpu())
    (ref, tok_ref), (out, tok_out) = results["cpu"], results["gpu"]
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    agree = (tok_ref == tok_out).float().mean().item()
    if not rel <= 5e-2:
        raise AssertionError(f"reduced model: card vs CPU logits relative "
                             f"error {rel:.4g} over 5e-2")
    return {"logits_rel_err": rel, "logits_tol": 5e-2,
            "token_agreement": agree, "tokens_cpu": tok_ref.tolist(),
            "tokens_gpu": tok_out.tolist()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--max-new", type=int, default=MAX_NEW)
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

    card = gpu_line()
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {stem: [ln.strip() for ln in info["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for stem, info in _build.build_info.items()}
    print(json.dumps({"build_s": build_s, "ptxas": ptxas}), flush=True)

    kernels = [check_flash(torch, F, fa, causal=False),
               check_flash(torch, F, fa, causal=True),
               check_decode(torch, da, attn)]
    for k in kernels:
        print(json.dumps({"kernel_check": k}), flush=True)
    if args.kernels_only:
        return 0

    main_path = drive_main_path(torch, args.max_new)
    counts = main_path["launches"]
    vit = 12 * math.ceil(BATCH * 8 / VISION_MICROBATCH)
    expected = {"flash_fwd_noncausal": vit, "flash_fwd_causal": 28,
                da.KERNEL: 28 * (args.max_new - 1)}
    main_path["card"] = card
    print(json.dumps({"main_path": main_path}), flush=True)
    if counts != expected:
        raise AssertionError(f"launches {counts} != expected {expected}")

    print(json.dumps({"reference_check": check_reference(torch)}), flush=True)

    for k in kernels:
        k["launches"] = counts[k["name"]]
        k.pop("shape")
        k.pop("check")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
