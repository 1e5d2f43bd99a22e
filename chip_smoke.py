#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--max-new N] [--kernels-only]
                          [--qlora-reference-at STD [STD ...]]
                          [--serving-repeats N]

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
     steps 0, 63 and 127 of both serving paths, with a 3-token prompt in
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
     μ²Llama SFT call (D=64, causal, group 4), these untimed; the Phi
     forms (``phi_kernel_checks``): K2 at μ²Phi-3-mini's prefill (D=96,
     MHA) and at the Phi-2 judge's (D=80), K3-int8 and K3-int4 at both
     head dims (B=4, 32 heads, step 15 of 1024 + 32 slots), K4a-c at
     the QLoRA path's call (D=96, B=1, 1024 tokens, 423 valid) and at a
     Phi-2-shaped one (D=80, no path launches it), timed, with a
     ``phi_calls`` line and both K4 calls on the ``flash_bwd_calls`` line;
     the μ²Qwen3-8B forms (``qwen8b_kernel_checks``, D=128 at a GQA
     group of 4): K2 at its B=16 prefill, K3-int4 at its B=16 decode
     (1024 + 64 slots, timed at step 31, checked at 0 and 63) and K4a-c
     at its QLoRA call (B=1, 423 valid), timed, with a ``qwen3_8b_calls``
     line; the tiny configs' forms (``tiny_kernel_checks``): K1 at D=16
     (the tiny ViT's call, 65 tokens, fused q/k/v) and K2 at D=32 (the
     tiny decoder's, GQA group 2), K4a-c at both, K3-int8 and K3-int4 at
     D=32 (the tiny decoder's decode call, B=2, 4/2 heads, step 3 of
     64 + 8 slots), timed, with a ``tiny_calls`` line and both K4 calls on
     the ``flash_bwd_calls`` line, and every flash form at both dims on the
     tile edges and K3 at D=32 on its split path and a 3-token prompt,
     untimed;
     K1 at D=80 and 96 (no path either) on 1024 tokens, timed by events
     beside SDPA alone (``flash_fwd_no_path``); K1/K2 at both on
     the tile edge, K3 at groups 2, 4 and 8, its first and last steps and
     a 3-token prompt, K4a-c at both non-causal and on the tile edge,
     causal and not, and at D=128 non-causal, untimed;
  3. drives the serving path twice, each time full-width μ²Qwen3-1.7B with
     random weights from a fixed seed cast to bf16, CT volumes of
     (8, 32, 256, 256), a 1024-token prompt (the last row 900), 64 question
     tokens and a greedy decode: first bf16 weights, the int8 KV cache, 4
     volumes and 64 tokens (``--max-new``); then, 128 tokens (its 768
     cut for the script's time), the configuration of the JAX package's
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
     ``U2InferenceModel``, one greedy report of 192 tokens through
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
     fan-out, one case x 8 sampled samples of 128 tokens, speculative and
     plain, with every K2 call at the case batch; and ``bench.py``'s forced-content
     speculative configuration (μ²Qwen3-1.7B, int8 weights, int4 cache,
     B=112, FORCED_TOKENS tokens, scripts of
     ``report_token_scripts(112, FORCED_TOKENS + 8, vocab, seed=7)``):
     the script emitted exactly, the verify steps equal to the host replay
     of the loop's drafting, reports/min beside the plain quantized run's;
  6. drives serving (``drive_serving``) on the same checkpoint and CT:
     ``python -m u2tokenizer_torch.cli serve --slots 8`` as a process that
     must answer /health and one report; twelve questions one at a time
     through the single-request model ``cli serve`` builds (the reference
     tokens, and the sequential reports/min); the server ``cli serve
     --slots 8 --max-new-tokens 32`` builds, started by
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
  7. drives the paper's two training stages through the port's CLI in
     this process (``drive_green_dpo``), on the same checkpoint, two more
     seeded CTs and a jsonl of three cases, with a closed
     ``MockTokenizer``: ``train`` from files (3 steps, B=1, the training
     augmentations on the card), the same ``train`` on the
     (data, fsdp, tensor) mesh of one rank a card under
     ``torch.distributed.run`` (``start_mesh_train``: this script in
     ``--mesh-train-rank`` mode a rank; losses within 2e-3 of the one-card
     leg's, the same launches a step), ``generate --do-sample --num-samples 8``
     (256 tokens, the users' 768 cut for the script's time) on two cases,
     ``green`` with a judge directory (the Llama-3.2-1B preset, seeded
     bf16 weights: 16 prompts in batches of 4 padded to 2048,
     JUDGE_TOKENS greedy tokens, speculative with the shared prefix), one batch held to the
     plain judge under the near-tie rule, which must reject a shared
     prefix one bucket too long, and one batch with ``--judge-weights
     int8``; ``distributed_green`` through an initialised NCCL group of one
     rank over 4 of the judge's pairs, rows equal to the plain scorer's
     (``green_distributed_leg``); ``green`` with the stub judge and
     ``dpo-convert`` (2 pairs);
     ``dpo`` (4 steps at the JAX defaults: step 0 an identity, loss ln 2
     and rewards 0; one step profiled), again with ``--ce-chunk 256``
     (losses within 1e-3), and on one repeated pair at the default lr
     until the margin separates; a reduced-depth DPO step on the card against the CPU,
     whose limits must reject three planted faults, and the packed
     layout against the unpacked; K2 and K4a-c at the DPO call and K2 at
     the judge's;
 7b. scores reports through the port's CLI in this process
     (``drive_eval``) from the stage-2 phase's checkpoint, cases and
     judge: ``eval --task mrg`` of three cases, EVAL_TOKENS greedy tokens
     each (the users' 768 cut) with the seeded judge (seconds a case and a
     judged batch, K1 12 and K2 16 a case through ``step_probe``), case
     0's tokens and first-token logits inside the command against
     ``MultimodalGenerate`` on the same sample and model, a check that
     must reject the prompt one token short; ``eval --task vqa`` (one token a case); ``eval-predictions`` on
     ``eval``'s rows and on ``generate``'s predictions (each row's
     metrics ``score_report``'s); ``quant-report`` at μ²Qwen3-1.7B, full
     width and depth, random weights drawn on the card, int8 and int4,
     32 greedy tokens (the report, each leg's seconds, K1 144 and K2
     336); and the same command at 2 layers, int4, on the card and on the
     CPU from one checkpoint, per-layer SNR within 0.01 dB and the forward
     leg's KL and top-1 within limits that must reject int4 scales of
     max/8;
  8. drives the Phi phase (``drive_phi``) on the same CT: μ²Phi-3-mini
     (the default μ² stack on the ``phi3_mini`` decoder cut to 8 of its 32
     layers, 32 heads of 96, seeded weights) through ``drive_report``:
     exported by
     ``save_hf_checkpoint`` (fp32, as users write it) and read through
     its config.json alone by ``U2InferenceModel``, one greedy report
     (K1 12, K2 16) bit for bit the exported model's; its stage 1 on the
     same directory, ``cli train --qlora int8`` (``qlora_phase``: the
     decoder cut to 8 of its 32 layers by ``--config``, 4 steps of B=1
     at 1024 tokens on the stage-2 phase's cases, remat; each step's
     launches by head dim K1 12 at D=64, K2 16 and K4a-c 8 each at D=96,
     none at D=64 in the backward; one step profiled; the
     adapters file read back bit for bit; a checkpoint of the trainable
     leaves and the optimizer state), and its QLoRA step cut to 2 layers
     against the CPU (``check_train_reference(..., qlora="int8")``: the
     CLI's step, lora_b drawn at QLORA_B_STD so that every adapter has a
     gradient; the same limits must reject the planted faults at D=96;
     ``--qlora-reference-at`` reads it alone at other spreads); its B=4
     batches of 32 tokens, bf16 weights with the int8 cache and int8
     weights with the int4 cache (K3 32 a step); the Phi-2 decoder
     (GREEN-RadPhi2's architecture, seeded bf16 weights, an HF Phi-2
     directory) as the judge of ``cli green`` on the stage-2 phase's 16
     samples (K2 32 a batch at D=80), and in greedy B=4 batches over the
     int8 and int4 caches; both reduced to 2 decoder layers against the
     CPU's fp32 path within LOGIT_TOL;
  9. checks a reduced-depth, full-width model on the card against the same
     weights run in fp32 on the CPU through the plain versions: bf16
     weights with the int8 cache, int8 or int4 weights (quantized once on
     the CPU) with the int4 cache, and μ²Llama-3.2-1B with the bf16 cache;
     and (μ²Qwen3) with the chunked prefill, the shared-prefix prefill
     and a verify block written per row;
 10. drives the SFT training path: full-width μ²Qwen3-1.7B, the decoder
     at 14 of its 28 layers (TRAIN_LAYERS), with fp32 parameters and bf16
     compute, AdamW at the ``TrainConfig`` defaults,
     decoder layers rematerialised, 6 steps of ``run_training`` on one
     seeded (1, 8, 32, 256, 256) volume and a 1024-token row (900 valid),
     a checkpoint at the end; asserts finite, falling loss, moving
     parameters and the kernel launches of every step; profiles one step;
 11. runs one train step of the reduced-depth model on the card and on the
     CPU from the same weights and compares the loss and each parameter's
     gradient; shows that the same limits reject planted faults of the
     flash backward's wiring;
 12. drives the paper's stage-1 ablation matrix (``drive_ablation``) from
     the stage-2 phase's files and CT: ``cli train --attn-type rope`` at
     the released μ²Llama-3.2-1B config at 8 of its 16 decoder layers
     (``ablation_cli_config``; 2 steps, K1 12, K2 16 and K4a-c 20 a step),
     its fp32 export and ``cli demo --attention`` on it (K1 24, K2 8), the answer's tokens held to ``make_multimodal_generate_fn``
     driven here, the capture's image tokens to ``encode_vision``'s, every
     map's rows summing to 1 and the PNG's size; then the vanilla, LinVT
     (one chunk, no μ²tokenizer), sequence-pool and linear-projector
     variants at full width with a 4-layer decoder, each trained 2 steps
     through ``sft.make_trainer`` with a 32-token report, held to the same
     model in fp32 with the plain attention on the card (prefill logits,
     loss, gradients) and rejecting a planted fault of its own module; and
     'rma' over the linear projector's 2048 tokens raising;
 12a. drives segmentation and M3D-Bench (``drive_m3d``) at the released
     μ²Llama-3.2-1B configuration with the full SegVol head (seeded
     weights) on a synthetic M3D root (4 volumes of (8, 32, 256, 256),
     ball masks): ``cli eval-m3d`` for rec and reg (2 cases), seg (3) and
     refseg (2), 32 greedy tokens a case (K1 12, K2 16 a case; '[SEG]'
     is the first token greedy decoding emits on case 0, so the branch is
     taken), and itr (4 images, K1 12 each); the '[SEG]' generate of a
     2-layer model on the card against the CPU's fp32 (tokens under the
     near-tie rule, mask logits and their prompt part within 5e-2,
     rejecting the '[SEG]' state one row late and the pad gap left open);
     3 joint LM + seg steps of B=1 at 512 tokens through
     ``make_seg_train_step`` (K1 12, K2 16, K4a-c 28 a step) and the
     2-layer joint step against the CPU leaf by leaf (rejecting the
     planted faults of the flash backward's wiring); K2 and K4a-c at the
     phase's 512-row calls (untimed);
 12b. drives μ²Qwen3-8B (``drive_qwen3_8b``, the ``qwen3_8b`` decoder
     under the default μ² stack, seeded weights, full width):
     ``bench.py``'s 8B serving configuration (int8 weights, the int4
     cache, B=16, 1024-token prompts, the last 900, 64 greedy tokens,
     bench.py's 768 cut; the decoder at 18 of its 36 layers; K1 12, K2 18
     and K3-int4 18 a step) and its
     2-layer model against the CPU's fp32; ``cli train --qlora int4
     --freeze-vision-tower --remat dots_no_batch`` (the head in 8 tiles,
     the decoder at 12 of its 36 layers, 3 steps of B=1 at 1024 tokens;
     K1 12, K2 24 and K4a-c 12 a step;
     the adapters file read back bit for bit); the remat policies
     'nothing', 'dots_no_batch' and 'dots' on one step of the same model
     at 4 decoder layers (gradients within cosine 0.99999 and a norm
     ratio of 1e-4 of 'nothing''s, the same launches); then, on the report
     phase's μ²Llama-3.2-1B export, ``cli convert-checkpoint`` and ``cli
     generate`` from the converted directory (128 tokens equal to the HF
     directory's) and ``U2InferenceModel(lora_path=)`` (equal bit for
     bit to the adapters folded by hand, off the base, and an
     ``adapter_config.json`` with alpha = r rejected);
 12c. drives data preparation and the operator commands
     (``drive_dataprep``): ``cli preprocess`` over the report phase's CT
     copied into two directories under one name and a corrupt volume (exit
     1 with one FAILED line, the names ``a__ct`` and ``b__ct``, each array
     ``U2VolumeTransform()``'s bit for bit); the AMOS-MM, CT-RATE and
     AbdomenAtlas converters over synthetic trees; an ``AMOSMRGDataset``
     training item of the CT at full size against the CPU's; ``cli
     selftest`` on the card (its launches held to SELFTEST_LAUNCHES, one
     train step under ``utils.profiling.trace``, whose Chrome trace must
     name every tiny kernel); ``cli serve-llm`` at its default tiny preset
     answering a chat request (K2 2 at D=32); the tiny model's greedy
     decode over an int8 and an int4 cache (K3 at D=32, 14 each); and a
     failing command's
     crash report naming the card. The serving phase's ``serve-llm`` also
     runs the synthesis loop: rewrite, translate, QA and thinking through
     ``OpenAIProtocolClient`` (K2 16 a request);
 13. prints one JSON line per kernel table, the card line, and last
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
import io
import itertools
import json
import math
import os
import re
import shutil
import signal
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
# the B=112 path decodes MAX_NEW tokens (bench.py's 768, cut for the
# script's time to 512 when the ablation phase came, to 256 when the
# μ²Qwen3-8B phase came and to 128 when the data-preparation phase came),
# and K3 is checked at its steps
PROMPT, MAX_NEW, BATCH, VISION_MICROBATCH = 1024, 128, 4, 8
# the μ²Llama report and speculative phases decode 192 tokens (the users'
# 768 cut to 256 when the serving phase came and to 192 when the
# data-preparation phase came, for the script's time; the verify-fault
# runs compare FAULT_TOKENS of them)
REPORT_TOKENS = 192
# the B=4 bf16 path decodes 64 tokens (256 until the evaluation phase
# came, 128 until the mesh leg came), for the script's time on a slow host
B4_MAX_NEW = 64
RAGGED = 900               # the last row's prompt length
QUESTION = 64              # question tokens, the μ²tokenizer's text condition
# The serving configuration of the JAX package's bench.py: int8 decoder
# weights, int4 KV cache, 112 volumes, the ViT over groups of 128 chunks.
QUANT_BATCH, QUANT_WEIGHTS, QUANT_CACHE, QUANT_MICROBATCH = 112, "int8", \
    "int4", 128
# the training path: TRAIN_STEPS steps of μ²Qwen3-1.7B at full width, the
# decoder at TRAIN_LAYERS of its 28 layers (all 28 until the mesh leg came,
# cut for the script's time: the checkpoint and the steps scale with it)
TRAIN_STEPS, TRAIN_LAYERS = 6, 14
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
# The QLoRA step's adapters in that check: lora_b drawn from
# N(0, QLORA_B_STD^2) beside lora_a's N(0, 1/r), so that lora_a has a
# gradient and (alpha/r) lora_a @ lora_b has a spread of 2 QLORA_B_STD,
# about a tenth of the seeded decoder weights' (lecun normal, 0.018 at 3072
# inputs), as a trained adapter's change is. ``--qlora-reference-at``
# reads the same step at other spreads.
QLORA_B_STD = 1e-3


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


def card_trace(host_ops: bool = False):
    """torch.profiler over the card's kernels (CUPTI); ``device_time``
    reads it. Without ``host_ops`` no host op is recorded, so that the
    trace of a step of tens of thousands of launches is read in seconds;
    a window of a few short launches needs them, as the tracer starts to
    record the card a moment after the window opens (a trace of the card
    alone caught one and none of 7 launches of K4b at B=1 on the H100)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    return profile(activities=activities)


# traces ``device_ms`` may take of one call before it gives up
DEVICE_MS_TRACES = 4


def device_ms(torch, fn, kernel: str, calls: int = 7):
    """The median device time (ms) of the kernel whose ``__global__`` name
    is ``kernel`` over ``calls`` calls of ``fn`` (after one unprofiled),
    from torch.profiler's trace of the card and the host; each call
    launches it once. The trace may miss a launch at the end of the window
    (seen on the H100 with 4 ms launches), so it must hold at least half of
    them; a trace that holds fewer (seen on the H100: none and one of 7
    launches of K2 and of K4b, each in a kernel check) is taken again, up
    to DEVICE_MS_TRACES traces. Returns the time and each trace's count of
    launches, which the kernel checks print."""
    traced = []
    for _ in range(DEVICE_MS_TRACES):
        fn()
        torch.cuda.synchronize()
        with card_trace(host_ops=True) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels, _ = device_time(torch, prof)
        times = [e.time_range.elapsed_us() for e in kernels
                 if f"::{kernel}<" in e.name]
        traced.append(len(times))
        if calls // 2 <= len(times) <= calls:
            return statistics.median(times) / 1e3, traced
    raise AssertionError(f"device_ms: {traced} launches of {kernel} in "
                         f"{len(traced)} traces of {calls} calls")


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
# The stage-2 phase's calls (``drive_green_dpo``) at μ²Llama-3.2-1B: the
# DPO forward and backward, 2 rows of 512 + 1024 tokens, prompt (266:
# <user>, 256 image tokens, 8 question words, <assistant>) + chosen and
# prompt + rejected (256 sampled tokens and eos each); and the plain
# judge's prefill, 4 rows of 2048, its green prompts of 679 tokens (678
# where a sample holds a token the tokenizer skips). Timed here, with the
# other kernel checks; the phase checks the calls it made, untimed.
DPO_CALL = dict(causal=True, b=2, s=512 + 1024, h=32, hkv=8, d=64,
                lens=[266 + 257, 266 + 257], fused=False)
JUDGE_CALL = dict(causal=True, b=4, s=2048, h=32, hkv=8, d=64,
                  lens=[679, 679, 678, 679], fused=False)


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


def seen_keys(s: int, lens) -> int:
    """Key rows, over the batch, that a row's lens lets the kernels load."""
    return sum(min(n, s) for n in lens)


def sdpa_mask(torch, lens_t, s: int, causal: bool):
    """The boolean (B, 1, 1 or S, S) mask of SDPA's call: keys j < lens[b]
    (and j <= i when causal)."""
    keys = torch.arange(s, device="cuda")
    mask = (keys[None, :] < lens_t[:, None])[:, None, None, :]
    if causal:
        mask = mask & (keys[None, :] <= keys[:, None])[None, None]
    return mask


def check_flash(torch, F, fa, call: dict, seed: int, timed: bool = True,
                held: int = 0, profiled: bool = True):
    """K1 (a non-causal ``call``) or K2 (a causal one) on the batch of
    ``attention_inputs``, held against its plain version, whose mask the
    same limits must tell from one with lens[-1] one key off (a shift
    past the sequence leaves the mask as it is and is not made). With
    ``held`` only the batch's last ``held`` rows are held, and the plain
    version is timed on those. With ``timed`` False only the check runs
    and the times are None; with ``profiled`` False only the kernel and
    SDPA are timed (``time_ms``), not its device time nor the plain
    version."""
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

    ms = dev_ms = traced = plain_ms = library_ms = None
    if timed:
        ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, lens_t,
                                                       causal=causal))
        if profiled:
            dev_ms, traced = device_ms(torch, lambda: fa.flash_attention(
                q, k, v, lens_t, causal=causal), "flash_fwd_kernel")
            plain_ms = time_ms(torch, lambda: fa.flash_attention_reference(
                hq, hk, hv, hl, causal=causal), reps=3)
        mask = sdpa_mask(torch, lens_t, s, causal)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=hkv != h))
        del mask, qt, kt, vt

    # work this data needs; q and out are read or written once in full,
    # k and v only up to each row's lens (the kernel loads no tile past it)
    pairs = h * visible_pairs(causal, s, lens)  # one exponential each
    flops = 4.0 * d * pairs
    nbytes = 2.0 * 2 * b * s * h * d + 2.0 * 2 * hkv * d * seen_keys(s, lens)
    bms, by = bound_ms(flops, nbytes, pairs)
    return {"name": name, "route": "cuda",
            "source": "u2tokenizer_torch/csrc/flash_fwd.cu",
            "replaces": ("u2tokenizer_tpu/ops/flash_attention.py:73"
                         if causal else
                         "u2tokenizer_tpu/ops/flash_attention.py:45"),
            "max_abs_err": check.pop("max_abs_err"), "ms": ms,
            "device_ms": dev_ms, "device_ms_traced": traced,
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
                    "device_ms": e["device_ms"], "plain_ms": e["plain_ms"],
                    "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
                    "share_of_bound": e["bound_ms"] / e["ms"],
                    "device_share_of_bound": (e["bound_ms"] / e["device_ms"]
                                              if e["device_ms"] else None),
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

    ms = plain_ms = {"lse": None, "dq": None, "dkv": None}
    dev_ms = {key: (None, None) for key in ms}
    library_ms = None
    if timed:
        ms, dev_ms, plain_ms, library_ms = time_flash_bwd(
            torch, F, fa, q, k, v, do, lse_ref, dd, lens_t, kw)

    seen = visible_pairs(causal, s, lens)
    # k and v are read up to each row's lens; dk and dv are written in full
    q_bytes, kv_read, kv_bytes, stat_bytes = 2.0 * b * s * h * d, \
        2.0 * hkv * d * seen_keys(s, lens), 2.0 * b * s * hkv * d, \
        4.0 * b * h * s
    work = {"lse": (2.0 * d * h * seen, q_bytes + kv_read + stat_bytes),
            "dq": (6.0 * d * h * seen,
                   3 * q_bytes + 2 * kv_read + 2 * stat_bytes),
            "dkv": (8.0 * d * h * seen,
                    2 * q_bytes + 2 * kv_read + 2 * kv_bytes
                    + 2 * stat_bytes)}
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
            "max_abs_err": err, "ms": ms[key], "device_ms": dev_ms[key][0],
            "device_ms_traced": dev_ms[key][1],
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
                 timed: bool = True, heads=(16, 8, 128), new: int = MAX_NEW,
                 slots: int = PROMPT):
    """K3 at decode step ``step`` of a serving path: ``b`` rows, ``heads``
    (q heads, kv heads, head dim; μ²Qwen3-1.7B's 16 / 8 of 128 by
    default), an int8 (``bits`` 8) or packed int4 (4) cache of ``slots``
    (1024) + ``new`` slots, the rows' prompts ``prompt`` long (by default
    1024, the last row 900). Holds it to its plain version under TOL, shows that the same
    limits reject prompt_len[-1] and end one key off (and, at int4,
    nibbles read wrongly) and that a second call gives the same bits. With
    ``timed`` it is timed (CUDA events and device time) on caches cycled
    out of L2."""
    h, hkv, d = heads
    s_total = slots + new
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
    end = torch.full((b,), slots + step + 1, dtype=torch.int32,
                     device="cuda")
    kq, ks, vq, vs = caches[0]
    out = da.decode_attention_quantized(q, kq, ks, vq, vs, plen, end, slots)
    n_split = da.split_count(b, hkv, s_total, da.sm_count(q.device))
    again = da.decode_attention_quantized(q, kq, ks, vq, vs, plen, end,
                                          slots)
    ref = da.decode_attention_reference(q, kq, ks, vq, vs, plen, end, slots)
    visible = da.visible_keys(plen, end, slots, s_total)
    mutants = {}
    for shift in (-1, 1):  # each that moves the mask by a key
        off = plen.clone()
        off[-1] += shift
        if not torch.equal(da.visible_keys(off, end, slots, s_total),
                           visible):
            mutants[f"prompt_len[-1]{shift:+d}"] = \
                da.decode_attention_reference(q, kq, ks, vq, vs, off, end,
                                              slots)
        if not torch.equal(da.visible_keys(plen, end + shift, slots,
                                           s_total), visible):
            mutants[f"end{shift:+d}"] = da.decode_attention_reference(
                q, kq, ks, vq, vs, plen, end + shift, slots)
    if bits == 4:
        for order in ("swapped", "unsigned"):
            mutants[f"nibbles {order}"] = da.decode_attention_reference(
                q, nibbles(kq, torch, order), ks, nibbles(vq, torch, order),
                vs, plen, end, slots)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    check = compare(torch, out, ref, name, mutants)
    del mutants, again

    ms = dev_ms = traced = plain_ms = None
    if timed:
        it = iter(range(1 << 30))

        def run():
            kq, ks, vq, vs = caches[next(it) % len(caches)]
            da.decode_attention_quantized(q, kq, ks, vq, vs, plen, end,
                                          slots)

        ms = time_ms(torch, run, inner=32)
        dev_ms, traced = device_ms(torch, run, "decode_attn_kernel",
                                   calls=32)
        plain_ms = time_ms(torch, lambda: da.decode_attention_reference(
            q, kq, ks, vq, vs, plen, end, slots), inner=4)
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
            "device_ms": dev_ms, "device_ms_traced": traced,
            "n_split": n_split,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "check": check,
            "shape": {"q": list(q.shape), "k": list(kq.shape),
                      "prompt_len": plen_l if b <= 8 else
                      f"{plen_l[0]} x{b - 1}, {plen_l[-1]}",
                      "end": slots + step + 1, "step": step}}


def decode_summary(calls: dict) -> dict:
    """Per timed call of K3: n_split, time, device time and their shares
    of the bound."""
    return {label: {"kernel": e["name"], "n_split": e["n_split"],
                    "ms": e["ms"], "device_ms": e["device_ms"],
                    "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
                    "share_of_bound": e["bound_ms"] / e["ms"],
                    "device_share_of_bound": (e["bound_ms"] / e["device_ms"]
                                              if e["device_ms"] else None),
                    "shape": e["shape"]}
            for label, e in calls.items()}


# K3's untimed checks beside the three timed calls (step (MAX_NEW - 1) // 2
# at int8 and int4 B=4 and int4 B=112): the first and last decode steps at
# each; a batch with a 3-token prompt, whose (row, kv head)s are not split
# (fewer visible rows than csrc/decode_attention.cu's EXACT_ROWS), so that
# the other blocks of their grid columns find no rows, at steps 0 and
# (MAX_NEW - 1) // 2; and B=1. Each is (bits, batch, step, prompt).
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


def by_kernel(counts: dict) -> dict:
    """Launch counts by kernel, summed over the head dims that
    ``flash_attention`` counts them by ("flash_bwd_dq_d96")."""
    out = {}
    for key, n in counts.items():
        name = re.sub(r"_d\d+$", "", key)
        out[name] = out.get(name, 0) + n
    return out


def read_launches(*modules, by_dim: bool = False):
    """The launch counts of ``modules`` by kernel, or with ``by_dim`` as
    counted."""
    counts = {k: n for module in modules for k, n in module.launches.items()}
    return counts if by_dim else by_kernel(counts)


def drive_main_path(torch, max_new: int, batch: int, weights: str,
                    cache: str, vision_microbatch: int, cfg=None):
    """One serving run of full-width ``cfg`` (μ²Qwen3-1.7B by default)
    through ``make_multimodal_generate_fn``: weights cast to bf16 and, unless
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

    cfg = cfg or U2ModelConfig()  # μ²Qwen3-1.7B, full width and depth
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = cast_for_inference(U2CausalLM(cfg, dtype=torch.bfloat16,
                                          device="cuda", seed=0))
    if weights != "bf16":
        quantize_llm_weights(model, weights)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
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
    return {"model": model_label(cfg.llm), "batch": batch,
            "prompt": PROMPT,
            "prompt_len": f"{PROMPT} x{batch - 1}, {RAGGED}",
            "question_tokens": QUESTION, "max_new_tokens": max_new,
            "cache": cache, "weights": weights, "weight_gb": weight_gb,
            "vision_microbatch": vision_microbatch,
            "model_build_s": build_s, "build_peak_gb": build_peak / 1e9,
            "vision_s": t1 - t0,
            "prefill_s": t2 - t1, "decode_s": t3 - t2, "total_s": total,
            "reports_per_min": 60.0 * batch / total,
            "decode_ms_per_step": 1e3 * (t3 - t2) / max(max_new - 1, 1),
            "peak_mem_gb": peak / 1e9,
            "first_tokens": tokens[:4, :8].tolist(), "launches": launches,
            "decode_profile": profile}


def serve_and_check(torch, da, max_new: int, batch: int, weights: str,
                    cache: str, vision_microbatch: int, card: str, cfg=None,
                    label: str = "serve"):
    """``drive_main_path``, printed, with its launches held to what the
    code gives: K1 once per ViT layer per group of chunks, K2 once per
    decoder layer, the cache's K3 form once per decoder layer per decode
    step, no other kernel."""
    from u2tokenizer_torch.config import U2ModelConfig

    cfg = cfg or U2ModelConfig()
    run = drive_main_path(torch, max_new, batch, weights, cache,
                          vision_microbatch, cfg)
    run["card"] = card
    print(json.dumps({f"{label}_{weights}_weights_{cache}_cache": run}),
          flush=True)
    chunks = batch * 8
    groups = (chunks // vision_microbatch if chunks > vision_microbatch
              and chunks % vision_microbatch == 0 else 1)
    layers = cfg.llm.num_layers
    expected = {name: 0 for name in run["launches"]}
    expected.update({"flash_fwd_noncausal": cfg.vision.num_layers * groups,
                     "flash_fwd_causal": layers,
                     da.KERNELS[int(cache[3:])]: layers * (max_new - 1)})
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
    cache, tok, done, _ = generate.prefill_stage(embeds, prompt_len)
    tok, done, _ = generate.decode_steps(cache, tok, done, prompt_len,
                                         range(2))
    torch.cuda.synchronize()
    with card_trace() as prof:
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
MODEL_NAMES = {"qwen3": "mu2Qwen3-1.7B", "llama": "mu2Llama-3.2-1B",
               "phi3": "mu2Phi-3-mini", "phi2": "Phi-2"}


def model_label(llm) -> str:
    """The model a decoder config belongs to: MODEL_NAMES by family, the
    Qwen3 family's 4096-wide decoder μ²Qwen3-8B."""
    if llm.model_type == "qwen3" and llm.hidden_size == 4096:
        return "mu2Qwen3-8B"
    return MODEL_NAMES[llm.model_type]


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
    # drawn on the card and moved: the CPU's generator draws the 8B
    # widths' 2.4 B parameters several times slower
    cpu = U2CausalLM(cfg, dtype=torch.float32, device="cuda",
                     seed=1).to("cpu")
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
    return logits_line(results, model_label(cfg.llm), weights,
                       cache, variant)


def logits_line(results: dict, model: str, weights: str, cache,
                variant=None) -> dict:
    """A reduced-depth check's line: the card's prefill logits (and
    verify block's, where not None) against the CPU's, ``results`` "gpu"
    and "cpu" each (logits, greedy tokens, block logits or None), their
    relative error held to LOGIT_TOL, and the tokens' agreement."""
    (ref, tok_ref, block_ref), (out, tok_out, block_out) = \
        results["cpu"], results["gpu"]
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    agree = (tok_ref == tok_out).float().mean().item()
    line = {"model": model, "weights": weights, "cache": str(cache),
            "variant": variant or "one_shot", "logits_rel_err": rel,
            "logits_tol": LOGIT_TOL, "token_agreement": agree,
            "tokens_cpu": tok_ref.tolist(), "tokens_gpu": tok_out.tolist()}
    if block_ref is not None:
        line["verify_block_rel_err"] = ((block_out - block_ref).abs().max()
                                        / block_ref.abs().max()).item()
        rel = max(rel, line["verify_block_rel_err"])
    if not rel <= LOGIT_TOL:
        raise AssertionError(f"reduced {model}, {weights} weights, {cache} "
                             f"cache, {line['variant']}: card vs CPU logits "
                             f"relative error {rel:.4g} over {LOGIT_TOL}")
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
    for _ in range(4):
        cx, cy = rng.uniform(-0.2, 0.2, 2) * (nx, ny) + (nx / 2, ny / 2)
        cz, r = rng.uniform(0.2, 0.8) * nz, rng.uniform(15, 30)
        # the ball's voxels, in the volume's order, from its bounding box
        lo = [max(int(c - r) - 1, 0) for c in (cx, cy, cz)]
        hi = [min(int(c + r) + 2, n) for c, n in ((cx, nx), (cy, ny),
                                                  (cz, nz))]
        box = vol[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        blob = ((np.arange(lo[0], hi[0])[:, None, None] - cx) ** 2
                + (np.arange(lo[1], hi[1])[None, :, None] - cy) ** 2
                + (np.arange(lo[2], hi[2])[None, None, :] - cz) ** 2
                ) <= r * r
        box[blob] = 700.0 + rng.normal(0.0, 30.0, int(blob.sum()))
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


def drive_report(torch, fa, da, volume, tmp: str, cfg=None,
                 sampled: bool = True, config_json: bool = False,
                 max_new: int = REPORT_TOKENS):
    """The report path of ``cfg`` (μ²Llama-3.2-1B by default) at full width
    and depth: random weights from seed 0 written by ``save_hf_checkpoint``
    (fp32) to ``tmp/mu2<model_type>``, loaded back by ``U2InferenceModel``
    (bf16, bf16 cache; with ``config_json`` through config.json alone,
    ``u2_tpu_config.json`` removed), one greedy report of up to
    ``max_new`` tokens through ``inference`` with the kernel launches of
    that call (K1 once per ViT layer, K2 once per decoder layer); its
    tokens against ``make_multimodal_generate_fn`` on the in-memory model
    that was exported, cast the same way, stage by stage (timed); then,
    with ``sampled``, two sampled reports (top-p 0.9) from two instances of
    one seed. Returns the greedy report's tokens and the result line."""
    from u2tokenizer_torch.eval.inference import (U2InferenceModel,
                                                  load_model_config)
    from u2tokenizer_torch.models.generate import make_multimodal_generate_fn
    from u2tokenizer_torch.models.hf_export import save_hf_checkpoint
    from u2tokenizer_torch.models.quantize import cast_for_inference
    from u2tokenizer_torch.models.u2_model import U2CausalLM
    from u2tokenizer_torch.weights import flax_params

    cfg = cfg or released_config()
    model_name = model_label(cfg.llm)
    t0 = time.perf_counter()
    model = U2CausalLM(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    ckpt = os.path.join(tmp, f"mu2{cfg.llm.model_type}")
    gc.collect()
    t0 = time.perf_counter()
    save_hf_checkpoint(ckpt, flax_params(model), cfg)
    export_s = time.perf_counter() - t0
    ckpt_gb = sum(e.stat().st_size for e in os.scandir(ckpt)) / 1e9
    disk_free_gb = shutil.disk_usage(ckpt).free / 1e9
    if config_json:
        os.remove(os.path.join(ckpt, "u2_tpu_config.json"))
        if load_model_config(ckpt) != cfg:
            raise AssertionError(f"config.json reads as "
                                 f"{load_model_config(ckpt)}")
    cast_for_inference(model)  # the in-memory model, served as the loaded
    tok = full_vocab_tokenizer(cfg.llm.vocab_size)

    gc.collect()
    with host_memory() as host:
        t0 = time.perf_counter()
        im = U2InferenceModel(ckpt, tokenizer=tok, do_sample=False,
                              speculative=False,
                              max_new_tokens=max_new)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    seen, generate_tokens = [], im.generate_tokens
    im.generate_tokens = lambda *a: seen.append(generate_tokens(*a)) \
        or seen[-1]

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
        raise AssertionError(f"{model_name} report launches {launches} != "
                             f"{expected}")

    tokens = seen[0]
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
        raise AssertionError(f"loaded {model_name}'s tokens differ from the "
                             f"exported model's at steps {diff[:8]}")
    vocab = cfg.llm.vocab_size
    if not (tokens.shape == (max_new,) and ((tokens >= 0)
                                            & (tokens < vocab)).all()):
        raise AssertionError(f"report tokens {tokens.shape} out of range")
    del kv, embeds, ref_fn, model, im
    gc.collect()
    torch.cuda.empty_cache()
    line = {"model": model_name, "n_params": n_params,
            "weights": "bf16", "cache": "bf16", "question": REPORT_QUESTION,
            "prompt_len": plen, "max_new_tokens": max_new,
            "model_build_s": build_s, "export_s": export_s,
            "export": "save_hf_checkpoint, fp32",
            "checkpoint_gb": ckpt_gb, "disk_free_gb": disk_free_gb,
            "config_from": ("config.json" if config_json
                            else "u2_tpu_config.json"),
            "load_s": load_s, "load_host_gb": host,
            "report_s": report_s, **stages,
            "peak_mem_gb": peak / 1e9, "launches": launches,
            "tokens_equal_exported_model": True,
            "report_words": len(text.split()), "report_head": text[:80]}
    if not sampled:
        return tokens, line

    samples = []
    for _ in range(2):
        sim = U2InferenceModel(ckpt, tokenizer=tok, do_sample=True,
                               top_p=SAMPLE_TOP_P, speculative=False, seed=1,
                               max_new_tokens=max_new)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples.append(sim.inference(volume, REPORT_QUESTION))
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t0
        del sim
        gc.collect()
    if samples[0] != samples[1]:
        raise AssertionError("two sampled reports of one seed differ")
    if samples[0] == text:
        raise AssertionError("the sampled report is the greedy one")
    line["sampled"] = {"top_p": SAMPLE_TOP_P, "seed": 1,
                       "same_text_two_instances": True,
                       "report_s": sample_s,
                       "words": len(samples[0].split()),
                       "head": samples[0][:80]}
    return tokens, line


# Speculative decoding phase (``drive_speculative``).
SPEC_BLOCK = 8             # the verify block, as make_spec_generate_fn's
FANOUT = 8                 # samples a case, pred_then_green's protocol
# the fan-out phase's depth (the users' 768 cut; 256 until the evaluation
# phase came)
FANOUT_TOKENS = 128
SCRIPT_SEED = 7            # bench.py's report scripts
# the forced-content phase's depth (bench.py's 768 cut for the script's
# time, to 256 when the Phi phase came, to 128 when the evaluation phase
# came and to 64 when the M3D phase came; it launches no K3, so the B=112
# path's K3 checks stay at MAX_NEW)
FORCED_TOKENS = 64
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
    ViT over groups of 128 chunks, FORCED_TOKENS tokens scripted by
    ``report_token_scripts(112, FORCED_TOKENS + 8, vocab, seed=7)``; the
    inputs of the plain quantized run (``drive_main_path``), whose
    reports/min (at its own MAX_NEW tokens) and ms a step are set
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
    batch, max_new = QUANT_BATCH, FORCED_TOKENS
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
            "plain_max_new_tokens": plain_run["max_new_tokens"],
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
# cli serve --max-new-tokens (the users' 768; 256 before the Phi phase
# came, 128 before the evaluation phase, 64 before the data-preparation
# phase, cut for the script's time; the serving paths launch no K3)
SERVING_TOKENS = 32
SUBPROCESS_TOKENS = 16     # the subprocess server's one report
LLM_TOKENS = 64            # serve-llm's requests (128 until the
                           # data-preparation phase came)
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


def serving_tokenizer(vocab: int, extra=()):
    """A MockTokenizer with every word the serving phase sends first (and
    those of the texts ``extra``), then a word for every other id of the
    vocabulary."""
    from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer

    tok = MockTokenizer()
    tok(" ".join(SERVING_QUESTIONS + LLM_PROMPTS + tuple(extra)))
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


class NoReply(AssertionError):
    """A request to one of the script's servers that got no reply in its
    time."""


def thread_stacks(depth: int = 4) -> str:
    """The innermost ``depth`` frames of every other thread of this
    process, identical stacks counted once: where an in-process server
    that does not reply is waiting. The whole dump goes to stderr."""
    import collections
    import faulthandler
    import threading
    import traceback

    faulthandler.dump_traceback(sys.stderr, all_threads=True)
    me = threading.get_ident()
    stacks = collections.Counter()
    for ident, frame in sys._current_frames().items():
        if ident != me:
            stacks[" < ".join(
                f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                for f in reversed(traceback.extract_stack(frame)[-depth:]))] \
                += 1
    return "; ".join(f"{n} x [{s}]" for s, n in stacks.items())


def http(url: str, payload=None, data=None, headers=None, timeout=300):
    """(status, body bytes) of a GET, or a POST of ``payload`` as JSON or
    of raw ``data``; an HTTP error's status is returned, not raised. No
    reply in ``timeout`` seconds raises ``NoReply`` with this process's
    threads' stacks. The servers are local: no proxy of the environment is
    asked."""
    import urllib.error
    import urllib.request

    if payload is not None:
        data = json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"}
    req = urllib.request.Request(url, data=data, headers=headers or {})
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
    except (TimeoutError, urllib.error.URLError) as e:
        if not isinstance(getattr(e, "reason", e), TimeoutError):
            raise
        raise NoReply(f"{url}: no reply in {timeout} s; threads here: "
                      f"{thread_stacks()}") from e


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
    # a server that does not reply is stopped with SIGABRT, and Python's
    # fault handler writes its threads' stacks into the log
    env = dict(os.environ, PYTHONFAULTHANDLER="1")
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(cmd, stdout=log_file,
                                stderr=subprocess.STDOUT, env=env,
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
                except (OSError, NoReply):
                    pass
                time.sleep(0.5)
            up_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            out = http_ok(url + "/v1/report", {"image_path": ct_path,
                                               "question": REPORT_QUESTION},
                          timeout=120)
            report_s = time.perf_counter() - t1
        except Exception as e:
            if isinstance(e, NoReply) and proc.poll() is None:
                proc.send_signal(signal.SIGABRT)
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    pass
            proc.kill()
            proc.wait()
            with open(log_path) as f:
                tail = f.read()[-3000:]
            log(tail)
            if isinstance(e, NoReply):
                raise NoReply(f"cli serve: {e}; its log ends: "
                              f"{tail[-1500:]!r}") from e
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
    with card_trace() as prof:
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


# The synthesis loop (``data/synthesis.py``) against serve-llm: one report
# rewritten, translated, turned into QA pairs and given a refined chain of
# thought, each one request of the OpenAI-protocol client, whose
# ``max_tokens`` is set to the server's LLM_TOKENS (its default of 2048 is
# kept: a random-weights model rarely stops early).
SYNTHESIS_REPORT = ("The lungs are clear . There is no pleural effusion . "
                    "The heart is normal in size .")
SYNTHESIS_QUESTION = "Is there a pleural effusion ?"


def synthesis_ops():
    """(name, operation of a backend, the prompt it sends) of each
    synthesis request."""
    from u2tokenizer_torch.data import synthesis as syn

    r, q = SYNTHESIS_REPORT, SYNTHESIS_QUESTION
    return (
        ("rewrite", lambda b: syn.rewrite_report(b, r),
         f"{syn.rewrite_prompt}\n\nReport:\n{r}"),
        ("translate", lambda b: syn.translate_report(b, r),
         f"{syn.translate_prompt}\n\n{r}"),
        ("qa", lambda b: syn.generate_qa_pairs(b, r, 2),
         syn.qa_generation_prompt.format(n=2) + "\n\nReport:\n" + r),
        ("thinking", lambda b: syn.refine_thinking(b, r, q, "", r),
         syn.REFINE_PROMPT.format(report=r, question=q, thinking="",
                                  answer=r)))


@contextlib.contextmanager
def no_proxy():
    """The client's requests go to a local server: urllib asks no proxy of
    the environment inside the block."""
    saved = {k: os.environ.get(k) for k in ("no_proxy", "NO_PROXY")}
    os.environ["no_proxy"] = os.environ["NO_PROXY"] = "*"
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def synthesis_loop(url: str) -> dict:
    """Each synthesis operation through ``OpenAIProtocolClient`` to the
    server at ``url``; a request that gets no reply raises ``NoReply``
    with this process's threads' stacks, as ``http`` does."""
    import urllib.error

    from u2tokenizer_torch.data.synthesis import (LLMClientConfig,
                                                  OpenAIProtocolClient)

    client = OpenAIProtocolClient(LLMClientConfig(base_url=url + "/v1",
                                                  max_tokens=LLM_TOKENS))

    def backend(prompt: str) -> str:
        try:
            return client(prompt)
        except (TimeoutError, urllib.error.URLError) as e:
            if not isinstance(getattr(e, "reason", e), TimeoutError):
                raise
            raise NoReply(f"{url}: a synthesis request got no reply; "
                          f"threads here: {thread_stacks()}") from e

    out, times = {}, {}
    with no_proxy():
        for name, op, _ in synthesis_ops():
            t0 = time.perf_counter()
            result = op(backend)
            times[name] = time.perf_counter() - t0
            out[name] = (len(result) if isinstance(result, list)
                         else [len(x or "") for x in result]
                         if isinstance(result, tuple) else len(result))
    return {"requests": len(times), "request_s": times,
            "reply_sizes": out}


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

    tok = serving_tokenizer(LLMConfig.llama_3_2_1b().vocab_size,
                            [prompt for _, _, prompt in synthesis_ops()])
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
        reset_launches(fa, da)
        synthesis = synthesis_loop(url)
        synthesis_launches = nonzero(read_launches(fa, da, by_dim=True))
    finally:
        for s in servers:
            s.shutdown()
    expected = {name: 0 for name in launches}
    expected["flash_fwd_causal"] = 3 * lm.model.cfg.num_layers
    if launches != expected:
        raise AssertionError(f"serve-llm launches {launches} != {expected}")
    # one prefill a request (the verify blocks attend in plain PyTorch)
    expected = {"flash_fwd_causal_d64": synthesis["requests"]
                * lm.model.cfg.num_layers}
    if synthesis["requests"] < 4 or synthesis_launches != expected:
        raise AssertionError(f"synthesis loop: {synthesis['requests']} "
                             f"requests, launches {synthesis_launches} != "
                             f"{expected}")
    synthesis["launches"] = synthesis_launches
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
            "synthesis": synthesis,
            "launches": launches}, dict(
                launches, flash_fwd_causal=launches["flash_fwd_causal"]
                + synthesis_launches["flash_fwd_causal_d64"])


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


def serving_repeats(torch, fa, da, card: str, n: int) -> int:
    """The serving phase ``n`` times over one report phase's checkpoint
    and CT, each pass's seconds printed: a search for a server that stops
    replying (``NoReply`` names it). No result line."""
    with tempfile.TemporaryDirectory() as tmp:
        _, volume = check_ingest(torch, tmp)
        drive_report(torch, fa, da, volume, tmp)
        for i in range(n):
            t0 = time.perf_counter()
            drive_serving(torch, fa, da, volume, tmp, card)
            print(json.dumps({"serving_pass": i,
                              "s": time.perf_counter() - t0}), flush=True)
    return 0


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
    """SFT of full-width μ²Qwen3-1.7B, the decoder at TRAIN_LAYERS, through
    ``make_trainer`` and ``run_training``: ``steps`` steps on one seeded
    batch, a checkpoint at the end into a temporary directory, one more
    step profiled."""
    from u2tokenizer_torch.config import TrainConfig, U2ModelConfig
    from u2tokenizer_torch.models.u2_model import U2CausalLM
    from u2tokenizer_torch.train.loop import MetricLogger, run_training
    from u2tokenizer_torch.train.sft import make_trainer

    cfg = U2ModelConfig()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_layers=TRAIN_LAYERS))
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
        profile = profile_call(
            torch, fa, lambda: train_step(state, device_batch))[1]
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
    return {"model": "mu2Qwen3-1.7B", "decoder_layers": TRAIN_LAYERS,
            "params": "fp32", "compute": "bf16",
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


def profile_call(torch, fa, fn):
    """torch.profiler over one call of ``fn`` (a train step): the card's
    busy share of its wall clock and device time by kernel, with the
    shares of the flash forward and backward (their kernels matched by
    their ``__global__`` names); raises if either share reads 0 while the
    step launched its kernels. Returns (fn's result, the readings)."""
    before = read_launches(fa)
    torch.cuda.synchronize()
    with card_trace() as prof:
        t0 = time.perf_counter()
        out = fn()
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
    return out, {"wall_ms": wall_us / 1e3, "device_ms": busy_us / 1e3,
                 "device_busy_share": busy_us / wall_us,
                 "kernels": len(kernels), "launches_by_kernel": launched,
                 "flash_bwd_launches": bwd_launches,
                 "flash_bwd_share": bwd_share,
                 "flash_fwd_launches": fwd_launches,
                 "flash_fwd_share": fwd_share,
                 "top_device_ms": {n: t / 1e3 for n, t in top}}


def planted_faults(torch, fa, mha: bool = False):
    """Faults of the flash backward's wiring, as replacements of ``fa``'s
    kernel wrappers, that the training reference check must reject: dk
    without its scale, dd left out of dS, dk and dv summed over only the
    first q head of each GQA group (left out with ``mha``: with one q head
    a kv head it is the sound kernel), and lse taken over the keys past
    the causal frontier. (A key off by one at the end of ``lens`` is left
    to the kernel checks: in a causal layer only rows that the loss masks
    see it, and in the ViT it is one key of 2049 in one of 8 rows.)"""
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

    faults = {"dk unscaled": {"flash_bwd_dkv": dk_unscaled},
              "dd dropped": {"flash_bwd_dq": without_dd(dq),
                             "flash_bwd_dkv": without_dd(dkv)},
              "GQA sum of the first q head": {
                  "flash_bwd_dkv": first_head_only},
              "lse not causal": {"flash_bwd_lse": lse_not_causal}}
    if mha:
        del faults["GQA sum of the first q head"]
    return faults


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


def model_grads(model) -> dict:
    """{name: gradient} of every parameter of ``model`` (after a step;
    zeros where it has none)."""
    return {name: p.grad if p.grad is not None else p.detach() * 0
            for name, p in model.named_parameters()}


def gradient_readings(torch, grads, ref):
    """Per parameter of ``grads`` ({name: gradient}): the cosine of its
    gradient to ``ref``'s (flat fp64, on the host or the card) and the
    ratio of their norms, summed in fp64 where ``ref`` lies."""
    out = {}
    for name, grad in grads.items():
        r = ref[name]
        g = grad.double().flatten().to(r.device)
        gn, rn = g.norm().item(), r.norm().item()
        if gn == rn == 0:  # no path to the loss (the top-k's score net)
            out[name] = {"cos": 1.0, "norm_ratio": 1.0}
            continue
        out[name] = {"cos": torch.dot(g, r).item() / (gn * rn)
                     if gn * rn else 0.0,
                     "norm_ratio": gn / rn if rn else math.inf}
    return out


def card_reference(grads) -> dict:
    """The CPU's gradients as flat fp64 on the card, where
    ``gradient_readings`` then sums each card step's against them (moving
    every card step's gradients to the host instead took seconds a
    step)."""
    return {n: g.double().flatten().to("cuda") for n, g in grads.items()}


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


def misfits(readings, judge=judged):
    """The judged parameters whose gradient the limits reject."""
    return {name: r for name, r in readings.items()
            if judge(name)
            and not (r["cos"] >= TRAIN_COS_MIN
                     and abs(r["norm_ratio"] - 1) <= TRAIN_NORM_TOL)}


def worst_leaves(readings, judge=judged):
    """The lowest cosine and the norm ratio furthest from 1 among the
    judged parameters."""
    some = {n: r for n, r in readings.items() if judge(n)}
    c = min(some, key=lambda n: some[n]["cos"])
    q = max(some, key=lambda n: abs(some[n]["norm_ratio"] - 1))
    return {"min_cos": [c, some[c]["cos"]],
            "worst_norm_ratio": [q, some[q]["norm_ratio"]]}


def left_out_medians(readings, rule=left_out,
                     groups=("key_bias", "aggregator")):
    """Per group of ``rule`` that has parameters: its size and the median
    cosine and norm ratio of its parameters' gradients."""
    out = {}
    for group in groups:
        some = [r for n, r in readings.items() if rule(n) == group]
        if not some:
            continue
        out[group] = {"leaves": len(some), "median_cos": statistics.median(
            r["cos"] for r in some), "median_norm_ratio": statistics.median(
            r["norm_ratio"] for r in some)}
    return out


class GradientRecorder:
    """An optimizer for ``lora.make_qlora_train_step`` that keeps the
    gradients it is given and updates nothing."""

    def update(self, grads) -> None:
        self.grads = grads


def train_reference_readings(torch, fa, qlora=None, lora_b_std=None,
                             faults: bool = True):
    """One train step of the reduced-depth, full-width model (4 chunks, the
    fewest that give the μ²tokenizer's 1024-token top-k enough candidates;
    2 rows of 384 tokens, one valid for 300) on the CPU (fp32, plain
    versions) and, from the same weights, on the card (bf16 compute,
    kernels): sound, with the plain attention, and (with ``faults``) under
    each of ``planted_faults``. The model is μ²Qwen3-1.7B's, trained in
    full by ``sft.make_trainer``; or, with ``qlora`` ("int8" or "int4"),
    μ²Phi-3-mini's (heads of 96, MHA) as ``cli train --qlora`` sets it up
    (``lora.make_qlora_trainer``: fp32 on the CPU; on the card the
    μ²tokenizer and projector in bf16, then every leaf the CPU's), with
    lora_b drawn from N(0, ``lora_b_std``²) so that lora_a has a gradient,
    the gradients taken by ``lora.make_qlora_train_step`` (the CLI's step)
    with a ``GradientRecorder`` for optimizer. Returns the CPU's loss, the
    card's sound loss, and ``gradient_readings`` of the sound step, of the
    plain attention's and of each fault's, by parameter name."""
    from u2tokenizer_torch.config import TrainConfig
    from u2tokenizer_torch.models.u2_model import U2CausalLM
    from u2tokenizer_torch.train import lora
    from u2tokenizer_torch.train.sft import make_loss_fn, make_trainer

    cfg = reduced_config(num_chunks=4, base=phi3_config() if qlora else None)
    batch = training_batch(torch, cfg, 384, [384, 300], 280, seed=1)
    # μ²Phi-3's 0.66 B parameters are drawn on the card and moved: the
    # CPU's generator draws them several times slower
    cpu = U2CausalLM(cfg, dtype=torch.float32,
                     device="cuda" if qlora else "cpu", seed=1,
                     remat=True).to("cpu")
    gpu = U2CausalLM(cfg, dtype=torch.bfloat16, device="cuda", seed=2,
                     remat=True)
    cpu_train = gpu_train = None
    if qlora:
        cpu_train = lora.make_qlora_trainer(
            cpu, TrainConfig(bf16=False), 1, qlora)[0].train
        g = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for path, p in cpu_train.items():
                if path.endswith("/lora_b"):
                    p.normal_(0.0, lora_b_std, generator=g)
        gpu_train = lora.make_qlora_trainer(gpu, TrainConfig(), 1,
                                            qlora)[0].train
        names = {path: name for path, (name, _) in
                 lora.named_leaves(gpu).items()}
    gpu.load_state_dict(cpu.state_dict())
    weights = {k: v.clone() for k, v in gpu.state_dict().items()}

    def step(model, device_batch, train=None):
        """(loss, {name: gradient}) of one train step (QLoRA's over
        ``train``)."""
        if not qlora:
            state, train_step = make_trainer(model, TrainConfig(), 1)
            _, metrics = train_step(state, device_batch)
            return float(metrics["loss"]), model_grads(model)
        recorder = GradientRecorder()
        loss, _, _ = lora.make_qlora_train_step(recorder, make_loss_fn())(
            train, model, device_batch)
        return loss.item(), {names[path]: g
                             for path, g in recorder.grads.items()}

    loss_cpu, grads = step(cpu, batch, cpu_train)
    ref = card_reference(grads)
    del cpu, cpu_train, grads
    card_batch = {k: v.to("cuda") for k, v in batch.items()}

    def card_step(replacements):
        gpu.load_state_dict(weights)
        with planted(fa, replacements):
            loss, grads = step(gpu, card_batch, gpu_train)
        return loss, gradient_readings(torch, grads, ref)

    loss_gpu, sound = card_step({})
    plain = card_step(plain_attention(fa))[1]
    wrong = {label: card_step(rep)[1] for label, rep in planted_faults(
        torch, fa, mha=cfg.llm.num_heads == cfg.llm.num_kv_heads).items()
        } if faults else {}
    return loss_cpu, loss_gpu, sound, plain, wrong


def check_train_reference(torch, fa, qlora=None):
    """``train_reference_readings`` (μ²Qwen3's SFT step, or with ``qlora``
    μ²Phi-3's QLoRA step, lora_b drawn at QLORA_B_STD) held to
    TRAIN_LOSS_TOL, TRAIN_COS_MIN and TRAIN_NORM_TOL; fails unless the
    same limits reject every planted fault."""
    loss_cpu, loss_gpu, sound, plain, faults = train_reference_readings(
        torch, fa, qlora, QLORA_B_STD)
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
    return {"model": "mu2Phi-3-mini QLoRA " + qlora if qlora
            else "mu2Qwen3-1.7B", **({"lora_b_std": QLORA_B_STD} if qlora
                                     else {}),
            "loss_cpu": loss_cpu, "loss_gpu": loss_gpu,
            "loss_rel_err": rel,
            "loss_tol": TRAIN_LOSS_TOL, "grad_cos_min": TRAIN_COS_MIN,
            "grad_norm_tol": TRAIN_NORM_TOL,
            "leaves_held": sum(map(judged, sound)), "leaves": len(sound),
            "held": worst_leaves(sound),
            "left_out": {"kernels": left_out_medians(sound),
                         "plain_attention": left_out_medians(plain)},
            "plain_attention": worst_leaves(plain),
            "planted_faults": caught}


def qlora_reference_line(torch, fa, lora_b_std: float) -> dict:
    """The QLoRA step's readings (``train_reference_readings``, no faults)
    with lora_b drawn at ``lora_b_std``: the loss's relative error, and
    for the kernels and the plain attention the worst judged leaves, the
    median cosine and the leaves the limits reject."""
    loss_cpu, loss_gpu, sound, plain, _ = train_reference_readings(
        torch, fa, QLORA_MODE, lora_b_std, faults=False)
    line = {"lora_b_std": lora_b_std,
            "loss_rel_err": abs(loss_gpu - loss_cpu) / abs(loss_cpu)}
    for label, readings in (("kernels", sound), ("plain_attention", plain)):
        line[label] = {**worst_leaves(readings), "median_cos":
                       statistics.median(r["cos"] for n, r in
                                         readings.items() if judged(n)),
                       "misfits": len(misfits(readings))}
    return line


# ---------------------------------------------------------------------------
# Stage 1 from files and stage 2 (GREEN-guided DPO) through the CLI
# ---------------------------------------------------------------------------

# The μ²Llama-3.2-1B checkpoint of the report phase, three seeded CTs (the
# report phase's ct.nii is seed 0) and a jsonl of three cases. ``train``
# takes TRAIN_FILE_STEPS steps; ``generate`` samples GEN_SAMPLES reports
# of GEN_TOKENS tokens for the first GEN_CASES cases (the users' 768 tokens
# cut for the script's time); the judge
# scores them in batches of JUDGE_BATCH prompts padded to JUDGE_LENGTH
# (TorchJudge's defaults, the JAX package's), JUDGE_TOKENS greedy tokens
# each (TorchJudge's 600 cut for the script's time: 256 when the ablation
# phase came, 64 when the M3D phase came); ``dpo`` takes
# DPO_STEPS steps at the JAX defaults, and again with ``--ce-chunk``
# DPO_CE_CHUNK;
# a repeated pair at SEPARATE_LR, the JAX default, must separate (the
# first update, at lr 0, leaves the policy; the second moves it).
GREEN_CT_SEEDS = (0, 1, 2)
TRAIN_FILE_STEPS = 3
GEN_CASES, GEN_SAMPLES, GEN_TOKENS = 2, 8, 256
JUDGE_BATCH, JUDGE_LENGTH, JUDGE_TOKENS = 4, 2048, 64
DPO_STEPS, DPO_CE_CHUNK = 4, 256
SEPARATE_LR, SEPARATE_STEPS = 4e-6, 4
# step 0 of DPO is an identity (policy = reference): the sigmoid loss is
# ln 2 within LN2_TOL (one fp32 rounding) and every reward exactly 0
LN2_TOL = 1e-6
# the chunked completion log-probs sum in another order than the plain
# ones, so the two runs' losses may part by bf16 rounding; absolute, as
# one update at the default lr already takes the loss from ln 2 to ~1e-6
# (a random-weight model's 256-token log-probs move by tens of nats)
DPO_CE_TOL = 1e-3
# the packed layout attends in plain PyTorch (fp32 scores of bf16 inputs)
# where the unpacked takes K2: the log-probs of a 64-token completion,
# sums of ~11 nats a token, agree to bf16's 2^-8 relative
PACKED_TOL = 1e-2
GREEN_QUESTIONS = ("Describe the findings of this chest CT .",
                   "Write the radiology report for this CT .",
                   "What does this CT show ?")
REPORT_SENTENCES = (
    "The lungs are clear without focal consolidation .",
    "There is no pleural effusion or pneumothorax .",
    "The heart size is normal and the mediastinum is unremarkable .",
    "A small hypodense lesion is seen in segment {n} of the liver .",
    "The kidneys enhance symmetrically without hydronephrosis .",
    "There is mild degenerative change of the thoracic spine at level T{n} .",
    "No enlarged lymph nodes are seen in the hilar region .",
    "The adrenal glands and the pancreas are unremarkable .",
)
DPO_FAULTS = ("rows swapped", "completion mask shifted",
              "reference not detached")


def green_answer(case: int) -> str:
    """A reference report of ~100 words: long enough that the judge
    prompts of a case share more than 256 tokens, one bucket of the
    judge's shared prefix."""
    return " ".join(s.format(n=case + i + 2) for i in range(2)
                    for s in REPORT_SENTENCES)


def green_tokenizer(vocab: int, extra=()):
    """A MockTokenizer that knows every word the phase writes (the chat
    and GREEN templates, the questions, the reports) and those of the
    texts ``extra``, and a word for every other id of the vocabulary, and
    then refuses a word it does not know: an id past the vocabulary would
    fault the embedding on the card."""
    from u2tokenizer_torch.eval.green import make_green_prompt
    from u2tokenizer_torch.eval.inference import green_chat_format
    from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer

    class Closed(MockTokenizer):
        closed = False

        def _id(self, w):
            if self.closed and w not in self.vocab:
                raise KeyError(f"{w!r} is not in the phase's vocabulary")
            return super()._id(w)

    tok = Closed()
    # the dataset tokenizes prompt + answer as one text, which joins the
    # template's last word and the answer's first
    texts = [green_chat_format(make_green_prompt("", ""), "</s>"),
             tok.apply_chat_template([{"role": "user", "content": ""}]),
             *(tok.apply_chat_template([{"role": "user", "content": q}])
               + green_answer(i) for i, q in enumerate(GREEN_QUESTIONS))]
    tok(" ".join([*texts, *extra]))
    i = 0
    while len(tok.vocab) < vocab:  # filler words, past those already known
        n = vocab - len(tok.vocab)
        tok(" ".join(f"w{j}" for j in range(i, i + n)))
        i += n
    tok.closed = True
    assert len(tok.vocab) == vocab
    return tok


def write_green_data(tmp: str) -> str:
    """CTs of GREEN_CT_SEEDS (seed 0 the report phase's ``ct.nii``) and
    ``cases.jsonl`` under ``tmp/green_dpo``; returns that directory."""
    from u2tokenizer_torch.data.nifti import write_nifti

    data = os.path.join(tmp, "green_dpo")
    os.makedirs(data, exist_ok=True)
    images = ["../ct.nii"]
    for seed in GREEN_CT_SEEDS[1:]:
        images.append(f"ct{seed}.nii")
        write_nifti(os.path.join(data, images[-1]), synthetic_ct(seed=seed))
    with open(os.path.join(data, "cases.jsonl"), "w") as f:
        for i, image in enumerate(images):
            f.write(json.dumps({"image": image,
                                "question": GREEN_QUESTIONS[i],
                                "answer": green_answer(i)}) + "\n")
    return data


def hf_decoder_config(cfg) -> dict:
    """The ``config.json`` of an HF decoder directory for ``cfg``: the
    Llama family's fields, or HF Phi-2's (``model_type`` "phi",
    ``partial_rotary_factor``, ``layer_norm_eps``)."""
    config = {
        "model_type": "llama", "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim, "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "max_position_embeddings": cfg.max_position_embeddings}
    if cfg.model_type == "phi2":
        del config["rms_norm_eps"], config["head_dim"]
        config.update(model_type="phi", layer_norm_eps=cfg.rms_norm_eps,
                      partial_rotary_factor=cfg.partial_rotary_factor)
    elif cfg.rope_scaling_type:
        config["rope_scaling"] = {
            "rope_type": cfg.rope_scaling_type,
            "factor": cfg.rope_scaling_factor,
            "low_freq_factor": cfg.rope_low_freq_factor,
            "high_freq_factor": cfg.rope_high_freq_factor,
            "original_max_position_embeddings":
                cfg.rope_original_max_position}
    return config


def write_judge_dir(path: str, seed: int = 0,
                    preset: str = "llama_3_2_1b") -> None:
    """A judge for the card: the decoder ``preset`` with seeded weights, as
    an HF directory (bf16 ``model.safetensors`` through ``export_decoder``,
    and its ``config.json``)."""
    import torch

    from u2tokenizer_torch.config import LLMConfig
    from u2tokenizer_torch.models.hf_export import export_decoder
    from u2tokenizer_torch.models.layers import init_weights
    from u2tokenizer_torch.models.llm.decoder import CausalLM
    from u2tokenizer_torch.models.safetensors_io import write_safetensors
    from u2tokenizer_torch.weights import flax_params

    cfg = getattr(LLMConfig, preset)()
    model = CausalLM(cfg, dtype=torch.bfloat16, device="cuda")
    init_weights(model, seed)
    sd = {}
    export_decoder(flax_params(model)["params"], cfg, sd)
    del model
    os.makedirs(path, exist_ok=True)
    write_safetensors(os.path.join(path, "model.safetensors"),
                      {k: torch.from_numpy(v).to(torch.bfloat16)
                       for k, v in sd.items()})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_decoder_config(cfg), f, indent=2)


def cli_run(argv, **kw):
    """One subcommand of the port's CLI in this process, as ``python -m
    u2tokenizer_torch.cli`` runs it."""
    from u2tokenizer_torch import cli

    args = cli.build_parser().parse_args(argv)
    return args.fn(args, **kw)


def train_record(args, out) -> dict:
    """A train step's metrics and its batch's shape and valid lengths."""
    return {"metrics": {k: float(v) for k, v in out[1].items()},
            "shape": list(args[-1]["attention_mask"].shape),
            "lens": args[-1]["attention_mask"].sum(-1).tolist()}


@contextlib.contextmanager
def step_probe(torch, fa, da, module, name: str, unpack: bool = False,
               profile_at=None, record=train_record):
    """``module.<name>``, a factory of steps (returning the step, or
    (state, step, ...) with ``unpack``): train steps, or with another
    ``record`` any callable such as ``make_multimodal_generate_fn``'s,
    wrapped inside the block so that every step it makes is timed (host
    clock around a synchronize), and its kernel launches and ``record(step
    arguments, output)`` kept; with ``profile_at`` that step is run under
    ``profile_call``. Yields the list of records."""
    make = getattr(module, name)
    records = []

    def probed(*a, **kw):
        made = make(*a, **kw)
        step = made[1] if unpack else made

        def run(*args):
            before = read_launches(fa, da, by_dim=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            profile = None
            if profile_at == len(records):
                out, profile = profile_call(torch, fa, lambda: step(*args))
            else:
                out = step(*args)
            torch.cuda.synchronize()
            after = read_launches(fa, da, by_dim=True)
            by_dim = {k: n - before[k] for k, n in after.items()}
            records.append({
                "s": time.perf_counter() - t0, "profile": profile,
                "launches": by_kernel(by_dim),
                "launches_by_dim": by_dim, **record(args, out)})
            return out

        return (made[0], run, *made[2:]) if unpack else run

    setattr(module, name, probed)
    try:
        yield records
    finally:
        setattr(module, name, make)


def step_readings(records, skip: int = 1) -> dict:
    """s/step (median of the unprofiled steps after the first ``skip``),
    the per-step losses and the launches of one step."""
    timed = [r["s"] for r in records[skip:] if r["profile"] is None]
    return {"steps": len(records), "step_s": [r["s"] for r in records],
            "s_per_step": statistics.median(timed),
            "loss": [r["metrics"]["loss"] for r in records],
            "grad_norm": [r["metrics"]["grad_norm"] for r in records],
            "launches_per_step": records[-1]["launches"]}


def expect_launches(label: str, records, want: dict,
                    key: str = "launches") -> None:
    """Each step's launches (``key``: by kernel, or "launches_by_dim" by
    kernel and head dim) are ``want``, every other count 0."""
    for i, r in enumerate(records):
        got = {k: n for k, n in r[key].items() if n or k in want}
        if got != want:
            raise AssertionError(f"{label} step {i}: launches {got} != "
                                 f"{want}")


def train_file_argv(data: str, ckpt: str) -> list:
    """The stage-1 ``cli train`` leg's arguments but the output directory
    (the mesh leg's too)."""
    return ["train", "--pretrained", ckpt, "--tokenizer", "mock",
            "--train-base-path", data, "--train-jsonl-path", "cases.jsonl",
            "--max-steps", str(TRAIN_FILE_STEPS), "--batch-size", "1",
            "--max-length", "1024", "--num-workers", "2"]


def green_train_phase(torch, fa, da, tok, data: str, ckpt: str,
                      tmp: str) -> tuple:
    """``cli train`` from files: TRAIN_FILE_STEPS steps of B=1 over the
    jsonl with the training augmentations on the card, from the
    checkpoint; each step launches K1 12 (the ViT), K2 32 (16 decoder
    layers, forward again under remat) and K4a-c 28 each."""
    from u2tokenizer_torch.train import sft

    out = os.path.join(tmp, "sft")
    reset_launches(fa, da)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with step_probe(torch, fa, da, sft, "make_trainer", unpack=True) as recs:
        state = cli_run(train_file_argv(data, ckpt) + ["--output-dir", out],
                        tokenizer=tok)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_launches(fa, da)
    peak = torch.cuda.max_memory_allocated()
    del state
    expect_launches("train", recs, {
        "flash_fwd_noncausal": 12, "flash_fwd_causal": 32,
        "flash_bwd_lse": 28, "flash_bwd_dq": 28, "flash_bwd_dkv": 28})
    readings = step_readings(recs)
    if not all(math.isfinite(x) for x in readings["loss"]
               + readings["grad_norm"]):
        raise AssertionError(f"train from files: {readings}")
    ckpt_gb = sum(e.stat().st_size for e in os.scandir(
        os.path.join(out, "checkpoints", str(TRAIN_FILE_STEPS)))) / 1e9
    shutil.rmtree(out)
    return {**readings, "valid_tokens": [r["lens"] for r in recs],
            "cli_total_s": total_s, "checkpoint_gb": ckpt_gb,
            "peak_mem_gb": peak / 1e9}, launches


def green_generate_phase(torch, fa, da, tok, data: str, ckpt: str) -> tuple:
    """``cli generate --do-sample --num-samples 8`` for GEN_CASES cases:
    the speculative fan-out route (K1 12 and K2 16 a case); two rows of up
    to 8 predictions, every one but the last passing the validity
    filter."""
    from u2tokenizer_torch import cli

    preds = os.path.join(data, "preds.jsonl")
    loads = []
    load = cli._init_or_load

    def timed_load(*a, **kw):
        t0 = time.perf_counter()
        model = load(*a, **kw)
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t0)
        return model

    reset_launches(fa, da)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with planted(cli, {"_init_or_load": timed_load}):
        cli_run(["generate", "--checkpoint", ckpt, "--tokenizer", "mock",
                 "--base-path", data, "--jsonl-path", "cases.jsonl",
                 "--output", preds, "--do-sample", "--num-samples",
                 str(GEN_SAMPLES), "--max-new-tokens", str(GEN_TOKENS),
                 "--end", str(GEN_CASES)], tokenizer=tok)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_launches(fa, da)
    rows = [json.loads(line) for line in open(preds)]
    want = {name: 0 for name in launches}
    want.update({"flash_fwd_noncausal": 12 * GEN_CASES,
                 "flash_fwd_causal": 16 * GEN_CASES})
    if launches != want:
        raise AssertionError(f"generate launches {launches} != {want}")
    if len(rows) != GEN_CASES or not all(
            1 <= len(r["predictions"]) <= GEN_SAMPLES for r in rows):
        raise AssertionError(f"generate: {[len(r['predictions']) for r in rows]}"
                             " predictions a case")
    for r in rows:
        if not all(cli.check_report_validity(t)
                   for t in r["predictions"][:-1]):
            raise AssertionError("generate kept an invalid sample")
    return {"cases": GEN_CASES, "samples": GEN_SAMPLES,
            "max_new_tokens": GEN_TOKENS, "cli_total_s": total_s,
            "load_s": loads[0],
            "s_per_case": (total_s - loads[0]) / GEN_CASES,
            "kept": [len(r["predictions"]) for r in rows],
            "distinct": [len(set(r["predictions"])) for r in rows],
            "words": [[len(t.split()) for t in r["predictions"]]
                      for r in rows],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}, \
        launches, rows


def judge_near_tie(torch, plain_judge, ids, lens, plain, other) -> dict:
    """The near-tie rule (TIE_ULPS) for each row of a greedy judge batch
    ``other`` against the plain judge's tokens ``plain`` on the same
    padded batch: at the first index where a row differs, the plain
    path's top-two logits there must lie within the rule and the other
    route's token be the plain path's second choice."""
    first = {}
    for r in range(plain.shape[0]):
        d = (plain[r] != other[r]).nonzero()
        if len(d):
            first[r] = int(d[0, 0])
    rows = {r: {"first_diff": None, "holds": True}
            for r in range(plain.shape[0]) if r not in first}
    need = {i for i in first.values() if i > 0}
    seen = {}
    if need:
        gen = plain_judge._gen_for(ids.shape[0], 0)
        model = gen.model
        step, calls = model.decode_step, [0]

        def capture(*args, **kw):
            out = step(*args, **kw)
            calls[0] += 1
            if calls[0] in need:  # call k (from 1) gives token k
                seen[calls[0]] = out[0][:, 0].float().clone()
            return out

        model.decode_step = capture
        try:
            kv, tok0, done0, _ = gen.prefill_stage(
                model.embed_tokens(ids), lens)
            gen.decode_steps(kv, tok0, done0, lens, range(max(need)))
        finally:
            del model.decode_step
    for r, i in first.items():
        if i == 0:
            rows[r] = {"first_diff": 0, "holds": False}
            continue
        top = seen[i][r].topk(2)
        gap = (top.values[0] - top.values[1]).item()
        limit = TIE_ULPS * 2.0 ** -8 * abs(top.values[0].item())
        second = int(other[r, i]) == int(top.indices[1])
        rows[r] = {"first_diff": i, "top2": top.indices.tolist(),
                   "gap": gap, "limit": limit,
                   "other_token_is_second": second,
                   "holds": gap <= limit and second
                   and int(plain[r, i]) == int(top.indices[0])}
    return {"rows": rows, "holds": all(v["holds"] for v in rows.values())}


def green_judge_phase(torch, fa, da, tok, data: str, tmp: str,
                      rows) -> tuple:
    """``cli green`` with the decoder judge (the ``llama_3_2_1b`` preset,
    seeded bf16 weights): the GEN_CASES x GEN_SAMPLES predictions in
    batches of JUDGE_BATCH, speculative with the shared prefix; one
    batch's tokens against ``speculative=False, share_prefix=False`` under
    the near-tie rule, which must reject a shared prefix one bucket (256)
    too long; then one batch with ``--judge-weights int8``. Random weights
    give replies that parse to no score."""
    from u2tokenizer_torch import cli
    from u2tokenizer_torch.eval import green
    from u2tokenizer_torch.eval.inference import green_chat_format

    judge_dir = os.path.join(tmp, "judge")
    t0 = time.perf_counter()
    write_judge_dir(judge_dir)
    write_s = time.perf_counter() - t0
    built, batches = [], []
    build, tokens_of = cli._build_judge, green.TorchJudge.batch_tokens

    def timed_build(*a, **kw):
        t0 = time.perf_counter()
        built.append(build(*a, **kw))
        built[-1].gen_cfg = dataclasses.replace(
            built[-1].gen_cfg, max_new_tokens=JUDGE_TOKENS)
        torch.cuda.synchronize()
        built[-1].build_s = time.perf_counter() - t0
        return built[-1]

    def timed_tokens(judge, ids, lens, split):
        before = read_launches(fa, da)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tokens_of(judge, ids, lens, split)
        torch.cuda.synchronize()
        after = read_launches(fa, da)
        batches.append({"s": time.perf_counter() - t0, "split": split,
                        "lens": lens.tolist(),
                        "launches": {k: n - before[k]
                                     for k, n in after.items() if n - before[k]},
                        "inputs": (ids, lens, split, out)})
        return out

    def run_green(preds, output, *extra):
        del batches[:]
        torch.cuda.reset_peak_memory_stats()
        with planted(cli, {"_build_judge": timed_build}), \
                planted(green.TorchJudge, {"batch_tokens": timed_tokens}):
            t0 = time.perf_counter()
            cli_run(["green", "--predictions", preds, "--judge", judge_dir,
                     "--output", output, *extra], tokenizer=tok)
            total = time.perf_counter() - t0
        first = batches[0]["inputs"]
        for b in batches:
            del b["inputs"]
        return first, {"batches": len(batches), "cli_total_s": total,
                "build_s": built[-1].build_s,
                "s_per_batch": statistics.median(b["s"] for b in batches),
                "batch_s": [b["s"] for b in batches],
                "shared_prefix": [b["split"] for b in batches],
                "prompt_lens": [b["lens"] for b in batches],
                "launches_per_batch": [b["launches"] for b in batches],
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}

    preds = os.path.join(data, "preds.jsonl")
    reset_launches(fa, da)
    (ids, lens, split, spec_tokens), bf16 = run_green(
        preds, os.path.join(data, "greened_judge.jsonl"))
    launches = read_launches(fa, da)
    n_prompts = sum(len(r["predictions"]) for r in rows)
    if bf16["batches"] != sum(math.ceil(len(r["predictions"]) / JUDGE_BATCH)
                              for r in rows):
        raise AssertionError(f"judge batches {bf16['batches']} for "
                             f"{n_prompts} prompts")
    greened = [json.loads(line) for line in open(
        os.path.join(data, "greened_judge.jsonl"))]
    scores = [s for r in greened for s in r["green_scores"]]
    judge = built[-1]

    # the first batch (the first case's first four samples) held against
    # the plain judge on the same prompts
    chunk = [green_chat_format(green.make_green_prompt(
        rows[0]["answer"], p), "</s>") for p in rows[0]["predictions"][:4]]
    plain_judge = green.TorchJudge(judge.model, tok,
                                   max_new_tokens=JUDGE_TOKENS,
                                   speculative=False, share_prefix=False)
    p_ids, p_lens, _ = plain_judge.batch_inputs(chunk)
    if not (torch.equal(p_ids, ids) and torch.equal(p_lens, lens)):
        raise AssertionError("the two judges padded the batch differently")
    t0 = time.perf_counter()
    plain_tokens = plain_judge.batch_tokens(ids, lens, 0)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    sound = judge_near_tie(torch, plain_judge, ids, lens, plain_tokens,
                           spec_tokens)
    if not sound["holds"]:
        raise AssertionError(f"speculative shared-prefix judge against the "
                             f"plain judge: {sound}")
    if split + 256 >= int(lens.min()):
        raise AssertionError(f"no room for the planted prefix fault: split "
                             f"{split}, lens {lens.tolist()}")
    faulty = judge.batch_tokens(ids, lens, split + 256)
    fault = judge_near_tie(torch, plain_judge, ids, lens, plain_tokens,
                           faulty)
    if fault["holds"]:
        raise AssertionError("the near-tie rule does not reject a shared "
                             f"prefix one bucket too long: {fault}")
    judge_lens = lens.tolist()
    del judge, plain_judge, built[:], spec_tokens, plain_tokens, faulty
    gc.collect()
    torch.cuda.empty_cache()

    one = os.path.join(data, "preds_one_batch.jsonl")
    with open(one, "w") as f:
        f.write(json.dumps(dict(rows[0], predictions=rows[0]["predictions"]
                                [:JUDGE_BATCH])) + "\n")
    _, int8 = run_green(one, os.path.join(data, "greened_int8.jsonl"),
                        "--judge-weights", "int8", "--no-summary")
    built.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return {"judge": "llama_3_2_1b preset, seeded bf16 weights",
            "write_judge_s": write_s, "prompts": n_prompts,
            "batch": JUDGE_BATCH, "max_length": JUDGE_LENGTH,
            "max_new_tokens": JUDGE_TOKENS, "bf16": bf16, "int8": int8,
            "scores_parsed": sum(s is not None and s != 0 for s in scores),
            "plain_batch_s": plain_s, "near_tie": sound,
            "planted_prefix_fault": {"split": split + 256, **fault}}, \
        launches, judge_lens


def green_stub_phase(data: str, rows) -> dict:
    """``cli green`` with the stub judge (every score 1.0, the samples'
    order kept), then ``cli dpo-convert``: one pair a case, chosen the
    first sample and rejected the last."""
    greened = os.path.join(data, "greened_stub.jsonl")
    pairs = os.path.join(data, "pairs.jsonl")
    cli_run(["green", "--predictions", os.path.join(data, "preds.jsonl"),
             "--output", greened])
    cli_run(["dpo-convert", "--greened", greened, "--output", pairs])
    out = [json.loads(line) for line in open(pairs)]
    if len(out) != GEN_CASES:
        raise AssertionError(f"dpo-convert: {len(out)} pairs")
    for pair, row in zip(out, rows):
        if (pair["chosen"] == pair["rejected"]
                or pair["chosen"] != row["predictions"][0]
                or pair["rejected"] != row["predictions"][-1]):
            raise AssertionError("dpo-convert: the pair is not (first, last) "
                                 "of distinct samples")
    with open(os.path.join(data, "pairs_one.jsonl"), "w") as f:
        f.write(json.dumps(out[0]) + "\n")
    return {"pairs": len(out),
            "chosen_words": [len(p["chosen"].split()) for p in out],
            "rejected_words": [len(p["rejected"].split()) for p in out]}


def green_dpo_run(torch, fa, da, tok, data: str, ckpt: str, tmp: str,
                  pairs: str, steps: int, *extra, profile_at=None):
    """``cli dpo`` over ``pairs`` for ``steps`` steps; (step readings,
    launches, peak memory GB)."""
    from u2tokenizer_torch.train import dpo

    reset_launches(fa, da)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with step_probe(torch, fa, da, dpo, "make_dpo_train_step",
                    profile_at=profile_at) as recs:
        state, ref = cli_run(["dpo", "--pretrained", ckpt, "--tokenizer",
                              "mock", "--train-base-path", data,
                              "--train-jsonl-path", pairs, "--max-steps",
                              str(steps), "--output-dir",
                              os.path.join(tmp, "dpo"), *extra],
                             tokenizer=tok)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches(fa, da)
    del state, ref
    gc.collect()
    torch.cuda.empty_cache()
    expect_launches("dpo", recs, {
        "flash_fwd_noncausal": 24, "flash_fwd_causal": 48,
        "flash_bwd_lse": 28, "flash_bwd_dq": 28, "flash_bwd_dkv": 28})
    return recs, {**step_readings(recs), "cli_total_s": total,
                  "peak_mem_gb": peak / 1e9,
                  "rewards_margin": [r["metrics"]["rewards_margin"]
                                     for r in recs],
                  "lens": recs[0]["lens"]}, launches


def swap_rows(batch: dict) -> dict:
    """A preference batch with its chosen and rejected rows swapped."""
    b = batch["input_ids"].shape[0] // 2
    out = dict(batch)
    for key in ("input_ids", "attention_mask", "completion_mask"):
        out[key] = batch[key].roll(b, dims=0)
    return out


def shift_mask(batch: dict) -> dict:
    """A preference batch with its completion mask one token late."""
    return dict(batch, completion_mask=batch["completion_mask"].roll(1, 1))


def undetached_loss(dpo):
    """make_dpo_loss_fn with the reference forward run on the policy with
    grad: at step 0 the policy and reference terms cancel in the
    gradient."""
    def make(cfg):
        def loss_fn(model, ref_model, batch):
            logps = dpo._completion_logps(model, batch, False)
            ref_logps = dpo._completion_logps(model, batch, False)
            b = logps.shape[0] // 2
            loss, _ = dpo.dpo_loss(logps[:b], logps[b:], ref_logps[:b],
                                   ref_logps[b:], cfg)
            return loss, {"loss": loss.detach()}
        return loss_fn
    return make


def dpo_left_out(name: str):
    """``left_out``, and the leaves that the released configuration's
    DiffTS and DMTP add (the training check's μ²Qwen3 has neither):
    DMTP's gate, whose gradient is zero in exact arithmetic (the gates of
    the scales differ only by means of the same tokens, which average
    pooling keeps, and by the bias they share, and the softmax over them
    is invariant to what they share), and DiffTS's score net, whose
    gradient reaches the loss only through softmaxes over 1024 bf16
    scores, as the aggregator's does."""
    if name.endswith(("dynamic_pool.gate_kernel", "dynamic_pool.gate_bias")):
        return "dmtp_gate"
    if name.startswith("u2tokenizer.svt_module.token_selection.score_net"):
        return "diffts_score"
    return left_out(name)


def dpo_judged(name: str) -> bool:
    return dpo_left_out(name) is None


DPO_LEFT_OUT = ("key_bias", "aggregator", "dmtp_gate", "diffts_score")


def dpo_reference_readings(torch, fa, tok):
    """One DPO step (step 0, the reference the policy's frozen copy) of
    the reduced-depth, full-width μ²Llama-3.2-1B (4 chunks) on the CPU
    (fp32, plain versions) and, from the same weights, on the card (bf16
    compute, kernels): sound and under each of DPO_FAULTS. One pair of a
    320-token prompt and 12- and 8-token completions (rows of 384).
    Returns the CPU's loss and log-probs, the card's, the gradient
    readings of the sound step and of each fault, and the card's packed
    log-probs against its unpacked ones."""
    from u2tokenizer_torch.config import DPOConfig, TrainConfig
    from u2tokenizer_torch.models.u2_model import U2CausalLM
    from u2tokenizer_torch.train import dpo
    from u2tokenizer_torch.train.sft import TrainState, make_optimizer

    cfg = reduced_config(num_chunks=4, base=released_config())
    g = torch.Generator().manual_seed(3)
    d, h, w = cfg.vision.input_spatial
    q = tok(GREEN_QUESTIONS[0])["input_ids"]
    sample = {
        "prompt": tok.apply_chat_template([{"role": "user", "content":
                                            "<im_patch>" * cfg.proj_out_num
                                            + GREEN_QUESTIONS[0]}]),
        "chosen": " ".join(f"w{i}" for i in torch.randint(
            0, 100000, (12,), generator=g).tolist()),
        "rejected": " ".join(f"w{i}" for i in torch.randint(
            0, 100000, (8,), generator=g).tolist()),
        "image": torch.randn(cfg.num_chunks, d, h, w, generator=g),
        "prompt_question_ids": q + [0] * (64 - len(q))}
    batch = dpo.collate_preference_batch([sample], tok, 320, 64)
    packed = dpo.collate_packed_preference_batch([sample], tok, 320, 64)

    def step(model, ref, batch, cfg_=DPOConfig()):
        state = TrainState(0, model, make_optimizer(TrainConfig(),
                                                    model.parameters(), 1))
        _, metrics = dpo.make_dpo_train_step(model, cfg_)(state, ref, batch)
        return float(metrics["loss"])

    cpu = U2CausalLM(cfg, dtype=torch.float32, device="cpu", seed=1,
                     remat=True)
    gpu = U2CausalLM(cfg, dtype=torch.bfloat16, device="cuda", seed=2,
                     remat=True)
    gpu.load_state_dict(cpu.state_dict())
    weights = {k: v.clone() for k, v in gpu.state_dict().items()}
    with torch.no_grad():
        logps_cpu = dpo._completion_logps(cpu, batch, False)
    loss_cpu = step(cpu, dpo.frozen_reference(cpu), batch)
    ref = card_reference({n: p.grad for n, p in cpu.named_parameters()})
    del cpu
    card = dpo.to_device(batch, "cuda")

    def card_step(batch, replacements=None, attention=None):
        gpu.load_state_dict(weights)
        with planted(dpo, replacements or {}), planted(fa, attention or {}):
            loss = step(gpu, dpo.frozen_reference(gpu), batch)
        return loss, gradient_readings(torch, model_grads(gpu), ref)

    loss_gpu, sound = card_step(card)
    plain = card_step(card, attention=plain_attention(fa))[1]
    with torch.no_grad():
        logps_gpu = dpo._completion_logps(gpu, card, False)
        logps_packed = dpo._packed_completion_logps(
            gpu, dpo.to_device(packed, "cuda"), False)
    packed_loss = step(gpu, dpo.frozen_reference(gpu),
                       dpo.to_device(packed, "cuda"), DPOConfig(packed=True))
    faults = {
        "rows swapped": card_step(swap_rows(card))[1],
        "completion mask shifted": card_step(shift_mask(card))[1],
        "reference not detached": card_step(card, {
            "make_dpo_loss_fn": undetached_loss(dpo)})[1]}
    del gpu, weights
    return {"loss_cpu": loss_cpu, "loss_gpu": loss_gpu,
            "logps_cpu": logps_cpu.tolist(),
            "logps_gpu": logps_gpu.float().cpu().tolist(),
            "logps_packed": logps_packed.float().cpu().tolist(),
            "packed_loss": packed_loss,
            "seq": batch["input_ids"].shape[1],
            "valid": batch["attention_mask"].sum(-1).tolist()}, sound, \
        plain, faults


def check_dpo_reference(torch, fa, tok) -> dict:
    """``dpo_reference_readings`` held to TRAIN_LOSS_TOL (the loss and the
    log-probs), TRAIN_COS_MIN and TRAIN_NORM_TOL (each gradient that
    ``dpo_judged`` holds; the left-out groups' medians are reported, with
    the kernels and with the plain attention on the card);
    the packed log-probs to PACKED_TOL of the unpacked on the card; fails
    unless the limits reject every fault of DPO_FAULTS."""
    line, sound, plain, faults = dpo_reference_readings(torch, fa, tok)
    rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))
    line["loss_rel_err"] = abs(line["loss_gpu"] - line["loss_cpu"]) \
        / abs(line["loss_cpu"])
    line["logps_rel_err"] = rel(line["logps_gpu"], line["logps_cpu"])
    line["packed_rel_err"] = rel(line["logps_packed"], line["logps_gpu"])
    if not (line["loss_rel_err"] <= TRAIN_LOSS_TOL
            and line["logps_rel_err"] <= TRAIN_LOSS_TOL):
        raise AssertionError(f"reduced DPO step: card vs CPU {line}")
    if not line["packed_rel_err"] <= PACKED_TOL:
        raise AssertionError(f"packed against unpacked log-probs on the "
                             f"card: {line['packed_rel_err']:.4g}")
    if abs(line["packed_loss"] - math.log(2)) > LN2_TOL:
        raise AssertionError(f"packed step 0 loss {line['packed_loss']}")
    bad = misfits(sound, dpo_judged)
    if bad:
        raise AssertionError(f"reduced DPO step: gradients off the CPU's: "
                             f"{bad}")
    caught = {}
    for label, readings in faults.items():
        bad = misfits(readings, dpo_judged)
        if not bad:
            raise AssertionError(f"the DPO reference limits do not reject "
                                 f"the planted fault {label}: "
                                 f"{worst_leaves(readings, dpo_judged)}")
        caught[label] = {**worst_leaves(readings, dpo_judged),
                         "leaves_rejected": len(bad)}
    medians = lambda r: left_out_medians(r, dpo_left_out, DPO_LEFT_OUT)
    return {**line, "loss_tol": TRAIN_LOSS_TOL, "packed_tol": PACKED_TOL,
            "grad_cos_min": TRAIN_COS_MIN, "grad_norm_tol": TRAIN_NORM_TOL,
            "leaves_held": sum(map(dpo_judged, sound)),
            "leaves": len(sound), "held": worst_leaves(sound, dpo_judged),
            "left_out": {"kernels": medians(sound),
                         "plain_attention": medians(plain)},
            "plain_attention": worst_leaves(plain, dpo_judged),
            "planted_faults": caught}


# The mesh leg: the stage-1 ``cli train`` leg's files, checkpoint, config
# and seeds on the (data, fsdp, tensor) mesh of one rank a visible card (at
# most one a case of the jsonl) under ``torch.distributed.run``, each rank
# this script in MESH_RANK_FLAG mode. At one card its losses are the
# one-card leg's within MESH_LOSS_RTOL (the same rows and weights through
# ``sft.make_sharded_trainer``, whose loss sums in another order), its
# launches a step the same. The ranks start before the stage-2 files are
# written and wait, their imports and kernel loads done, for the go file
# (``start_mesh_train``), which the phase writes after the one-card leg
# (``finish_mesh_train``): their start-up runs beside the files' writing
# and the one-card leg, and the leg's seconds count from the go.
MESH_RANK_FLAG = "--mesh-train-rank"
MESH_LOSS_RTOL = 2e-3
MESH_GO_POLL_S = 0.2
MESH_GO_WAIT_S = 900  # a rank gives up if the go file has not come


def mesh_train_rank(out: str, argv) -> int:
    """One rank of the mesh leg: once ``out``.go exists, ``cli train``
    (``argv``) with the phase's closed tokenizer, every step timed and its
    launches kept by ``step_probe`` around ``sft.make_sharded_trainer``;
    rank 0 writes the readings to ``out``."""
    t_setup = time.perf_counter()
    import torch

    from u2tokenizer_torch.ops import _build
    from u2tokenizer_torch.ops import decode_attention as da
    from u2tokenizer_torch.ops import flash_attention as fa
    from u2tokenizer_torch.train import sft

    _build.build_all()
    tok = green_tokenizer(released_config().llm.vocab_size)
    ready_s = time.perf_counter() - t_setup
    while not os.path.exists(out + ".go"):
        if time.perf_counter() - t_setup > MESH_GO_WAIT_S:
            log("mesh leg: no go file; the script that started it is gone")
            return 1
        time.sleep(MESH_GO_POLL_S)
    reset_launches(fa, da)
    t0 = time.perf_counter()
    with step_probe(torch, fa, da, sft, "make_sharded_trainer",
                    unpack=True) as recs:
        state = cli_run(argv, tokenizer=tok)
    total = time.perf_counter() - t0
    launches = read_launches(fa, da)
    if os.environ.get("RANK", "0") == "0":
        with open(out, "w") as f:
            json.dump({"records": [{k: r[k] for k in ("s", "metrics",
                                                      "launches")}
                                   for r in recs],
                       "world": int(os.environ.get("WORLD_SIZE", "1")),
                       "mesh": dataclasses.asdict(state.mesh.cfg),
                       "launches": launches,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "rank_ready_s": ready_s, "cli_total_s": total}, f)
    return 0


def start_mesh_train(torch, argv, tmp: str) -> dict:
    """Start the mesh leg's ranks (a ``torch.distributed.run`` subprocess,
    its output in ``tmp/mesh_train.log``) on the stage-1 leg's ``argv``
    with ``--mesh-fsdp`` the number of cards; they wait for the go file of
    ``finish_mesh_train``. Returns what that and ``stop_mesh_train``
    take."""
    cards = min(torch.cuda.device_count(), len(GREEN_CT_SEEDS))
    out = os.path.join(tmp, "mesh_train.json")
    log_path = os.path.join(tmp, "mesh_train.log")
    argv = [*argv, "--output-dir", os.path.join(tmp, "sft_mesh"),
            "--mesh-fsdp", str(cards)]
    log_file = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(cards), os.path.abspath(__file__),
         MESH_RANK_FLAG, out, *argv], stdout=log_file,
        stderr=subprocess.STDOUT,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    return {"proc": proc, "log": log_file, "log_path": log_path, "out": out,
            "cards": cards, "tmp": tmp}


def stop_mesh_train(started: dict) -> None:
    """Stop the mesh leg's ranks if they still run (a failure before or
    during the leg), and close its log."""
    proc = started["proc"]
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    started["log"].close()


def finish_mesh_train(torch, started: dict, single: dict) -> dict:
    """Let the started ranks train and read them: losses within
    MESH_LOSS_RTOL of the one-card leg's (``single``) at one card, K1, K2
    and K4a-c launches a step equal to its, the run's launches its steps'
    alone, s/step and peak memory with the world size and the mesh."""
    proc, out, cards = started["proc"], started["out"], started["cards"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with open(out + ".go", "w"):
        pass
    try:
        proc.wait(600)
    except subprocess.TimeoutExpired:
        stop_mesh_train(started)
    total = time.perf_counter() - t0
    started["log"].flush()
    if proc.returncode:
        with open(started["log_path"]) as f:
            tail = f.read()[-3000:]
        raise AssertionError(f"the mesh leg exited {proc.returncode}: "
                             f"{tail}")
    with open(out) as f:
        got = json.load(f)
    shutil.rmtree(os.path.join(started["tmp"], "sft_mesh"),
                  ignore_errors=True)
    recs = got.pop("records")
    loss = [r["metrics"]["loss"] for r in recs]
    if len(recs) != TRAIN_FILE_STEPS or not all(map(math.isfinite, loss)):
        raise AssertionError(f"mesh leg: {recs}")
    want = {k: n for k, n in single["launches_per_step"].items() if n}
    for i, r in enumerate(recs):
        got_launches = {k: n for k, n in r["launches"].items() if n}
        if got_launches != want:
            raise AssertionError(f"mesh leg step {i}: launches "
                                 f"{got_launches} != the one-card leg's "
                                 f"{want}")
    summed = {k: sum(r["launches"][k] for r in recs) for k in got["launches"]}
    if summed != got["launches"]:
        raise AssertionError(f"mesh leg: launches {got['launches']} outside "
                             f"its steps' {summed}")
    rel = [abs(a - b) / abs(b) for a, b in zip(loss, single["loss"])]
    if cards == 1 and max(rel) > MESH_LOSS_RTOL:
        raise AssertionError(f"mesh leg losses {loss} against the one-card "
                             f"leg's {single['loss']}")
    return {**got, "cards": cards, "loss": loss,
            "grad_norm": [r["metrics"]["grad_norm"] for r in recs],
            "loss_rel_err_vs_one_card": rel, "tol": MESH_LOSS_RTOL,
            "step_s": [r["s"] for r in recs],
            "s_per_step": statistics.median(r["s"] for r in recs[1:]),
            "launches_per_step": recs[-1]["launches"],
            "subprocess_s_after_go": total}


# distributed_green's pairs: the first case's first GREEN_DIST_PAIRS
# samples against its reference, at JUDGE_TOKENS
GREEN_DIST_PAIRS = 4


def green_distributed_leg(torch, fa, da, tok, data: str, tmp: str) -> tuple:
    """``distributed_green`` through an initialised NCCL group (one rank,
    this card) with the stage-2 judge (``tmp/judge``, JUDGE_TOKENS) over
    GREEN_DIST_PAIRS of the phase's pairs: its scores and rows, exchanged
    through the group as JSON bytes, equal the plain scorer's on the same
    pairs, and K2 launched. Returns (the line, its launches)."""
    import torch.distributed as dist

    from u2tokenizer_torch import cli
    from u2tokenizer_torch.eval.green import GreenScorer
    from u2tokenizer_torch.eval.green_distributed import distributed_green

    with open(os.path.join(data, "preds.jsonl")) as f:
        row = json.loads(f.readline())
    hyps = row["predictions"][:GREEN_DIST_PAIRS]
    refs = [row["answer"]] * len(hyps)
    args = cli.build_parser().parse_args(
        ["green", "--predictions", "-", "--judge", os.path.join(tmp, "judge"),
         "--output", "-"])
    judge = cli._build_judge(args, tok)
    judge.gen_cfg = dataclasses.replace(judge.gen_cfg,
                                        max_new_tokens=JUDGE_TOKENS)
    scorer = GreenScorer(judge, compute_summary_stats=False)
    plain = scorer(refs, hyps)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        reset_launches(fa, da)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = distributed_green(scorer, refs, hyps)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches(fa, da)
    finally:
        dist.destroy_process_group()
    del judge, scorer
    if got.scores != plain.scores or got.rows != json.loads(
            json.dumps(plain.rows)):
        raise AssertionError(f"distributed_green {got.scores} against the "
                             f"plain scorer's {plain.scores}")
    if not launches["flash_fwd_causal"]:
        raise AssertionError(f"distributed_green launched no K2: {launches}")
    return {"pairs": len(hyps), "backend": "nccl", "world": 1,
            "s": seconds, "scores": got.scores,
            "rows_equal_plain": True, "launches": nonzero(launches)}, launches


def drive_green_dpo(torch, F, fa, da, tmp: str, card: str) -> tuple:
    """Stage 1 from files and stage 2 of the paper through the port's CLI
    in this process, each subcommand with a closed ``MockTokenizer``
    (``green_tokenizer``), at the released μ²Llama-3.2-1B configuration
    from the report phase's checkpoint ``tmp/mu2llama``: ``train``,
    ``generate``, ``green`` with the decoder judge and with the stub
    judge, ``dpo-convert``, ``dpo`` (plain, ``--ce-chunk``, a repeated
    pair); the reduced-depth DPO step against the CPU; K2 and K4a-c at the
    DPO call and K2 at the judge's as this run made them (untimed). One
    printed line each; returns (the launches of the phase by path, the
    kernel checks at its calls, the tokenizer)."""
    cfg = released_config()
    ckpt = os.path.join(tmp, "mu2llama")
    tok = green_tokenizer(cfg.llm.vocab_size)
    mesh = start_mesh_train(torch, train_file_argv(
        os.path.join(tmp, "green_dpo"), ckpt), tmp)
    try:
        t0 = time.perf_counter()
        data = write_green_data(tmp)
        counts = {}
        line = {"write_data_s": time.perf_counter() - t0}
        line["train"], counts["green_dpo_train"] = green_train_phase(
            torch, fa, da, tok, data, ckpt, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        line["train_mesh"] = finish_mesh_train(torch, mesh, line["train"])
        line["train_mesh"]["phase_s"] = time.perf_counter() - t0
    finally:
        stop_mesh_train(mesh)
    counts["green_dpo_train_mesh"] = line["train_mesh"]["launches"]
    line["generate"], counts["green_dpo_generate"], rows = \
        green_generate_phase(torch, fa, da, tok, data, ckpt)
    gc.collect()
    torch.cuda.empty_cache()
    line["judge"], counts["green_dpo_judge"], judge_lens = green_judge_phase(
        torch, fa, da, tok, data, tmp, rows)
    gc.collect()
    torch.cuda.empty_cache()
    line["green_distributed"], counts["green_dpo_green_distributed"] = \
        green_distributed_leg(torch, fa, da, tok, data, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    line["stub_green_and_convert"] = green_stub_phase(data, rows)
    line["card"] = card
    print(json.dumps({"green_dpo_files": line}), flush=True)

    recs, plain, counts["green_dpo_dpo"] = green_dpo_run(
        torch, fa, da, tok, data, ckpt, tmp, "pairs.jsonl", DPO_STEPS,
        profile_at=DPO_STEPS - 1)
    first = recs[0]["metrics"]
    rewards = {k: first[k] for k in ("rewards_chosen", "rewards_rejected",
                                     "rewards_margin")}
    if abs(first["loss"] - math.log(2)) > LN2_TOL or any(rewards.values()):
        raise AssertionError(f"DPO step 0 is not an identity: {first}")
    plain["profile"] = recs[-1]["profile"]
    _, chunked, counts["green_dpo_dpo_ce_chunk"] = green_dpo_run(
        torch, fa, da, tok, data, ckpt, tmp, "pairs.jsonl", DPO_STEPS,
        "--ce-chunk", str(DPO_CE_CHUNK))
    ce_err = max(abs(a - b) for a, b in zip(chunked["loss"],
                                            plain["loss"]))
    if not ce_err <= DPO_CE_TOL:
        raise AssertionError(f"--ce-chunk {DPO_CE_CHUNK} losses "
                             f"{chunked['loss']} against {plain['loss']}")
    _, separate, counts["green_dpo_dpo_separate"] = green_dpo_run(
        torch, fa, da, tok, data, ckpt, tmp, "pairs_one.jsonl",
        SEPARATE_STEPS, "--learning-rate", str(SEPARATE_LR))
    if not (separate["loss"][-1] < separate["loss"][0]
            and separate["rewards_margin"][-1] > 0):
        raise AssertionError(f"a repeated pair does not separate: "
                             f"{separate}")
    print(json.dumps({"green_dpo_train": {
        "dpo": plain, "step0": {"loss": first["loss"], **rewards},
        "ce_chunk": {"chunk": DPO_CE_CHUNK, **chunked,
                     "loss_abs_err_vs_plain": ce_err, "tol": DPO_CE_TOL},
        "separate": {"learning_rate": SEPARATE_LR, **separate},
        "card": card}}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    print(json.dumps({"green_dpo_reference_check": check_dpo_reference(
        torch, fa, tok), "card": card}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # the calls this run made, untimed (DPO_CALL and JUDGE_CALL are timed
    # with the other kernel checks)
    checks = [check_flash(torch, F, fa, dict(DPO_CALL, lens=plain["lens"]),
                          30, timed=False),
              *check_flash_bwd(torch, F, fa, dict(DPO_CALL,
                                                  lens=plain["lens"]),
                               31, timed=False),
              check_flash(torch, F, fa, dict(JUDGE_CALL, lens=judge_lens),
                          32, timed=False)]
    for k in checks:
        print(json.dumps({"kernel_check": k}), flush=True)
    return counts, checks, tok



# The evaluation phase (``drive_eval``, after the stage-2 phase): the
# stage-2 phase's μ²Llama-3.2-1B checkpoint, its three cases, its seeded
# judge and its predictions, scored through the port's CLI in this process
# (``eval --task mrg`` with the judge, ``eval --task vqa``,
# ``eval-predictions``), and ``quant-report`` at μ²Qwen3-1.7B, bench.py's
# model. Scores of seeded weights mean only that the machinery runs.
# the users' 768 tokens cut for the script's time (256 until the ablation
# phase came, 128 until the M3D phase came)
EVAL_CASES, EVAL_TOKENS = 3, 64
EVAL_FAULT_TOKENS = 32             # the planted prompt-length fault's steps
QR_GREEDY_TOKENS = 32              # quant-report's greedy leg
# depth chunks of its reduced-depth check: 4 x 256 projected tokens, as the
# μ²tokenizer's top-k of 1024 needs
QR_CHUNKS = 4
# ``quant-report`` at the reduced config on the card and on the CPU, both
# bf16 compute from one fp32 checkpoint. The weights leg quantizes the same
# fp32 weights with the same fp32 arithmetic and sums the squared errors in
# fp64 in another order, so each layer's SNR, rounded to 0.01 dB, agrees
# within one rounding step (QR_SNR_TOL; the 1e-9 absorbs the decimal's
# binary representation). The forward leg compares two bf16 stacks on each
# device, whose products round in other orders on the card and the CPU:
# its mean KL (~1e-2 for int4 on seeded weights) may part by a few per
# cent (QR_KL_RTOL) plus a floor (QR_KL_ATOL), and its
# top-1 match, over 272 positions, by the positions whose float and
# quantized top two lie within the devices' rounding (QR_TOP1_TOL). The
# same limits must reject int4 scales of max/8 in place of max/7.
QR_SNR_TOL, QR_KL_RTOL, QR_KL_ATOL, QR_TOP1_TOL = 0.01, 0.05, 2e-5, 0.05


def same_report(torch, a, b) -> bool:
    """Two greedy reports (tokens, the prefill's first-token logits) are
    the same bit for bit. A random-weight model's greedy tokens may not
    depend on the prompt's last token at all (its reports settle on one
    repeated token), so the first token's logits are held too."""
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def report_diff(a, b) -> dict:
    """Where two greedy reports part: the first differing token (None
    when the tokens agree) and the logits' largest difference."""
    diff = (a[0] != b[0]).nonzero()
    return {"first_token_diff": int(diff[0, 0]) if len(diff) else None,
            "first_logits_max_abs_diff": (a[1] - b[1]).abs().max().item()}


def generate_record(args, out) -> dict:
    """A ``MultimodalGenerate`` call's prompt length and tokens (B=1)."""
    return {"prompt_len": int(args[3][0]), "tokens": out[0].clone()}


def eval_mrg_phase(torch, fa, da, tok, data: str, ckpt: str,
                   judge_dir: str) -> tuple:
    """``cli eval --task mrg`` of EVAL_CASES cases, EVAL_TOKENS greedy
    tokens each, with the stage-2 phase's judge: every case's launches (K1
    12, K2 16) and seconds through ``step_probe``, every judge batch's (K2
    16); then case 0's tokens and first-token logits, as
    ``ReportGenerator`` took them inside the command, against
    ``MultimodalGenerate`` driven directly on the same ``FusedDataset``
    sample and model (``same_report``), a check that must reject the
    prompt length one short. Returns (the line, the launches, the rows
    file)."""
    from u2tokenizer_torch import cli
    from u2tokenizer_torch.config import GenerationConfig
    from u2tokenizer_torch.data.datasets import FusedDataset
    from u2tokenizer_torch.eval import green
    from u2tokenizer_torch.models import generate

    loaded, judged, first_logits = [], [], []
    load, tokens_of = cli._init_or_load, green.TorchJudge.batch_tokens
    build = cli._build_judge

    def judge_of(*a, **kw):  # JUDGE_TOKENS a reply, as the stage-2 phase's
        judge = build(*a, **kw)
        judge.gen_cfg = dataclasses.replace(judge.gen_cfg,
                                            max_new_tokens=JUDGE_TOKENS)
        return judge

    def timed_load(*a, **kw):
        t0 = time.perf_counter()
        model = load(*a, **kw)
        torch.cuda.synchronize()
        loaded.append((model, time.perf_counter() - t0))
        # the prefill's logits of each call's first token (the decode
        # steps take the decoder's own head)
        lm_logits = model.lm_logits
        model.lm_logits = lambda h: first_logits.append(
            lm_logits(h).clone()) or first_logits[-1]
        return model

    def timed_tokens(judge, ids, lens, split):
        before = read_launches(fa, da)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tokens_of(judge, ids, lens, split)
        torch.cuda.synchronize()
        after = read_launches(fa, da)
        judged.append({"s": time.perf_counter() - t0, "lens": lens.tolist(),
                       "launches": {k: n - before[k] for k, n in after.items()
                                    if n - before[k]}})
        return out

    out = os.path.join(data, "eval_mrg.json")
    reset_launches(fa, da)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with planted(cli, {"_init_or_load": timed_load,
                       "_build_judge": judge_of}), \
            planted(green.TorchJudge, {"batch_tokens": timed_tokens}), \
            step_probe(torch, fa, da, generate, "make_multimodal_generate_fn",
                       record=generate_record) as cases:
        result = cli_run(["eval", "--task", "mrg", "--checkpoint", ckpt,
                          "--tokenizer", "mock", "--base-path", data,
                          "--jsonl-path", "cases.jsonl", "--output", out,
                          "--max-cases", str(EVAL_CASES), "--max-new-tokens",
                          str(EVAL_TOKENS), "--judge", judge_dir],
                         tokenizer=tok, judge_tokenizer=tok)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_launches(fa, da)
    peak = torch.cuda.max_memory_allocated()
    expect_launches("eval mrg case", cases, {"flash_fwd_noncausal": 12,
                                             "flash_fwd_causal": 16})
    if len(cases) != EVAL_CASES or len(result.rows) != EVAL_CASES:
        raise AssertionError(f"eval mrg: {len(cases)} cases generated, "
                             f"{len(result.rows)} rows")
    for b in judged:
        if b["launches"] != {"flash_fwd_causal": 16}:
            raise AssertionError(f"eval judge batch launches {b['launches']}")
    if not ({"green_mean", "green_std"} <= set(result.metrics)
            and all("green" in r for r in result.rows)):
        raise AssertionError(f"eval mrg without GREEN: {result.metrics}")

    # case 0 again, outside the command: the same sample and model
    (model, load_s), = loaded
    cfg = model.cfg
    sample = FusedDataset(
        data, "cases.jsonl", tok, max_length=1024,
        image_tokens_num=cfg.proj_out_num, data_type="validation",
        num_chunks=cfg.num_chunks, chunk_depth=cfg.vision.input_spatial[0],
        target_size=cfg.vision.input_spatial[1], device="cuda")[0]
    args = [sample[k][None].cuda() for k in ("input_id", "image",
                                             "question_ids")]
    plen = sample["attention_mask"].sum()[None].to("cuda", torch.int32)
    gen = GenerationConfig(max_new_tokens=EVAL_TOKENS, do_sample=False,
                           eos_token_id=tok.eos_token_id,
                           pad_token_id=tok.pad_token_id or 0)
    fn = generate.make_multimodal_generate_fn(model, gen)
    inside = (cases[0]["tokens"], first_logits[0])
    direct = (fn(*args, plen)[0], first_logits[-1])
    if not (cases[0]["prompt_len"] == int(plen)
            and same_report(torch, inside, direct)):
        raise AssertionError(f"eval's case 0 differs from MultimodalGenerate "
                             f"on its sample: {report_diff(inside, direct)}")
    # the fault, one prompt token short, over the same cache (the stages
    # of the same call) for its first EVAL_FAULT_TOKENS steps
    short = plen - 1
    kv, tok0, done0, _ = fn.prefill_stage(fn.embeds(*args), short)
    _, _, rest = fn.decode_steps(kv, tok0, done0, short,
                                 range(EVAL_FAULT_TOKENS - 1))
    faulty = (torch.cat([tok0[:, None], rest], 1)[0], first_logits[-1])
    head = (inside[0][:EVAL_FAULT_TOKENS], inside[1])
    if same_report(torch, head, faulty):
        raise AssertionError("the check does not reject a prompt one token "
                             "short")
    fault = report_diff(head, faulty)
    del loaded, model, fn, kv, first_logits
    gc.collect()
    torch.cuda.empty_cache()

    rows = os.path.join(data, "eval_mrg_rows.jsonl")
    with open(rows, "w") as f:
        for row in result.rows:
            f.write(json.dumps(row) + "\n")
    return {"cases": EVAL_CASES, "max_new_tokens": EVAL_TOKENS,
            "cli_total_s": total_s, "load_s": load_s,
            "s_per_case": statistics.median(c["s"] for c in cases),
            "case_s": [c["s"] for c in cases],
            "prompt_lens": [c["prompt_len"] for c in cases],
            "launches_per_case": cases[-1]["launches"],
            "judge_batches": len(judged),
            "judge_s_per_batch": statistics.median(b["s"] for b in judged),
            "judge_batch_s": [b["s"] for b in judged],
            "judge_prompt_lens": [b["lens"] for b in judged],
            "metrics": result.metrics, "green": [r["green"]
                                                 for r in result.rows],
            "words": [len(r["prediction"].split()) for r in result.rows],
            "case0_equal_direct": True,
            "planted_prompt_one_short": {"rejected": True, **fault},
            "peak_mem_gb": peak / 1e9}, launches, rows


def eval_vqa_phase(torch, fa, da, tok, data: str, ckpt: str) -> tuple:
    """``cli eval --task vqa`` on the same cases: one greedy token a case
    (K1 12, K2 16), its first letter against the answer's."""
    out = os.path.join(data, "eval_vqa.json")
    reset_launches(fa, da)
    t0 = time.perf_counter()
    result = cli_run(["eval", "--task", "vqa", "--checkpoint", ckpt,
                      "--tokenizer", "mock", "--base-path", data,
                      "--jsonl-path", "cases.jsonl", "--output", out,
                      "--max-cases", str(EVAL_CASES)], tokenizer=tok)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_launches(fa, da)
    want = {name: 0 for name in launches}
    want.update({"flash_fwd_noncausal": 12 * EVAL_CASES,
                 "flash_fwd_causal": 16 * EVAL_CASES})
    if launches != want:
        raise AssertionError(f"eval vqa launches {launches} != {want}")
    if not (len(result.rows) == EVAL_CASES and all(
            len(r["prediction"].split()) <= 1 for r in result.rows)):
        raise AssertionError(f"eval vqa rows {result.rows}")
    return {"cases": EVAL_CASES, "cli_total_s": total_s,
            "accuracy": result.metrics["accuracy"],
            "predictions": [r["prediction"] for r in result.rows]}, launches


def eval_predictions_phase(torch, fa, da, data: str, rows: str) -> dict:
    """``cli eval-predictions`` on ``cli eval``'s rows (written as jsonl)
    and on the stage-2 phase's ``generate`` predictions; no card. Each row
    of the first run keeps ``cli eval``'s reference and prediction, and
    its BLEU-1, ROUGE-1/2/L and METEOR are ``score_report``'s of them."""
    from u2tokenizer_torch.eval.metrics import score_report

    line = {}
    reset_launches(fa, da)
    for name, preds in (("eval_rows", rows),
                        ("generate_preds",
                         os.path.join(data, "preds.jsonl"))):
        t0 = time.perf_counter()
        result = cli_run(["eval-predictions", "--predictions", preds,
                          "--output", os.path.join(data, f"{name}.json")])
        line[name] = {"rows": len(result.rows), "s": time.perf_counter() - t0,
                      "metrics": result.metrics}
        if name == "eval_rows":
            want = [json.loads(x) for x in open(rows)]
            for got, row in zip(result.rows, want):
                if ((got["reference"], got["prediction"])
                        != (row["reference"], row["prediction"])
                        or {k: got[k] for k in score_report("", "")}
                        != score_report(row["reference"], row["prediction"])):
                    raise AssertionError(f"eval-predictions row {got} for "
                                         f"{row}")
            if len(result.rows) != len(want):
                raise AssertionError("eval-predictions dropped rows")
    if any(read_launches(fa, da).values()):
        raise AssertionError("eval-predictions launched a kernel")
    return line


def timed_legs(torch, module, names, legs: dict) -> dict:
    """Replacements of ``module``'s functions ``names`` that append each
    call's seconds (host clock around a synchronize) to ``legs[name]``."""
    def wrap(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            legs.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return run
    return {name: wrap(name, getattr(module, name)) for name in names}


def int4_scales_of_eighths(torch):
    """The planted fault of ``quantize_kernel_int4``: group scales of
    max/8 in place of max/7 (the values still clipped to [-7, 7])."""
    from u2tokenizer_torch.models.llm.decoder import int4_group, pack_int4

    def quantize(kernel, group: int = 128, eps: float = 1e-8):
        in_f, out = kernel.shape
        g = int4_group(in_f, group)
        k = kernel.float().reshape(in_f // g, g, out)
        scale = torch.clamp(k.abs().amax(dim=1, keepdim=True) / 8.0, min=eps)
        q = torch.clamp(torch.round(k / scale), -7, 7).to(torch.int8)
        return pack_int4(q), scale[:, 0, :]
    return quantize


def quant_agreement(got: dict, ref: dict) -> dict:
    """Per mode of ``got``: its per-layer SNR, forward mean KL and top-1
    match against ``ref``'s, each within its limit."""
    out = {}
    for mode in (m for m in ("int8", "int4") if m in got):
        g, r = got[mode], ref[mode]
        layers = r["weights"]["layers"]
        snr_err = max(abs(g["weights"]["layers"][p]["snr_db"]
                          - layers[p]["snr_db"]) for p in layers)
        kl, kl_ref = g["forward"]["mean_kl"], r["forward"]["mean_kl"]
        kl_limit = QR_KL_RTOL * kl_ref + QR_KL_ATOL
        top1_err = abs(g["forward"]["top1_match"]
                       - r["forward"]["top1_match"])
        holds = {"snr": bool(snr_err <= QR_SNR_TOL + 1e-9),
                 "kl": bool(abs(kl - kl_ref) <= kl_limit),
                 "top1": bool(top1_err <= QR_TOP1_TOL)}
        out[mode] = {"snr_db_max_err": float(snr_err),
                     "mean_kl": [kl, kl_ref],
                     "kl_limit": kl_limit, "top1_match": [
                         g["forward"]["top1_match"],
                         r["forward"]["top1_match"]],
                     "limits_hold": holds, "holds": all(holds.values())}
    return out


def quant_report_phase(torch, fa, da) -> tuple:
    """``cli quant-report`` at ``U2ModelConfig()`` (μ²Qwen3-1.7B) with
    random weights drawn on the card, both modes, the greedy leg at
    QR_GREEDY_TOKENS: the report, each leg's seconds and the launches
    (K1 12 and K2 28 a forward or a greedy prefill)."""
    from u2tokenizer_torch.eval import quant_report as qr

    legs = {}
    names = ("layer_quant_report", "quantized_copy", "forward_agreement",
             "greedy_agreement")
    reset_launches(fa, da)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with planted(qr, timed_legs(torch, qr, names, legs)):
        report = cli_run(["quant-report", "--modes", "int8,int4",
                          "--greedy-tokens", str(QR_GREEDY_TOKENS)])
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_launches(fa, da)
    peak = torch.cuda.max_memory_allocated()
    # a mode: 2 batches x 2 stacks forward, 2 greedy prefills
    want = {name: 0 for name in launches}
    want.update({"flash_fwd_noncausal": 2 * 6 * 12,
                 "flash_fwd_causal": 2 * 6 * 28})
    if launches != want:
        raise AssertionError(f"quant-report launches {launches} != {want}")
    for mode in ("int8", "int4"):
        entry = report[mode]
        if not (entry["decision"]["complete"]
                and not entry["decision"]["decision_grade"]
                and entry["greedy"]["new_tokens"] == QR_GREEDY_TOKENS
                and all(math.isfinite(v) for v in entry["forward"].values()
                        if not isinstance(v, str))):
            raise AssertionError(f"quant-report {mode}: {entry}")
    return {"model": MODEL_NAMES["qwen3"], "weights": "random, seed 0",
            "cli_total_s": total_s, "leg_s": legs,
            "peak_mem_gb": peak / 1e9, "report": report}, launches


def quant_report_check(torch, tmp: str) -> dict:
    """``cli quant-report`` at the reduced config (2 ViT, 1 μ²tokenizer and
    2 decoder layers, QR_CHUNKS chunks) on one seeded fp32 checkpoint,
    ``--rehearsal --per-layer --num-batches 1 --modes int4``, on the card
    and with ``--device cpu``, held by ``quant_agreement``, whose limits
    must reject int4 scales of max/8 planted in the quantizer. int4 mode
    quantizes the embedding table int8 per row too; int8 mode is left
    out of the check for time (its CPU run took ~30 s of bf16 products
    on the card's host)."""
    from u2tokenizer_torch.eval import quant_report as qr
    from u2tokenizer_torch.models import quantize
    from u2tokenizer_torch.models.hf_export import save_hf_checkpoint
    from u2tokenizer_torch.models.u2_model import U2CausalLM
    from u2tokenizer_torch.weights import flax_params

    ckpt = os.path.join(tmp, "mu2qwen3_reduced")
    cfg = reduced_config(QR_CHUNKS)
    model = U2CausalLM(cfg, dtype=torch.float32, device="cuda", seed=0)
    save_hf_checkpoint(ckpt, flax_params(model), cfg)
    del model
    argv = ["quant-report", "--checkpoint", ckpt, "--rehearsal",
            "--per-layer", "--num-batches", "1", "--modes", "int4"]
    runs, seconds = {}, {}
    for name, extra in (("gpu", []), ("cpu", ["--device", "cpu"])):
        t0 = time.perf_counter()
        runs[name] = cli_run(argv + extra)
        seconds[name] = time.perf_counter() - t0
    eighths = int4_scales_of_eighths(torch)
    t0 = time.perf_counter()
    with planted(quantize, {"quantize_kernel_int4": eighths}), \
            planted(qr, {"quantize_kernel_int4": eighths}):
        faulty = cli_run(argv)
    seconds["gpu_fault"] = time.perf_counter() - t0
    shutil.rmtree(ckpt)
    sound = quant_agreement(runs["gpu"], runs["cpu"])
    fault = quant_agreement(faulty, runs["cpu"])
    if not all(m["holds"] for m in sound.values()):
        raise AssertionError(f"quant-report, card against CPU: {sound}")
    if fault["int4"]["holds"]:
        raise AssertionError("the quant-report check does not reject int4 "
                             f"scales of max/8: {fault}")
    return {"model": f"{MODEL_NAMES['qwen3']}, 2 layers, {QR_CHUNKS} "
                     "chunks", "s": seconds,
            "limits": {"snr_db": QR_SNR_TOL, "kl_rtol": QR_KL_RTOL,
                       "kl_atol": QR_KL_ATOL, "top1": QR_TOP1_TOL},
            "card_vs_cpu": sound, "planted_int4_eighths": fault}


def drive_eval(torch, fa, da, tmp: str, tok, card: str) -> dict:
    """The evaluation phase: ``eval_mrg_phase``, ``eval_vqa_phase`` and
    ``eval_predictions_phase`` on the stage-2 phase's files
    (``tmp/mu2llama``, ``tmp/green_dpo``, ``tmp/judge``) with its closed
    ``green_tokenizer`` ``tok``, then ``quant_report_phase`` and
    ``quant_report_check``. One printed line each; returns the launches by
    path."""
    data = os.path.join(tmp, "green_dpo")
    ckpt = os.path.join(tmp, "mu2llama")
    counts = {}
    mrg, counts["eval_mrg"], rows = eval_mrg_phase(
        torch, fa, da, tok, data, ckpt, os.path.join(tmp, "judge"))
    vqa, counts["eval_vqa"] = eval_vqa_phase(torch, fa, da, tok, data, ckpt)
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"eval_mu2llama": {
        "mrg": mrg, "vqa": vqa,
        "eval_predictions": eval_predictions_phase(torch, fa, da, data, rows),
        "note": "seeded weights: the scores show only that the machinery "
                "runs", "card": card}}), flush=True)
    full, counts["quant_report"] = quant_report_phase(torch, fa, da)
    print(json.dumps({"quant_report": full, "card": card}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"quant_report_check": quant_report_check(torch, tmp),
                      "card": card}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# The Phi phase (``drive_phi``): the paper's μ²Phi-3-mini backbone
# (Phi-3-mini-4k's decoder: 32 layers, 32 heads of 96, MHA, vocabulary
# 32,064) and the Phi-2 decoder that the reference's stage 2 judges with
# (GREEN-RadPhi2's base: 32 layers, 32 heads of 80, partial rotary 0.4,
# LayerNorm, GELU, parallel blocks, biases), full width and depth with
# seeded weights (no Phi weights are in the repository); the kernels' D=96
# and D=80 forms on their paths.
# tokens of the B=4 batches: 1024 + 32 slots (256 until the evaluation
# phase came, cut for the script's time); K3's Phi forms are checked there
PHI_NEW = 32
# μ²Phi-3-mini's greedy report (REPORT_TOKENS until the data-preparation
# phase came, cut for the script's time)
PHI_REPORT_TOKENS = 128
# μ²Phi-3-mini's report and B=4 batches at PHI3_LAYERS of its 32 decoder
# layers (the full depth until the data-preparation phase came, 16 until the
# mesh leg came, cut for the script's time; the QLoRA leg reads the same
# export at QLORA_LAYERS)
PHI3_LAYERS = 8
PHI3_PREFILL_CALL = dict(PREFILL_CALL, h=32, hkv=32, d=96)
PHI2_JUDGE_CALL = dict(JUDGE_CALL, hkv=32, d=80)
PHI_HEADS = {96: (32, 32, 96), 80: (32, 32, 80)}
# K1 at D=80 and 96, which no path launches (the ViT's heads are 64), at a
# 1024-token call, timed by events beside SDPA only; untimed: K1 and K2 at
# both on the tile-edge shape (group 2); K3 at both with groups 2, 4 and 8
# and at the first and last steps and a 3-token prompt; K4a-c at D=128
# non-causal, a form no path makes.
PHI_EDGE_FWD = ([dict(causal=False, b=2, s=PROMPT, h=32, hkv=32, d=d,
                      lens=[PROMPT, RAGGED], fused=False) for d in (80, 96)]
                + [dict(EDGE_CALLS[1], causal=causal, d=d)
                   for d in (80, 96) for causal in (False, True)])
BWD_NONCAUSAL_128_CALL = dict(PREFILL_CALL, causal=False, b=2,
                              lens=[PROMPT, RAGGED])
# K4a-c at D=96 on the QLoRA path's call (``qlora_phase``: B=1, 1024
# tokens, MHA, the valid length of the case its steps take first; the
# phase holds its steps' tensors to this shape and checks the other steps'
# lengths untimed), and at D=80 on a Phi-2-shaped call that no path makes
# (B=1, 1024 tokens, 900 valid); both timed. Untimed: both dims
# non-causal at (2, 1024, 32 heads) and both on the tile-edge shape,
# causal and not.
QLORA_VALID = 423
QLORA_CALL = dict(PHI3_PREFILL_CALL, b=1, lens=[QLORA_VALID])
PHI2_BWD_CALL = dict(PHI2_JUDGE_CALL, b=1, s=PROMPT, lens=[TRAIN_VALID])
PHI_EDGE_BWD = ([dict(call, causal=False, b=2, lens=[PROMPT, RAGGED])
                 for call in (QLORA_CALL, PHI2_BWD_CALL)]
                + [dict(EDGE_CALLS[1], causal=causal, d=d)
                   for d in (80, 96) for causal in (False, True)])
# timed forms that no path of this script launches (their launch count is 0)
NO_PATH_FORMS = ("flash_bwd_lse_d80", "flash_bwd_dq_d80", "flash_bwd_dkv_d80")


def phi_kernel_checks(torch, F, fa, da, attn) -> tuple:
    """The Phi forms: K2 at μ²Phi-3's prefill (D=96) and at the Phi-2
    judge's (D=80), K3-int8 and K3-int4 at both (B=4, 32 heads, group 1,
    step 15 of 1024 + 32 slots), K4a-c at the QLoRA call (D=96) and the
    Phi-2-shaped one (D=80), timed; the untimed forms above. Returns (the timed entries, named by form, and
    every check)."""
    timed = {"flash_fwd_causal_d96": check_flash(torch, F, fa,
                                                 PHI3_PREFILL_CALL, 40),
             "flash_fwd_causal_d80": check_flash(torch, F, fa,
                                                 PHI2_JUDGE_CALL, 41)}
    for d, call, seed in ((96, QLORA_CALL, 60), (80, PHI2_BWD_CALL, 61)):
        for entry in check_flash_bwd(torch, F, fa, call, seed):
            timed[f"{entry['name']}_d{d}"] = entry
    for d, heads in PHI_HEADS.items():
        for bits in (8, 4):
            timed[f"{da.KERNELS[bits]}_d{d}"] = check_decode(
                torch, da, attn, bits, BATCH, (PHI_NEW - 1) // 2,
                heads=heads, new=PHI_NEW)
    # K1 at D=80 and 96 (the first two; no path launches them) timed, with
    # their device time and plain version, beside SDPA
    checks = [check_flash(torch, F, fa, call, 42 + i, timed=i < 2)
              for i, call in enumerate(PHI_EDGE_FWD)]
    for d in PHI_HEADS:
        for bits in (8, 4):
            checks += [check_decode(torch, da, attn, bits, BATCH, step,
                                    prompt, timed=False, heads=PHI_HEADS[d],
                                    new=PHI_NEW)
                       for step, prompt in ((0, None), (PHI_NEW - 1, None),
                                            (0, [PROMPT] * 3 + [3]))]
            checks += [check_decode(torch, da, attn, bits, 2, timed=False,
                                    heads=(32, hkv, d), new=PHI_NEW)
                       for hkv in (16, 8, 4)]
    checks += check_flash_bwd(torch, F, fa, BWD_NONCAUSAL_128_CALL, 50,
                              timed=False)
    for i, call in enumerate(PHI_EDGE_BWD):
        checks += check_flash_bwd(torch, F, fa, call, 62 + i, timed=False)
    for form, entry in timed.items():
        entry["head_dim"] = int(form[-2:])
        entry["kernel"], entry["name"] = entry["name"], form
    return timed, checks


def phi3_config(layers: int = 0):
    """μ²Phi-3-mini: the default μ² stack (ViT3D 12 x 768, SPP, the
    μ²tokenizer) on the ``phi3_mini`` decoder, cut to ``layers`` decoder
    layers where given."""
    from u2tokenizer_torch.config import LLMConfig, U2ModelConfig

    llm = LLMConfig.phi3_mini()
    return U2ModelConfig(llm=dataclasses.replace(
        llm, num_layers=layers or llm.num_layers))


def phi2_judge_phase(torch, fa, da, tmp: str, preds: str) -> tuple:
    """``cli green --judge DIR`` with a Phi-2 judge (seeded bf16 weights
    written as an HF Phi-2 directory by ``write_judge_dir``) on
    ``preds``, in batches of JUDGE_BATCH padded to JUDGE_LENGTH, replies of
    JUDGE_TOKENS greedy tokens (speculative, shared prefix); each batch
    launches K2 once per layer at D=80. Returns (the result line, the
    launches, the judge's model)."""
    from u2tokenizer_torch import cli
    from u2tokenizer_torch.config import LLMConfig
    from u2tokenizer_torch.eval import green

    cfg = LLMConfig.phi2()
    judge_dir = os.path.join(tmp, "phi2_judge")
    t0 = time.perf_counter()
    write_judge_dir(judge_dir, preset="phi2")
    write_s = time.perf_counter() - t0
    rows = [json.loads(line) for line in open(preds)]
    # the samples' words (the generating model's vocabulary) among the
    # judge's 51,200 ids
    tok = green_tokenizer(cfg.vocab_size,
                          [p for r in rows for p in r["predictions"]])
    built, batches = [], []
    build, tokens_of = cli._build_judge, green.TorchJudge.batch_tokens

    def judge_of(*a, **kw):
        built.append(build(*a, **kw))
        built[-1].gen_cfg = dataclasses.replace(
            built[-1].gen_cfg, max_new_tokens=JUDGE_TOKENS)
        return built[-1]

    def timed_tokens(judge, ids, lens, split):
        before = read_launches(fa, da)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tokens_of(judge, ids, lens, split)
        torch.cuda.synchronize()
        after = read_launches(fa, da)
        batches.append({"s": time.perf_counter() - t0, "split": split,
                        "lens": lens.tolist(),
                        "launches": {k: n - before[k] for k, n in
                                     after.items() if n - before[k]}})
        return out

    out = os.path.join(tmp, "greened_phi2.jsonl")
    reset_launches(fa, da)
    with planted(cli, {"_build_judge": judge_of}), \
            planted(green.TorchJudge, {"batch_tokens": timed_tokens}):
        t0 = time.perf_counter()
        cli_run(["green", "--predictions", preds, "--judge", judge_dir,
                 "--output", out], tokenizer=tok)
        total = time.perf_counter() - t0
    launches = read_launches(fa, da)
    greened = [json.loads(line) for line in open(out)]
    want = sum(math.ceil(len(r["predictions"]) / JUDGE_BATCH) for r in rows)
    if len(batches) != want or len(greened) != len(rows):
        raise AssertionError(f"Phi-2 judge: {len(batches)} batches, "
                             f"{len(greened)} rows")
    for b in batches:
        if b["launches"] != {"flash_fwd_causal": cfg.num_layers}:
            raise AssertionError(f"Phi-2 judge batch launches "
                                 f"{b['launches']}")
    for r, g in zip(rows, greened):
        if (len(g["green_scores"]) != len(r["predictions"])
                or sorted(g["predictions"]) != sorted(r["predictions"])):
            raise AssertionError("Phi-2 judge: a row lost its samples")
    model, built_cfg = built[-1].model, built[-1].gen_cfg
    del built[:]
    return {"judge": "phi2 preset, seeded bf16 weights",
            "write_judge_s": write_s, "cli_total_s": total,
            "batches": len(batches),
            "max_new_tokens": built_cfg.max_new_tokens,
            "s_per_batch": statistics.median(b["s"] for b in batches),
            "batch_s": [b["s"] for b in batches],
            "shared_prefix": [b["split"] for b in batches],
            "prompt_lens": [b["lens"] for b in batches],
            "launches_per_batch": batches[0]["launches"]}, launches, model


def phi2_generate(torch, fa, da, model, cache: str) -> tuple:
    """A greedy batch of the Phi-2 decoder ``model`` (bf16): B=4 prompts of
    1024 seeded tokens (the last 900), PHI_NEW new tokens over a ``cache``
    KV cache; every decode step launches K3 once per layer at D=80.
    Returns (the result line, its launches)."""
    from u2tokenizer_torch.config import GenerationConfig
    from u2tokenizer_torch.models.generate import make_generate_fn

    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(5)
    ids = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=g,
                        device="cuda")
    plen = torch.tensor([PROMPT] * (BATCH - 1) + [RAGGED], dtype=torch.int32,
                        device="cuda")
    gen = make_generate_fn(model, GenerationConfig(
        max_new_tokens=PHI_NEW, do_sample=False, eos_token_id=-2,
        pad_token_id=0), cache_dtype=cache)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fa, da)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        embeds = model.embed_tokens(ids)
    kv, tok0, done0, hidden = gen.prefill_stage(embeds, plen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, _, rest = gen.decode_steps(kv, tok0, done0, plen, range(PHI_NEW - 1))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches(fa, da)
    tokens = torch.cat([tok0[:, None], rest], dim=1)
    layers = cfg.num_layers
    expected = {name: 0 for name in launches}
    expected.update({"flash_fwd_causal": layers,
                     da.KERNELS[int(cache[3:])]: layers * (PHI_NEW - 1)})
    if launches != expected:
        raise AssertionError(f"Phi-2 {cache} cache: launches {launches} != "
                             f"{expected}")
    if not (torch.isfinite(hidden).all() and tokens.shape == (BATCH, PHI_NEW)
            and ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"Phi-2 {cache} cache: bad output")
    return {"model": "Phi-2", "batch": BATCH,
            "prompt_len": f"{PROMPT} x{BATCH - 1}, {RAGGED}",
            "max_new_tokens": PHI_NEW, "cache": cache, "weights": "bf16",
            "prefill_s": t1 - t0, "decode_s": t2 - t1,
            "decode_ms_per_step": 1e3 * (t2 - t1) / (PHI_NEW - 1),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "first_tokens": tokens[:, :8].tolist(),
            "launches": launches}, launches


def check_decoder_reference(torch, llm_cfg, cache="int8"):
    """A text-only decoder (``llm_cfg``, full width, 2 layers) on the card
    (bf16 weights, kernels) against the same weights in fp32 on the CPU
    (plain versions): B=2 prompts of 384 tokens (the second 300), the
    prefill's last-position logits within LOGIT_TOL, and the greedy
    tokens' agreement over 4 decode steps."""
    from u2tokenizer_torch.config import GenerationConfig
    from u2tokenizer_torch.models.generate import make_generate_fn
    from u2tokenizer_torch.models.layers import init_weights
    from u2tokenizer_torch.models.llm.decoder import CausalLM
    from u2tokenizer_torch.models.quantize import cast_for_inference

    cfg = dataclasses.replace(llm_cfg, num_layers=2)
    b, s = 2, 384
    cpu = CausalLM(cfg, dtype=torch.float32, device="cpu")
    init_weights(cpu, 1)
    gpu = cast_for_inference(CausalLM(cfg, dtype=torch.bfloat16,
                                      device="cuda"))
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
    plen = torch.tensor([s, 300], dtype=torch.int32)
    gen = GenerationConfig(max_new_tokens=5, eos_token_id=-2)
    results = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, "cuda")):
        fn = make_generate_fn(model, gen, cache)
        with torch.inference_mode():
            embeds = model.embed_tokens(ids.to(dev))
        kv, tok0, done0, last = fn.prefill_stage(embeds, plen.to(dev))
        with torch.inference_mode():
            logits = model.lm_logits(last)[:, 0].float().cpu()
        _, _, rest = fn.decode_steps(kv, tok0, done0, plen.to(dev), range(4))
        results[name] = (logits, torch.cat([tok0[:, None], rest], 1).cpu(),
                         None)
    return logits_line(results, model_label(cfg), "bf16", cache)


# μ²Phi-3-mini's stage 1 through ``cli train --qlora`` (``qlora_phase``):
# QLORA_STEPS steps of B=1 at 1024 tokens from the exported checkpoint, on
# the stage-2 phase's three cases, the decoder cut to QLORA_LAYERS of its 32
# layers (``--config``; the 8B phase takes the full-width QLoRA path at
# full depth); step 0 warms, the middle ones are timed, the last is
# profiled. Each step launches K1 12 (the frozen ViT, forward only), K2 16
# at D=96 (8 layers, forward again under remat) and K4a-c 8 each at D=96,
# and nothing at D=64 in the backward.
QLORA_STEPS, QLORA_MODE, QLORA_LAYERS = 4, "int8", 8
QLORA_LAUNCHES = {"flash_fwd_noncausal_d64": 12, "flash_fwd_causal_d96": 16,
                  "flash_bwd_lse_d96": 8, "flash_bwd_dq_d96": 8,
                  "flash_bwd_dkv_d96": 8}


def qlora_cli_leg(torch, fa, da, tmp: str, cfg, mode: str, steps: int,
                  want: dict, call: dict, extra=(), tok=None) -> tuple:
    """``cli train --qlora mode --config <cfg>`` (``extra`` its other
    flags) with the stage-2 phase's ``tmp/green_dpo/cases.jsonl`` and
    ``tok`` (by default ``green_tokenizer`` of the model's vocabulary):
    ``steps`` steps (B=1, 1024 tokens), the last profiled, their launches
    by head dim held to ``want``, their batches to ``call``'s shape (the
    first step's valid length ``call["lens"]``), finite losses; the
    adapters file read back through the port's reader equal to the
    trained leaves bit for bit; the checkpoint holding the trainable
    leaves and the optimizer state alone. Returns (the result line, the
    leg's launches, the steps' valid lengths)."""
    from u2tokenizer_torch.train import lora
    from u2tokenizer_torch.train.checkpoint import (STATE_FILE,
                                                    load_params_msgpack)
    from u2tokenizer_torch.weights import flatten

    out = os.path.join(tmp, "qlora")
    cfg_path = os.path.join(tmp, "qlora_config.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    tok = tok or green_tokenizer(cfg.llm.vocab_size)
    reset_launches(fa, da)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with step_probe(torch, fa, da, lora, "make_qlora_trainer", unpack=True,
                    profile_at=steps - 1) as recs:
        state = cli_run(["train", "--qlora", mode, "--config", cfg_path,
                         *extra, "--tokenizer", "mock",
                         "--train-base-path", os.path.join(tmp, "green_dpo"),
                         "--train-jsonl-path", "cases.jsonl", "--max-steps",
                         str(steps), "--batch-size", "1",
                         "--max-length", str(PROMPT), "--num-workers", "2",
                         "--output-dir", out], tokenizer=tok)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches(fa, da)
    name = model_label(cfg.llm)
    expect_launches(f"qlora {name}", recs, want, key="launches_by_dim")
    readings = step_readings(recs)
    if not all(math.isfinite(x) for x in readings["loss"]
               + readings["grad_norm"]):
        raise AssertionError(f"qlora {name}: {readings}")
    lens = [r["lens"] for r in recs]
    # the kernels are checked and timed at ``call``: the steps' batches
    # must have its shape (B=1, S=PROMPT) and the first its valid length
    if (any(r["shape"] != [call["b"], call["s"]] for r in recs)
            or lens[0] != call["lens"]):
        shapes = [r["shape"] for r in recs]
        raise AssertionError(f"qlora {name} steps' batches {shapes}, lens "
                             f"{lens}, not the kernel check's call {call}")
    adapters = os.path.join(out, "qlora_adapters.msgpack")
    t1 = time.perf_counter()
    back = flatten(load_params_msgpack(adapters))
    read_s = time.perf_counter() - t1
    want_leaves = flatten(lora.flax_tree(state.model, state.train))
    if sorted(back) != sorted(want_leaves) or not all(
            back[k].dtype == want_leaves[k].dtype
            and torch.equal(back[k], want_leaves[k]) for k in want_leaves):
        raise AssertionError(f"qlora {name}: the adapters file does not "
                             "read back as the trained leaves")
    step_dir = os.path.join(out, "checkpoints", str(steps))
    saved = torch.load(os.path.join(step_dir, STATE_FILE),
                       map_location="cpu", weights_only=True)
    if set(saved) != {"step", "train", "optimizer"} or \
            set(saved["train"]) != set(state.train):
        raise AssertionError(f"qlora {name}: the checkpoint holds other "
                             "leaves than the trainable ones")
    n_train = sum(p.numel() for p in state.train.values())
    n_all = sum(p.numel() for p in state.model.parameters())
    dtypes = sorted({str(p.dtype) for p in state.train.values()})
    line = {**readings, "model": name, "qlora": mode,
            "decoder_layers": cfg.llm.num_layers,
            "lora_rank": state.model.cfg.llm.lora_rank,
            "batch": 1, "seq": PROMPT, "valid_tokens": lens,
            "remat": state.model.llm.model.remat, "flags": list(extra),
            "trainable_params": n_train,
            "all_params": n_all, "trainable_dtypes": dtypes,
            "cli_total_s": total_s, "peak_mem_gb": peak / 1e9,
            "adapters_file_gb": os.path.getsize(adapters) / 1e9,
            "adapters_read_s": read_s,
            "checkpoint_gb": sum(e.stat().st_size for e in
                                 os.scandir(step_dir)) / 1e9,
            "profile": recs[-1]["profile"],
            "launches_per_step": {k: n for k, n in
                                  recs[-1]["launches_by_dim"].items() if n}}
    del state, saved, back, want_leaves
    shutil.rmtree(out)
    os.remove(cfg_path)
    return line, launches, sorted({n for row in lens for n in row})


def qlora_phase(torch, fa, da, tmp: str) -> tuple:
    """μ²Phi-3-mini's QLoRA leg (``qlora_cli_leg``): ``--qlora int8
    --pretrained tmp/mu2phi3``, the decoder cut to QLORA_LAYERS layers,
    QLORA_STEPS steps held to QLORA_LAUNCHES and QLORA_CALL."""
    cfg = phi3_config()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_layers=QLORA_LAYERS))
    return qlora_cli_leg(torch, fa, da, tmp, cfg, QLORA_MODE, QLORA_STEPS,
                         QLORA_LAUNCHES, QLORA_CALL,
                         ["--pretrained", os.path.join(tmp, "mu2phi3")])


def drive_phi(torch, F, fa, da, volume, tmp: str, preds: str, card: str):
    """The Phi phase: μ²Phi-3-mini's report from files, its stage 1
    through ``cli train --qlora`` on the same exported directory
    (``qlora_phase``) and the QLoRA step's reduced-depth check against the
    CPU, its B=4 batches (bf16 weights with the int8 cache; int8 weights
    with the int4 cache; PHI_NEW tokens), the Phi-2 judge through ``cli
    green`` on ``preds``, Phi-2's greedy B=4 batches over the int8 and
    int4 caches, and both reduced-depth checks against the CPU. The
    launch counters are reset at each part, so that each path's counts
    are its own: K2 and K3 at D=96 on μ²Phi-3's (K1 at the ViT's D=64),
    the QLoRA path's by head dim (K4a-c at D=96), at D=80 on Phi-2's.
    Returns (the launches by path, the K4 checks at the QLoRA steps' other
    valid lengths, the QLoRA part's seconds)."""
    counts = {}
    t0 = time.perf_counter()
    cfg = phi3_config(PHI3_LAYERS)
    _, line = drive_report(torch, fa, da, volume, tmp, cfg, sampled=False,
                           config_json=True, max_new=PHI_REPORT_TOKENS)
    counts["report_mu2phi3"] = line["launches"]
    line["card"] = card
    print(json.dumps({"report_mu2phi3": line}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    line, counts["qlora_mu2phi3"], lens = qlora_phase(torch, fa, da, tmp)
    # nothing later reads the checkpoint (about 19 GB in fp32)
    shutil.rmtree(os.path.join(tmp, "mu2phi3"))
    line["card"] = card
    print(json.dumps({"qlora_mu2phi3": line}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"train_reference_check": check_train_reference(
        torch, fa, qlora=QLORA_MODE), "card": card}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    # K4a-c at the QLoRA steps' other valid lengths, untimed (the first's,
    # QLORA_CALL, is timed with the other kernel checks)
    checks = [e for i, n in enumerate(n for n in lens if n != QLORA_VALID)
              for e in check_flash_bwd(torch, F, fa,
                                       dict(QLORA_CALL, lens=[n]), 70 + i,
                                       timed=False)]
    for k in checks:
        print(json.dumps({"kernel_check": k}), flush=True)
    qlora_s = time.perf_counter() - t1
    for weights, cache in (("bf16", "int8"), ("int8", "int4")):
        counts[f"batch_mu2phi3_{cache}"] = serve_and_check(
            torch, da, PHI_NEW, BATCH, weights, cache, VISION_MICROBATCH,
            card, cfg, label="batch_mu2phi3")["launches"]
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"reference_check": check_reference(
        torch, "bf16", "int8", cfg), "card": card}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    phi3_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    line, counts["judge_phi2"], model = phi2_judge_phase(torch, fa, da, tmp,
                                                         preds)
    line["card"] = card
    print(json.dumps({"green_phi2_judge": line}), flush=True)
    for cache in ("int8", "int4"):
        line, counts[f"batch_phi2_{cache}"] = phi2_generate(torch, fa, da,
                                                            model, cache)
        line["card"] = card
        print(json.dumps({f"batch_phi2_{cache}_cache": line}), flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    from u2tokenizer_torch.config import LLMConfig

    print(json.dumps({"reference_check": check_decoder_reference(
        torch, LLMConfig.phi2()), "card": card}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"phi_phase_s": {"mu2phi3": phi3_s,
                                      "qlora_mu2phi3": qlora_s,
                                      "phi2": time.perf_counter() - t0}}),
          flush=True)
    return counts, checks, qlora_s



# ---------------------------------------------------------------------------
# The paper's stage-1 ablation matrix and ``cli demo`` (``drive_ablation``)
# ---------------------------------------------------------------------------

# The users' leg: ``cli train --attn-type rope`` at the released
# μ²Llama-3.2-1B widths and depth on the stage-2 phase's files, exported by
# ``save_hf_checkpoint`` (fp32), then ``cli demo --attention`` on it, a
# DEMO_TOKENS answer. The matrix: each variant of the reference's stage-1
# scripts at full width, the ViT, projector and μ²tokenizer at full depth
# and the decoder cut to ABLATION_LAYERS layers (the variants change only
# the vision side), with weights drawn on the card: ABLATION_STEPS SFT
# steps of B=1 over a 1024-token row and an ABLATION_TOKENS greedy report
# from a bf16 cache, held to the same model in fp32 on the card with the
# plain attention (prefill logits within LOGIT_TOL, the loss within
# TRAIN_LOSS_TOL, each gradient that ``ablation_judged`` holds within
# TRAIN_COS_MIN and TRAIN_NORM_TOL), and rejecting one planted fault of
# its own module by the same limits.
ABLATION_STEPS, ABLATION_LAYERS, ABLATION_TOKENS, DEMO_TOKENS = 2, 4, 32, 64
# each captured map is an fp32 softmax: its rows sum to 1 within this
MAP_SUM_TOL = 1e-3
# Left out of the matrix's gradient check, beside ``dpo_left_out``'s
# groups: the parameters of the SVR's attention scores past its first
# layer (query and key projections, relative-bias tables). The SVR stacks
# its attentions with no residual or norm, so its scores grow layer by
# layer and its softmaxes saturate; the gradients through them are small
# in fp32 and rounding noise in bf16 (at the vanilla and sequence-pool
# variants their median cosines are about 0, their norms 26 and 91 times
# fp32's). They run in plain PyTorch, not through a kernel, in both runs.
# The reduced checks, whose μ²tokenizer has one layer, hold them.
ABLATION_LEFT_OUT = DPO_LEFT_OUT + ("svr_scores",)
ABLATION_FAULTS = {"vanilla": "output projection skipped",
                   "linvt": "image tokens spliced one row late",
                   "sequence_pool": "pooled in the declared grid's order",
                   "linear_projector": "RoPE on q only"}


def ablation_left_out(name: str):
    """``dpo_left_out``, and "svr_scores" for the score parameters of the
    SVR's attentions past its first layer (see ABLATION_LEFT_OUT)."""
    m = re.match(r"u2tokenizer\.svt_module\.layers\.(\d+)\.\w+_attention\."
                 r"(w[qk]\.|relative_bias)", name)
    if m and int(m.group(1)) > 0 and dpo_left_out(name) is None:
        return "svr_scores"
    return dpo_left_out(name)


def ablation_judged(name: str) -> bool:
    return ablation_left_out(name) is None


def ablation_configs() -> dict:
    """The matrix: the released config with the decoder cut to
    ABLATION_LAYERS and one change each. LinVT is the reference's
    ``LinearVolumeTransform`` baseline (one 32x256x256 chunk, no
    μ²tokenizer); the linear projector hands the μ²tokenizer all 2048
    tokens of a chunk, past the 'rma' table (known difference 15), so it
    takes 'rope'. Each gives the decoder 256 image tokens."""
    base = released_config()
    base = dataclasses.replace(base, llm=dataclasses.replace(
        base.llm, num_layers=ABLATION_LAYERS))
    u2t = lambda **kw: dataclasses.replace(base.u2t, **kw)
    proj = lambda **kw: dataclasses.replace(base.projector, **kw)
    return {"vanilla": dataclasses.replace(base, u2t=u2t(attn_type="vanilla")),
            "linvt": dataclasses.replace(base, num_chunks=1,
                                         u2t=u2t(enable=False)),
            "sequence_pool": dataclasses.replace(
                base, projector=proj(pooling_type="sequence")),
            "linear_projector": dataclasses.replace(
                base, projector=proj(projector_type="linear"),
                u2t=u2t(attn_type="rope"))}


@contextlib.contextmanager
def ablation_fault(torch, name: str, cfg):
    """ABLATION_FAULTS[name] planted inside the block: the vanilla
    attention without its output projection; the image tokens over prompt
    rows [2, 2 + n); the 'sequence' pool taken over the declared 3D grid
    (the same count of tokens, other values); RoPE on q alone."""
    from u2tokenizer_torch.models import projector, u2_model
    from u2tokenizer_torch.models.u2tok import attention
    from u2tokenizer_torch.ops.attention import sdpa
    from u2tokenizer_torch.ops.pooling import spatial_pool_3d
    from u2tokenizer_torch.ops.rotary import apply_rope, rope_cos_sin

    def attend_no_dense(self, q, k, value, bias=None,
                        capture_attention=False):
        v = attention._split_heads(self.wv(value), self.num_heads)
        return attention._merge_heads(sdpa(q, k, v, bias=bias))

    def splice_late(self, input_ids, image_features):
        embeds = self.llm.embed_tokens(input_ids)
        img = image_features.to(embeds.dtype)
        return torch.cat([embeds[:, :2], img,
                          embeds[:, 2 + img.shape[1]:]], dim=1)

    def rope_q_only(self, query, key, value, capture_attention=False):
        q = attention._split_heads(self.wq(query), self.num_heads)
        k = attention._split_heads(self.wk(key), self.num_heads)
        cos, sin = rope_cos_sin(torch.arange(q.shape[1], device=q.device),
                                q.shape[-1], self.theta)
        return self.attend(apply_rope(q, cos, sin), k, value, None,
                           capture_attention)

    grid = cfg.projector.grid_pre(cfg.vision.image_size,
                                  cfg.vision.patch_size)
    owner, replacements = {
        "vanilla": (attention.VanillaMultiheadAttention,
                    {"attend": attend_no_dense}),
        "linvt": (u2_model.U2CausalLM, {"splice_embeds": splice_late}),
        "sequence_pool": (projector, {"sequence_pool": lambda x, pool:
                                      spatial_pool_3d(x, grid, pool)}),
        "linear_projector": (attention.RotaryMultiheadAttention,
                             {"forward": rope_q_only})}[name]
    with planted(owner, replacements):
        yield


def prefill_report(torch, model, batch, cache_dtype, steps: int):
    """The report path's prefill of ``batch`` (its valid tokens the prompt)
    and ``steps`` greedy tokens from a ``cache_dtype`` cache: (the prefill's
    last logits in fp32, the tokens)."""
    from u2tokenizer_torch.config import GenerationConfig
    from u2tokenizer_torch.models.generate import make_multimodal_generate_fn

    fn = make_multimodal_generate_fn(
        model, GenerationConfig(max_new_tokens=steps, eos_token_id=-2),
        cache_dtype)
    plen = batch["attention_mask"].sum(-1).to(torch.int32)
    embeds = fn.embeds(batch["input_ids"], batch["images"],
                       batch["question_ids"])
    kv, tok0, done0, last = fn.prefill_stage(embeds, plen)
    with torch.inference_mode():
        logits = model.lm_logits(last)[:, 0].float()
    _, _, rest = fn.decode_steps(kv, tok0, done0, plen, range(steps - 1))
    return logits, torch.cat([tok0[:, None], rest], dim=1)


def loss_and_grads(torch, model, batch):
    """(loss, {name: gradient}) of the SFT loss, every parameter's gradient
    materialised (zeros where no path reaches it)."""
    from u2tokenizer_torch.train.sft import make_loss_fn

    names, params = zip(*model.named_parameters())
    loss, _ = make_loss_fn()(model, batch)
    grads = torch.autograd.grad(loss, params, allow_unused=True,
                                materialize_grads=True)
    return loss.item(), dict(zip(names, grads))


def ablation_variant(torch, fa, da, name: str, cfg) -> tuple:
    """One variant of the matrix (``ablation_configs``): its fp32 plain
    reference on the card (prefill logits, loss, gradients), then the bf16
    model with the kernels (an ABLATION_TOKENS greedy report, launches K1
    once per ViT layer and K2 once per decoder layer; ABLATION_STEPS steps
    of ``sft.make_trainer``, each K1 12, K2 2 x ABLATION_LAYERS under
    remat, K4a-c 12 + ABLATION_LAYERS, the first's gradients held to the
    reference's), then its planted fault from the same weights, which
    the same limits must reject. Returns (the line, the launches)."""
    from u2tokenizer_torch.config import TrainConfig
    from u2tokenizer_torch.models.u2_model import U2CausalLM
    from u2tokenizer_torch.train import sft

    batch = {k: v.cuda() for k, v in training_batch(
        torch, cfg, PROMPT, [TRAIN_VALID], TRAIN_PROMPT, seed=5).items()}
    t0 = time.perf_counter()
    model = U2CausalLM(cfg, dtype=torch.bfloat16, device="cuda", seed=5,
                       remat=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    plain = U2CausalLM(cfg, dtype=torch.float32, device="cuda", seed=5,
                       remat=True)
    plain.load_state_dict(weights)
    with planted(fa, plain_attention(fa)):
        ref_logits, _ = prefill_report(torch, plain, batch, torch.float32, 1)
        ref_loss, grads = loss_and_grads(torch, plain, batch)
    ref = {n: g.double().flatten() for n, g in grads.items()}
    del plain, grads
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reference_s = time.perf_counter() - t0

    rel = lambda out: ((out - ref_logits).abs().max()
                       / ref_logits.abs().max()).item()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fa, da)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, tokens = prefill_report(torch, model, batch, torch.bfloat16,
                                    ABLATION_TOKENS)
    torch.cuda.synchronize()
    report_s = time.perf_counter() - t0
    report_launches = read_launches(fa, da)
    want = {name: 0 for name in report_launches}
    want.update({"flash_fwd_noncausal": cfg.vision.num_layers,
                 "flash_fwd_causal": cfg.llm.num_layers})
    if report_launches != want:
        raise AssertionError(f"ablation {name} report launches "
                             f"{report_launches} != {want}")
    vocab = cfg.llm.vocab_size
    if not (tokens.shape == (1, ABLATION_TOKENS)
            and ((tokens >= 0) & (tokens < vocab)).all()):
        raise AssertionError(f"ablation {name} report tokens {tokens}")
    with step_probe(torch, fa, da, sft, "make_trainer", unpack=True) as recs:
        state, step = sft.make_trainer(model, TrainConfig(), ABLATION_STEPS)
        state, _ = step(state, batch)
        sound = gradient_readings(torch, model_grads(model), ref)
        for _ in range(ABLATION_STEPS - 1):
            state, _ = step(state, batch)
    peak = torch.cuda.max_memory_allocated()
    expect_launches(f"ablation {name} train", recs, {
        "flash_fwd_noncausal": cfg.vision.num_layers,
        "flash_fwd_causal": 2 * cfg.llm.num_layers,
        **{k: cfg.vision.num_layers + cfg.llm.num_layers
           for k in ("flash_bwd_lse", "flash_bwd_dq", "flash_bwd_dkv")}})
    readings = step_readings(recs)
    launches = {k: n + sum(r["launches"][k] for r in recs)
                for k, n in report_launches.items()}
    del state, step
    card_loss = readings["loss"][0]
    line = {"params": n_params, "decoder_layers": cfg.llm.num_layers,
            "chunks": cfg.num_chunks, "attn_type": cfg.u2t.attn_type,
            "u2tokenizer": cfg.u2t.enable,
            "projector": cfg.projector.projector_type,
            "pooling": cfg.projector.pooling_type,
            "model_build_s": build_s, "fp32_reference_s": reference_s,
            "report_s": report_s, "report_tokens": ABLATION_TOKENS,
            **readings, "peak_mem_gb": peak / 1e9,
            "report_launches": report_launches,
            "logits_rel_err": rel(logits), "logits_tol": LOGIT_TOL,
            "loss_fp32": ref_loss,
            "loss_rel_err": abs(card_loss - ref_loss) / abs(ref_loss),
            "leaves_held": sum(map(ablation_judged, sound)),
            "leaves": len(sound), "held": worst_leaves(sound, ablation_judged),
            "left_out": left_out_medians(sound, ablation_left_out,
                                         ABLATION_LEFT_OUT)}
    bad = misfits(sound, ablation_judged)
    if not (line["logits_rel_err"] <= LOGIT_TOL
            and line["loss_rel_err"] <= TRAIN_LOSS_TOL and not bad):
        raise AssertionError(f"ablation {name} against its fp32 plain "
                             f"reference: {line}, rejected leaves {bad}")

    model.load_state_dict(weights)
    with ablation_fault(torch, name, cfg):
        fault_logits, _ = prefill_report(torch, model, batch,
                                         torch.bfloat16, 1)
        _, grads = loss_and_grads(torch, model, batch)
    wrong = gradient_readings(torch, grads, ref)
    fault = {"fault": ABLATION_FAULTS[name],
             "logits_rel_err": rel(fault_logits),
             "leaves_rejected": len(misfits(wrong, ablation_judged)),
             **worst_leaves(wrong, ablation_judged)}
    if not (fault["logits_rel_err"] > LOGIT_TOL or fault["leaves_rejected"]):
        raise AssertionError(f"ablation {name}: the limits do not reject "
                             f"the planted fault: {fault}")
    line["planted_fault"] = fault
    del model, weights, ref, grads
    gc.collect()
    torch.cuda.empty_cache()
    return line, launches


def rma_linear_raises(torch, cfg) -> dict:
    """'rma' over the linear projector's 2048 tokens a chunk: the SVR's
    spatial attention spans past the bias table's max_seq_len (known
    difference 15), so the μ²tokenizer raises before it forms an index,
    and the card goes on."""
    from u2tokenizer_torch.models.layers import init_weights
    from u2tokenizer_torch.models.u2tok.u2tokenizer import U2Tokenizer

    e = cfg.llm.hidden_size
    u2t = dataclasses.replace(cfg.u2t, attn_type="rma", num_layers=1)
    module = U2Tokenizer(e, u2t, torch.bfloat16, "cuda")
    init_weights(module, 0)
    tokens = torch.randn(1, cfg.num_chunks, 2048, e, device="cuda",
                         dtype=torch.bfloat16)
    text = torch.randn(1, QUESTION, e, device="cuda", dtype=torch.bfloat16)
    try:
        module(tokens, text)
    except ValueError as err:
        message = str(err)
    else:
        raise AssertionError("'rma' over 2048 tokens a chunk did not raise")
    ok = torch.ones(4, device="cuda").sum().item() == 4.0
    torch.cuda.synchronize()
    return {"raised": "ValueError", "message": message,
            "card_answers_after": ok}


def png_size(path: str) -> tuple:
    """(height, width) of an 8-bit RGB PNG whose image data zlib decodes
    to one filter byte and 3 bytes a pixel a row."""
    import struct
    import zlib

    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path} is not a PNG")
    pos, body = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body[tag] = body.get(tag, b"") + data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, colour = struct.unpack(">IIBB", body[b"IHDR"][:10])
    if (depth, colour) != (8, 2) or len(zlib.decompress(body[b"IDAT"])) \
            != h * (1 + 3 * w):
        raise AssertionError(f"{path}: {depth}-bit colour type {colour}, "
                             f"image data not {h} rows of {w} RGB pixels")
    return h, w


def demo_prompt(torch, tok, cfg, question: str, max_length: int = 1024):
    """``cli demo``'s inputs for ``question``, written here from its
    recipe: the chat template over the image placeholders and the
    question, padded to ``max_length``; the question's ids padded to 64;
    the prompt length."""
    ids = tok(tok.apply_chat_template([{"role": "user", "content":
                                        "<im_patch>" * cfg.proj_out_num
                                        + question}]))["input_ids"]
    q = tok(question)["input_ids"]
    row = lambda x, n: torch.tensor([x + [0] * (n - len(x))],
                                    device="cuda")
    return (row(ids, max_length), row(q, 64),
            torch.tensor([len(ids)], dtype=torch.int32, device="cuda"))


# the ablation's CLI leg trains and demos the released μ²Llama-3.2-1B with
# 'rope' at ABLATION_CLI_LAYERS of its 16 decoder layers (all 16 until the
# mesh leg came, cut for the script's time: its checkpoint and export scale
# with them)
ABLATION_CLI_LAYERS = 8


def ablation_cli_config():
    """The released configuration, the decoder at ABLATION_CLI_LAYERS."""
    cfg = released_config()
    return dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_layers=ABLATION_CLI_LAYERS))


def ablation_cli_leg(torch, fa, da, tok, data: str, volume,
                     tmp: str) -> tuple:
    """``cli train --config <released> --attn-type rope``, the decoder at
    ABLATION_CLI_LAYERS of its 16 layers, for ABLATION_STEPS steps from
    the stage-2 phase's files (no ``--pretrained``: an 'rma' checkpoint's
    bias tables have no place in a rope model), each step K1 12, K2 twice
    and K4a-c once a decoder layer and K4a-c 12 more (the ViT); the trained state
    exported by ``save_hf_checkpoint`` (fp32); then ``cli demo
    --checkpoint --attention`` on one question, timed by stage (load,
    capture, answer), K1 24 and K2 once a decoder layer in all. Held: the answer's tokens
    and text those of ``make_multimodal_generate_fn`` driven here, stage
    by stage, on inputs built here and the demo's model; the capture's
    image tokens ``encode_vision``'s bit for bit; every map's rows sum to
    1; the PNG decodes to ``png_layout``'s size. Returns (the line, the
    train launches, the demo launches)."""
    from u2tokenizer_torch import cli
    from u2tokenizer_torch.config import GenerationConfig
    from u2tokenizer_torch.eval import attention_viz
    from u2tokenizer_torch.models import generate
    from u2tokenizer_torch.models.hf_export import save_hf_checkpoint
    from u2tokenizer_torch.train import sft
    from u2tokenizer_torch.weights import flax_params

    config_path = os.path.join(tmp, "ablation_cli_config.json")
    with open(config_path, "w") as f:
        f.write(ablation_cli_config().to_json())
    out = os.path.join(tmp, "sft_rope")
    reset_launches(fa, da)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with step_probe(torch, fa, da, sft, "make_trainer", unpack=True) as recs:
        state = cli_run(["train", "--config", config_path, "--attn-type",
                         "rope", "--tokenizer", "mock", "--train-base-path",
                         data, "--train-jsonl-path", "cases.jsonl",
                         "--max-steps", str(ABLATION_STEPS), "--batch-size",
                         "1", "--max-length", "1024", "--num-workers", "2",
                         "--output-dir", out], tokenizer=tok)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = read_launches(fa, da)
    peak = torch.cuda.max_memory_allocated()
    layers = ABLATION_CLI_LAYERS
    expect_launches("train --attn-type rope", recs, {
        "flash_fwd_noncausal": 12, "flash_fwd_causal": 2 * layers,
        **{name: 12 + layers for name in fa.BWD_KERNELS}})
    readings = step_readings(recs)
    if not all(math.isfinite(x) for x in readings["loss"]
               + readings["grad_norm"]):
        raise AssertionError(f"train --attn-type rope: {readings}")
    model = state.model
    cfg = model.cfg
    if cfg.u2t.attn_type != "rope" or any(
            n.endswith("relative_bias") for n, _ in model.named_parameters()):
        raise AssertionError(f"train --attn-type rope built {cfg.u2t}")
    ckpt_gb = sum(e.stat().st_size for e in os.scandir(
        os.path.join(out, "checkpoints", str(ABLATION_STEPS)))) / 1e9
    shutil.rmtree(out)
    ckpt = os.path.join(tmp, "mu2llama_rope")
    gc.collect()
    t0 = time.perf_counter()
    save_hf_checkpoint(ckpt, flax_params(model), cfg)
    export_s = time.perf_counter() - t0
    export_gb = sum(e.stat().st_size for e in os.scandir(ckpt)) / 1e9
    del state, model
    gc.collect()
    torch.cuda.empty_cache()

    loaded, captured = [], []
    load, capture = cli._init_or_load, attention_viz.capture_attention_maps

    def timed(fn, into):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(*a, **kw)
            torch.cuda.synchronize()
            into.append((result, time.perf_counter() - t0))
            return result
        return call

    record = lambda args, out: {"args": [a.clone() for a in args[:4]],
                                "tokens": out[0].clone()}
    png = os.path.join(tmp, "attention.png")
    question = GREEN_QUESTIONS[0]
    printed = io.StringIO()
    reset_launches(fa, da)
    t0 = time.perf_counter()
    with planted(cli, {"_init_or_load": timed(load, loaded)}), \
            planted(attention_viz, {"capture_attention_maps":
                                    timed(capture, captured)}), \
            step_probe(torch, fa, da, generate,
                       "make_multimodal_generate_fn",
                       record=record) as answers, \
            contextlib.redirect_stdout(printed):
        texts = cli_run(["demo", "--checkpoint", ckpt, "--tokenizer", "mock",
                         "--image", os.path.join(tmp, "ct.nii"),
                         "--question", question, "--attention", png,
                         "--max-new-tokens", str(DEMO_TOKENS)],
                        tokenizer=tok)
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - t0
    demo_launches = read_launches(fa, da)
    want = {k: 0 for k in demo_launches}
    want.update({"flash_fwd_noncausal": 24, "flash_fwd_causal": layers})
    if demo_launches != want:
        raise AssertionError(f"cli demo launches {demo_launches} != {want}")
    (model, load_s), = loaded
    (maps, capture_s), = captured
    answer, = answers
    if printed.getvalue().splitlines() != texts or len(texts) != 1:
        raise AssertionError(f"cli demo printed {printed.getvalue()!r}, "
                             f"returned {texts}")
    if model.cfg.u2t.attn_type != "rope":
        raise AssertionError(f"cli demo built {model.cfg.u2t}")

    # the answer again, outside the command: inputs built here, the
    # demo's model, stage by stage
    ids, qids, plen = demo_prompt(torch, tok, model.cfg, question)
    images = volume.float()[None]
    for got, mine, what in zip(answer["args"], (ids, images, qids, plen),
                               ("ids", "volume", "question ids",
                                "prompt length")):
        if not torch.equal(got, mine):
            raise AssertionError(f"cli demo's {what} differ from the "
                                 "recipe's")
    gen = GenerationConfig(max_new_tokens=DEMO_TOKENS, do_sample=False,
                           eos_token_id=tok.eos_token_id,
                           pad_token_id=tok.pad_token_id or 0)
    fn = generate.make_multimodal_generate_fn(model, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embeds = fn.embeds(ids, images, qids)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    kv, tok0, done0, _ = fn.prefill_stage(embeds, plen)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _, _, rest = fn.decode_steps(kv, tok0, done0, plen,
                                 range(DEMO_TOKENS - 1))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    direct = torch.cat([tok0[:, None], rest], dim=1)[0]
    text = tok.decode([t for t in direct.tolist()
                       if t not in (gen.pad_token_id, tok.eos_token_id)])
    if not (torch.equal(answer["tokens"], direct) and text == texts[0]):
        diff = (answer["tokens"] != direct).nonzero()[:, 0].tolist()
        raise AssertionError(f"cli demo's answer differs from "
                             f"make_multimodal_generate_fn's at {diff[:8]}")
    with torch.inference_mode():
        plain_tokens = model.encode_vision(images, qids)
        captured_tokens = model.encode_vision_with_attention(images, qids)
    if not torch.equal(plain_tokens, captured_tokens):
        raise AssertionError("attention capture changed the image tokens")
    keys = ("svr_spatial", "svr_temporal", "tta_self", "tta_cross_visual",
            "tta_cross_text")
    sums = {k: float(abs(maps[k].sum(-1) - 1).max()) for k in keys}
    if set(maps) != set(keys) or not max(sums.values()) <= MAP_SUM_TOL:
        raise AssertionError(f"captured maps {sorted(maps)}: rows sum to 1 "
                             f"within {sums}")
    size = png_size(png)
    if size != attention_viz.png_layout(model.cfg.num_chunks):
        raise AssertionError(f"attention PNG of {size}")
    del model, fn, kv, embeds, plain_tokens, captured_tokens, loaded
    shutil.rmtree(ckpt)
    gc.collect()
    torch.cuda.empty_cache()
    line = {"model": "mu2Llama-3.2-1B, attn_type rope",
            "train": {**readings, "cli_total_s": train_s,
                      "valid_tokens": [r["lens"] for r in recs],
                      "checkpoint_gb": ckpt_gb, "peak_mem_gb": peak / 1e9},
            "export": {"s": export_s, "gb": export_gb,
                       "form": "save_hf_checkpoint, fp32"},
            "demo": {"cli_total_s": demo_s, "load_s": load_s,
                     "capture_s": capture_s, "answer_s": answer["s"],
                     "answer_vision_s": t1 - t0, "answer_prefill_s": t2 - t1,
                     "answer_decode_s": t3 - t2,
                     "decode_ms_per_step": 1e3 * (t3 - t2) / (DEMO_TOKENS - 1),
                     "max_new_tokens": DEMO_TOKENS, "prompt_len": int(plen),
                     "launches": {k: n for k, n in demo_launches.items()
                                  if n},
                     "tokens_equal_direct": True,
                     "map_shapes": {k: list(maps[k].shape) for k in keys},
                     "map_row_sum_err": sums, "png": list(size),
                     "answer_words": len(texts[0].split())}}
    return line, train_launches, demo_launches


def drive_ablation(torch, fa, da, volume, tmp: str, card: str) -> dict:
    """The stage-1 ablation phase, from the stage-2 phase's files and the
    report phase's CT ``tmp/ct.nii`` (``volume`` its transform): the CLI
    leg (``ablation_cli_leg``), each variant of ``ablation_configs``
    (``ablation_variant``), and 'rma' over the linear projector's tokens
    (``rma_linear_raises``). One printed line each; returns the launches
    by path."""
    tok = green_tokenizer(released_config().llm.vocab_size)
    counts = {}
    line, counts["ablation_cli_train"], counts["ablation_cli_demo"] = \
        ablation_cli_leg(torch, fa, da, tok, os.path.join(tmp, "green_dpo"),
                         volume, tmp)
    line["card"] = card
    print(json.dumps({"ablation_cli_rope": line}), flush=True)
    matrix = {}
    for name, cfg in ablation_configs().items():
        t0 = time.perf_counter()
        matrix[name], counts[f"ablation_{name}"] = ablation_variant(
            torch, fa, da, name, cfg)
        matrix[name]["variant_s"] = time.perf_counter() - t0
    matrix["rma_with_linear_projector"] = rma_linear_raises(
        torch, ablation_configs()["linear_projector"])
    print(json.dumps({"ablation_matrix": matrix, "card": card}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# μ²Qwen3-8B (``drive_qwen3_8b``)
# ---------------------------------------------------------------------------

# bench.py's 8B serving configuration (BENCH_MODEL=8b; bench.py:47-58,
# 123-126, 197-206): int8 decoder weights, the int4 KV cache, B=16 volumes,
# the ViT over one group of 128 chunks, QWEN8B_NEW greedy tokens (bench.py's
# 768 cut for the script's time, to 64 from 128 when the data-preparation
# phase came), the decoder at QWEN8B_SERVE_LAYERS of its 36 layers (all 36
# until the mesh leg came, cut for the script's time: the seeded model's
# build and every step scale with it). Each decode step launches K3-int4
# once a layer (32 query heads over 8 kv heads of 128).
QWEN8B_BATCH, QWEN8B_NEW, QWEN8B_SERVE_LAYERS = 16, 64, 18
QWEN8B_HEADS = (32, 8, 128)
# The 8B's kernel forms, D=128 at a GQA group of 4: K2 at its serving
# prefill (16 rows of 1024, the last 900), K3-int4 at its decode (1024 +
# QWEN8B_NEW slots; timed at the middle step, checked at the first and
# last) and K4a-c at its QLoRA call (B=1, 1024 tokens, the stage-2 phase's
# first case valid for QLORA_VALID), each timed.
QWEN8B_SERVE_CALL = dict(QWEN8B_PREFILL_CALL, b=QWEN8B_BATCH,
                         lens=[PROMPT] * (QWEN8B_BATCH - 1) + [RAGGED])
QWEN8B_QLORA_CALL = dict(QWEN8B_PREFILL_CALL, b=1, lens=[QLORA_VALID])
# Its QLoRA stage 1 from the CLI, as the JAX package's 8B tool sets it up
# (tools_train_8b_qlora.py:74-83: an int4 base, the int8 head in 8 tiles),
# with the vision tower frozen and the 'dots_no_batch' remat policy,
# QWEN8B_QLORA_STEPS steps of B=1 at 1024 tokens from seeded weights, the
# decoder at QWEN8B_QLORA_LAYERS of its 36 layers (all 36 until the
# data-preparation phase came, 18 until the mesh leg came, cut for the
# script's time). Each step launches K1 12 (the frozen ViT), K2 24 at
# D=128 (12 layers, the forward again in the recompute: the flash Function
# is no aten op, so no policy keeps its output) and K4a-c 12 each.
QWEN8B_QLORA_STEPS, QWEN8B_TILES, QWEN8B_REMAT = 3, 8, "dots_no_batch"
QWEN8B_QLORA_LAYERS = 12
QWEN8B_QLORA_LAUNCHES = {"flash_fwd_noncausal_d64": 12,
                         "flash_fwd_causal_d128": 2 * QWEN8B_QLORA_LAYERS,
                         "flash_bwd_lse_d128": QWEN8B_QLORA_LAYERS,
                         "flash_bwd_dq_d128": QWEN8B_QLORA_LAYERS,
                         "flash_bwd_dkv_d128": QWEN8B_QLORA_LAYERS}
# The remat policies on the card: the same QLoRA model with POLICY_LAYERS
# decoder layers, one step on one batch under each of REMAT_POLICIES, every
# trainable leaf's gradient within POLICY_COS_MIN and POLICY_NORM_TOL of
# its gradient under "nothing" (a policy changes what the backward
# recomputes, not a number: K4a-c use no atomics, so the same bits are
# expected, and each reading says whether they are), the launches a step
# equal under all three.
POLICY_LAYERS = 4
REMAT_POLICIES = ("nothing", "dots_no_batch", "dots")
POLICY_COS_MIN, POLICY_NORM_TOL = 0.99999, 1e-4
# ``cli convert-checkpoint`` on the report phase's μ²Llama-3.2-1B export,
# then ``cli generate`` of CONVERT_TOKENS greedy tokens on one case from the
# converted directory and from the HF one. ``U2InferenceModel(lora_path=)``
# on the same export: adapters of LORA_RANK and LORA_ALPHA on every target
# kernel, lora_a ~ N(0, 1/r) and lora_b ~ N(0, (LORA_B_SCALE sigma)^2), sigma
# the kernel's spread, so that (alpha/r) A @ B spreads by 2 LORA_B_SCALE
# sigma, a tenth of the weights', as QLORA_B_STD reasons; LORA_TOKENS greedy
# tokens and the first step's logits against the same adapters folded by
# hand; the adapted logits at least LORA_MIN_REL (relative) off the base's.
CONVERT_TOKENS, LORA_TOKENS = 64, 64  # CONVERT_TOKENS 128 until the
                                      # data-preparation phase came
LORA_RANK, LORA_ALPHA, LORA_B_SCALE, LORA_MIN_REL = 16, 32, 0.05, 1e-2


def qwen8b_config(layers: int = 0, tiles: int = 0):
    """μ²Qwen3-8B: the default μ² stack (ViT3D 12 x 768, SPP, the
    μ²tokenizer at the decoder's width) on the ``qwen3_8b`` decoder (36
    layers, 32 / 8 heads of 128, an untied 151,936 x 4096 head), cut to
    ``layers`` decoder layers and the head in ``tiles`` where given."""
    from u2tokenizer_torch.config import LLMConfig, U2ModelConfig

    llm = LLMConfig.qwen3_8b()
    return U2ModelConfig(llm=dataclasses.replace(
        llm, num_layers=layers or llm.num_layers, lm_head_tiles=tiles))


def qwen8b_kernel_checks(torch, F, fa, da, attn) -> tuple:
    """The 8B forms (D=128, group 4): K2 at QWEN8B_SERVE_CALL, K4a-c at
    QWEN8B_QLORA_CALL and K3-int4 at the serving decode's middle step,
    timed; K3-int4 at its first and last steps, checked. Returns (the
    timed entries, named by form, each with the largest error of its
    form's checks; the untimed checks)."""
    timed = {"flash_fwd_causal_d128_g4": check_flash(
        torch, F, fa, QWEN8B_SERVE_CALL, 80)}
    for entry in check_flash_bwd(torch, F, fa, QWEN8B_QLORA_CALL, 81):
        timed[f"{entry['name']}_d128_g4"] = entry
    decode = dict(heads=QWEN8B_HEADS, new=QWEN8B_NEW)
    timed["decode_attention_int4_d128_g4"] = check_decode(
        torch, da, attn, 4, QWEN8B_BATCH, (QWEN8B_NEW - 1) // 2, **decode)
    checks = [check_decode(torch, da, attn, 4, QWEN8B_BATCH, step,
                           timed=False, **decode)
              for step in (0, QWEN8B_NEW - 1)]
    entry = timed["decode_attention_int4_d128_g4"]
    entry["max_abs_err"] = max([entry["max_abs_err"]]
                               + [c["max_abs_err"] for c in checks])
    for form, entry in timed.items():
        entry["head_dim"], entry["group"] = 128, 4
        entry["kernel"], entry["name"] = entry["name"], form
    return timed, checks


def qwen8b_serving(torch, da, card: str) -> dict:
    """``serve_and_check`` at bench.py's 8B configuration (the seeded
    model drawn in fp32 on the card, cast to bf16 parameter by parameter,
    then quantized: the build's peak is its fp32 size), and the 2-layer
    model at the 8B widths, int8 weights with the int4 cache, against the
    CPU's fp32 (``check_reference``) with the host memory it took."""
    cfg = qwen8b_config(layers=QWEN8B_SERVE_LAYERS)
    run = serve_and_check(torch, da, QWEN8B_NEW, QWEN8B_BATCH, "int8",
                          "int4", QUANT_MICROBATCH, card, cfg,
                          label="serve_mu2qwen3_8b")
    gc.collect()
    torch.cuda.empty_cache()
    with host_memory() as host:
        t0 = time.perf_counter()
        line = check_reference(torch, "int8", "int4", cfg)
    line.update(check_s=time.perf_counter() - t0, host_gb=host, card=card)
    print(json.dumps({"reference_check": line}), flush=True)
    return run["launches"]


def qwen8b_qlora(torch, F, fa, da, tmp: str, tok, card: str) -> tuple:
    """``cli train --qlora int4 --freeze-vision-tower --remat
    dots_no_batch`` at μ²Qwen3-8B (``qlora_cli_leg``, the head in
    QWEN8B_TILES tiles, no ``--pretrained``: seeded weights; ``tok`` the
    stage-2 phase's tokenizer, whose ids all lie below the 8B's
    vocabulary), then K4a-c at its steps' other valid lengths, checked.
    Returns (the launches, the checks)."""
    cfg = qwen8b_config(layers=QWEN8B_QLORA_LAYERS, tiles=QWEN8B_TILES)
    line, launches, lens = qlora_cli_leg(
        torch, fa, da, tmp, cfg, "int4", QWEN8B_QLORA_STEPS,
        QWEN8B_QLORA_LAUNCHES, QWEN8B_QLORA_CALL,
        ["--freeze-vision-tower", "--remat", QWEN8B_REMAT], tok)
    line["card"] = card
    print(json.dumps({"qlora_mu2qwen3_8b": line}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    checks = [e for i, n in enumerate(n for n in lens if n != QLORA_VALID)
              for e in check_flash_bwd(
                  torch, F, fa, dict(QWEN8B_QLORA_CALL, lens=[n]), 90 + i,
                  timed=False)]
    for k in checks:
        print(json.dumps({"kernel_check": k}), flush=True)
    return launches, checks


def remat_policy_steps(torch, fa, da, card: str) -> dict:
    """One step of the QLoRA model at the 8B widths (POLICY_LAYERS decoder
    layers, set up by ``lora.make_qlora_trainer`` as the CLI does, lora_b
    drawn at QLORA_B_STD so that every adapter has a gradient) under each
    of REMAT_POLICIES on one batch, in two rounds (the second read): loss,
    s/step, peak memory and the launches of the step; every trainable
    leaf's gradient against "nothing"'s (cosine, norm ratio, the same
    bits), held to POLICY_COS_MIN and POLICY_NORM_TOL, and the launches
    held equal. Returns the launches of all the steps."""
    from u2tokenizer_torch.config import TrainConfig
    from u2tokenizer_torch.models.u2_model import U2CausalLM
    from u2tokenizer_torch.train import lora
    from u2tokenizer_torch.train.sft import make_loss_fn

    cfg = qwen8b_config(layers=POLICY_LAYERS, tiles=QWEN8B_TILES)
    model = U2CausalLM(cfg, dtype=torch.bfloat16, device="cuda", seed=0,
                       remat="nothing")
    train = lora.make_qlora_trainer(model, TrainConfig(), 1, "int4")[0].train
    g = torch.Generator(device="cuda").manual_seed(3)
    with torch.no_grad():
        for path, p in train.items():
            if path.endswith("/lora_b"):
                p.normal_(0.0, QLORA_B_STD, generator=g)
    batch = {k: v.to("cuda") for k, v in training_batch(
        torch, cfg, PROMPT, [QLORA_VALID], TRAIN_PROMPT, seed=2).items()}
    loss_fn = make_loss_fn()
    reset_launches(fa, da)
    total = read_launches(fa, da, by_dim=True)
    runs, grads = {}, {}
    # two rounds over the policies, the second read, so that no policy's
    # reading pays for the allocator's growth to another's peak
    for policy in REMAT_POLICIES * 2:
        model.llm.model.remat = policy
        grads.pop(policy, None)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = read_launches(fa, da, by_dim=True)
        t0 = time.perf_counter()
        loss, _ = loss_fn(model, batch)
        step = torch.autograd.grad(loss, list(train.values()),
                                   allow_unused=True, materialize_grads=True)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        after = read_launches(fa, da, by_dim=True)
        grads[policy] = dict(zip(train, step))
        runs[policy] = {
            "loss": loss.item(), "s_per_step": s,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "step_peak_over_weights_gb":
                (torch.cuda.max_memory_allocated() - base) / 1e9,
            "launches_per_step": {k: n - before[k] for k, n in after.items()
                                  if n - before[k]}}
        del loss, step
    ref = {k: v.double().flatten() for k, v in grads["nothing"].items()}
    for policy in REMAT_POLICIES[1:]:
        readings = gradient_readings(torch, grads[policy], ref)
        runs[policy].update(
            min_cos=min(r["cos"] for r in readings.values()),
            max_norm_ratio_off=max(abs(r["norm_ratio"] - 1)
                                   for r in readings.values()),
            leaves=len(readings),
            leaves_same_bits=sum(torch.equal(grads[policy][k],
                                             grads["nothing"][k])
                                 for k in train),
            loss_same_bits=runs[policy]["loss"] == runs["nothing"]["loss"])
        if not (runs[policy]["min_cos"] >= POLICY_COS_MIN
                and runs[policy]["max_norm_ratio_off"] <= POLICY_NORM_TOL):
            worst = min(readings, key=lambda k: readings[k]["cos"])
            raise AssertionError(f"remat {policy!r}: gradients off those of "
                                 f"'nothing' ({worst}: {readings[worst]})")
        if runs[policy]["launches_per_step"] != \
                runs["nothing"]["launches_per_step"]:
            raise AssertionError(
                f"remat {policy!r}: launches a step "
                f"{runs[policy]['launches_per_step']} != 'nothing''s "
                f"{runs['nothing']['launches_per_step']}")
    del grads, ref, model, train, batch
    print(json.dumps({"remat_policies_mu2qwen3_8b": {
        "decoder_layers": POLICY_LAYERS, "qlora": "int4",
        "batch": 1, "seq": PROMPT, "valid_tokens": QLORA_VALID,
        "cos_min": POLICY_COS_MIN, "norm_tol": POLICY_NORM_TOL,
        **runs, "card": card}}), flush=True)
    after = read_launches(fa, da, by_dim=True)
    return by_kernel({k: n - total[k] for k, n in after.items()})


def convert_leg(torch, fa, da, tmp: str, tok) -> dict:
    """``cli convert-checkpoint`` of the report phase's export
    ``tmp/mu2llama`` (host only), then ``cli generate --checkpoint`` of
    CONVERT_TOKENS greedy tokens on the stage-2 phase's first case from
    the HF directory and from the converted one: the tokens (through
    ``step_probe`` around ``make_multimodal_generate_fn``) equal bit for
    bit. Returns the result line."""
    from u2tokenizer_torch import cli
    from u2tokenizer_torch.models import generate

    hf = os.path.join(tmp, "mu2llama")
    out = os.path.join(tmp, "mu2llama_converted")
    with host_memory() as host:
        t0 = time.perf_counter()
        printed = cli_run(["convert-checkpoint", "--hf-dir", hf, "--output",
                           out])
        convert_s = time.perf_counter() - t0
    loads, load = [], cli._init_or_load

    def timed_load(*a, **kw):
        t0 = time.perf_counter()
        model = load(*a, **kw)
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t0)
        return model

    tokens, data = {}, os.path.join(tmp, "green_dpo")
    cli._init_or_load = timed_load
    try:
        for name, ckpt in (("hf", hf), ("converted", out)):
            with step_probe(torch, fa, da, generate,
                            "make_multimodal_generate_fn",
                            record=generate_record) as recs:
                cli_run(["generate", "--checkpoint", ckpt, "--tokenizer",
                         "mock", "--base-path", data, "--jsonl-path",
                         "cases.jsonl", "--output",
                         os.path.join(tmp, f"generate_{name}.jsonl"),
                         "--max-new-tokens", str(CONVERT_TOKENS),
                         "--num-samples", "1", "--end", "1"],
                        tokenizer=tok)
            tokens[name] = recs[0]["tokens"]
    finally:
        cli._init_or_load = load
    if not torch.equal(tokens["hf"], tokens["converted"]):
        diff = (tokens["hf"] != tokens["converted"]).nonzero()
        raise AssertionError(f"generate on the converted checkpoint parts "
                             f"from the HF directory's at token "
                             f"{int(diff[0, -1])}")
    line = {"model": MODEL_NAMES["llama"], **printed, "convert_s": convert_s,
            "convert_host_gb": host,
            "msgpack_gb": os.path.getsize(os.path.join(
                out, "u2_params.msgpack")) / 1e9,
            "load_s": dict(zip(("hf", "converted"), loads)),
            "tokens": CONVERT_TOKENS, "tokens_equal": True,
            "first_tokens": tokens["hf"][:8].tolist()}
    shutil.rmtree(out)
    return line


def lora_report(torch, ckpt: str, volume, tok, lora_path=None) -> tuple:
    """A greedy report of LORA_TOKENS tokens from ``U2InferenceModel(ckpt,
    lora_path=)``: (tokens, the first step's fp32 logits, load seconds)."""
    from u2tokenizer_torch.eval.inference import U2InferenceModel

    t0 = time.perf_counter()
    im = U2InferenceModel(ckpt, tokenizer=tok, do_sample=False,
                          speculative=False, max_new_tokens=LORA_TOKENS,
                          lora_path=lora_path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    tokens = im.generate_tokens(volume, REPORT_QUESTION)
    ids, qids, plen = im._encode_prompt(REPORT_QUESTION)
    dev = im.device
    fn = im._gen_fn
    embeds = fn.embeds(torch.from_numpy(ids[None]).to(dev),
                       volume.float()[None],
                       torch.from_numpy(qids[None]).to(dev))
    _, _, _, last = fn.prefill_stage(embeds, torch.tensor(
        [plen], dtype=torch.int32, device=dev))
    with torch.inference_mode():
        logits = im.model.lm_logits(last)[0, 0].float()
    del im, fn, embeds
    gc.collect()
    torch.cuda.empty_cache()
    return tokens, logits, load_s


def lora_path_leg(torch, tmp: str, volume) -> dict:
    """``U2InferenceModel(lora_path=)`` on the report phase's export: an
    adapter directory (``train.lora.save_lora_dir``, flax's msgpack form)
    over every target kernel, and the same adapters folded by hand into
    the fp32 weights on the host (kernel + (alpha/r) A @ B in plain torch)
    and written by ``save_hf_checkpoint``. The LoRA-loaded model's tokens
    and first-step logits equal the folded directory's bit for bit, its
    logits are LORA_MIN_REL off the base's, and an ``adapter_config.json``
    with alpha = r (the scale dropped) does not match. Returns the
    result line."""
    import numpy as np

    from u2tokenizer_torch.eval.inference import load_state_dict
    from u2tokenizer_torch.models.hf_export import save_hf_checkpoint
    from u2tokenizer_torch.models.hf_weights import convert_u2_checkpoint
    from u2tokenizer_torch.train import lora
    from u2tokenizer_torch.weights import flatten

    cfg = released_config()
    hf = os.path.join(tmp, "mu2llama")
    adapter, folded = (os.path.join(tmp, name) for name in
                       ("lora_adapter", "mu2llama_folded"))
    t0 = time.perf_counter()
    flat = flatten(convert_u2_checkpoint(load_state_dict(hf), cfg))
    g = torch.Generator().manual_seed(5)
    adapters = {}
    for path, w in flat.items():
        if w.ndim == 2 and lora.is_lora_target(f"params/{path}"):
            adapters[f"params/{path}"] = {
                "a": torch.randn(w.shape[0], LORA_RANK, generator=g)
                * LORA_RANK ** -0.5,
                "b": torch.randn(LORA_RANK, w.shape[1], generator=g)
                * (LORA_B_SCALE * float(np.std(w)))}
    lcfg = lora.LoraConfig(r=LORA_RANK, alpha=LORA_ALPHA)
    lora.save_lora_dir(adapter, adapters, lcfg)
    for path in flat:  # the hand fold, in fp32 on the host
        ab = adapters.get(f"params/{path}")
        if ab is not None:
            flat[path] = (torch.from_numpy(flat[path])
                          + (LORA_ALPHA / LORA_RANK) * (ab["a"] @ ab["b"])
                          ).numpy()
    save_hf_checkpoint(folded, {"params": lora.unflatten(flat)}, cfg)
    setup_s = time.perf_counter() - t0
    del flat
    gc.collect()
    tok = full_vocab_tokenizer(cfg.llm.vocab_size)
    reports = {"lora": lora_report(torch, hf, volume, tok, adapter),
               "folded": lora_report(torch, folded, volume, tok),
               "base": lora_report(torch, hf, volume, tok)}
    fault = os.path.join(tmp, "lora_fault")
    shutil.copytree(adapter, fault)
    with open(os.path.join(fault, "adapter_config.json"), "w") as f:
        json.dump({"r": LORA_RANK, "alpha": LORA_RANK}, f)
    reports["fault"] = lora_report(torch, hf, volume, tok, fault)
    same = {name: torch.equal(r[0], reports["folded"][0])
            and torch.equal(r[1], reports["folded"][1])
            for name, r in reports.items()}
    base = reports["base"][1]
    rel = {name: ((r[1] - base).abs().max() / base.abs().max()).item()
           for name, r in reports.items()}
    if not same["lora"]:
        raise AssertionError(f"lora_path: the LoRA-loaded model does not "
                             f"match the folded checkpoint "
                             f"({report_diff(reports['lora'][:2], reports['folded'][:2])})")
    if not rel["lora"] >= LORA_MIN_REL:
        raise AssertionError(f"lora_path: the adapters move the logits by "
                             f"{rel['lora']:.3g} of the base's, under "
                             f"{LORA_MIN_REL}")
    if same["fault"]:
        raise AssertionError("lora_path: adapter_config.json with alpha = r "
                             "matches the folded checkpoint")
    line = {"model": MODEL_NAMES["llama"], "rank": LORA_RANK,
            "alpha": LORA_ALPHA, "target_kernels": len(adapters),
            "adapter_mb": os.path.getsize(os.path.join(
                adapter, "adapter.msgpack")) / 1e6,
            "setup_s": setup_s, "tokens": LORA_TOKENS,
            "load_s": {name: r[2] for name, r in reports.items()},
            "same_bits_as_folded": same, "logits_rel_to_base": rel,
            "first_tokens": {name: r[0][:8].tolist()
                             for name, r in reports.items()}}
    for path in (adapter, folded, fault):
        shutil.rmtree(path)
    return line


def drive_qwen3_8b(torch, F, fa, da, volume, tmp: str, tok,
                   card: str) -> tuple:
    """The μ²Qwen3-8B phase, after the ablation phase, from the stage-2
    phase's files and the report phase's export: bench.py's 8B serving
    configuration and its reduced check (``qwen8b_serving``), QLoRA stage
    1 from the CLI (``qwen8b_qlora``), the remat policies
    (``remat_policy_steps``); then on the μ²Llama-3.2-1B export ``cli
    convert-checkpoint`` (``convert_leg``) and ``lora_path``
    (``lora_path_leg``). Returns (the 8B paths' launches by path, by
    kernel; the K4 checks at the QLoRA steps' other lengths; the legs'
    seconds)."""
    counts, legs_s = {}, {}
    t0 = time.perf_counter()
    counts["serve_mu2qwen3_8b"] = qwen8b_serving(torch, da, card)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    counts["qlora_mu2qwen3_8b"], checks = qwen8b_qlora(torch, F, fa, da,
                                                       tmp, tok, card)
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    counts["remat_policies_mu2qwen3_8b"] = remat_policy_steps(
        torch, fa, da, card)
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    line = convert_leg(torch, fa, da, tmp, tok)
    line["card"] = card
    print(json.dumps({"convert_checkpoint_mu2llama": line}), flush=True)
    t4 = time.perf_counter()
    line = lora_path_leg(torch, tmp, volume)
    line["card"] = card
    print(json.dumps({"lora_path_mu2llama": line}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    legs_s = {"serving_and_reference": t1 - t0, "qlora": t2 - t1,
              "remat_policies": t3 - t2, "convert_checkpoint": t4 - t3,
              "lora_path": time.perf_counter() - t4}
    print(json.dumps({"qwen3_8b_phase_s": legs_s}), flush=True)
    return counts, checks, legs_s


# The M3D phase (``drive_m3d``, after the ablation phase): segmentation and
# M3D-Bench at the released μ²Llama-3.2-1B configuration with the full
# SegVol head (``SegConfig``: a 12 x 768 encoder over the whole (32, 256,
# 256) chunk in (4, 16, 16) patches, a two-way decoder of depth 2), seeded
# weights, on a synthetic M3D root in the reference layout (no M3D volume,
# mask or trained seg weight is in the repository: Dice, IoU and recall
# show only that the machinery runs).
M3D_CASES = 4
M3D_TOKENS = 32                # --max-new-tokens of each generated case
                               # (64 until the data-preparation phase came)
M3D_TASK_CASES = {"rec": 2, "reg": 2, "seg": 3, "refseg": 2, "itr": 4}
# a generated case: the ViT's 12 layers over its 8 chunks (K1) and the
# 16-layer prefill (K2); the decode takes the bf16 cache in plain PyTorch,
# as do the SegVol head and the '[SEG]' re-run under its explicit mask
M3D_LAUNCHES = {"flash_fwd_noncausal": 12, "flash_fwd_causal": 16}
ITR_LAUNCHES = {"flash_fwd_noncausal": 12}   # an ITR image; text: none
# the joint step without remat: the ViT's and the decoder's forward once,
# the backward of both through K4a-c
M3D_TRAIN_STEPS = 3
M3D_TRAIN_SEQ, M3D_TRAIN_VALID, M3D_TRAIN_PROMPT = 512, 420, 300
M3D_TRAIN_LAUNCHES = {"flash_fwd_noncausal": 12, "flash_fwd_causal": 16,
                      "flash_bwd_lse": 28, "flash_bwd_dq": 28,
                      "flash_bwd_dkv": 28}
# the '[SEG]' id of the seg tasks: greedy decoding's first token of case 0
# (seeded weights never emit a given '[SEG]'), bound when case 0 has run
SEG_FIRST = -1
# The reduced '[SEG]' generate check: the card (bf16) against the CPU
# (fp32) on the mask logits and on the prompt's part of them (the logits
# less those of no prompt), each within LOGIT_TOL of the CPU's largest, as
# the other reduced checks; the same limits must reject the '[SEG]' state
# taken one row late and the pad gap left open in the re-run.
SEG_CHECK_TOKENS = 8
SEG_FAULTS = ("seg_state_one_row_late", "pad_gap_unmasked")


def m3d_config():
    from u2tokenizer_torch.config import SegConfig

    return dataclasses.replace(released_config(), seg=SegConfig(enable=True))


def seg_reduced_config():
    """``m3d_config`` cut as ``reduced_config`` (2 ViT, 1 μ²tokenizer, 2
    decoder layers, 4 chunks), the SegVol encoder to 2 layers, and the
    head untied: a seeded 2-layer model with the tied head emits its
    input token again and again (its hidden state stays near that token's
    embedding), and the '[SEG]' state one row late is then nearly the
    same state."""
    cfg = reduced_config(num_chunks=4, base=m3d_config())
    return dataclasses.replace(
        cfg, seg=dataclasses.replace(cfg.seg, encoder_layers=2),
        llm=dataclasses.replace(cfg.llm, tie_word_embeddings=False))


def sphere(torch, shape, centre, radius: float, device="cuda"):
    """A float mask of the ball around ``centre`` ([-1, 1] coordinates)."""
    axes = [torch.linspace(-1, 1, n, device=device) for n in shape]
    grid = torch.meshgrid(*axes, indexing="ij")
    dist = sum((g - c) ** 2 for g, c in zip(grid, centre))
    return (dist < radius ** 2).float()


def write_m3d_data(torch, root: str) -> None:
    """M3D_CASES seeded (8, 32, 256, 256) fp32 volumes in [0, 1], a
    (1, 32, 256, 256) uint8 ball mask each, report texts, ``cap.json``,
    the seg split ``0000/test.json`` and ``refseg.csv``, in the layout the
    JAX package's tests use."""
    import csv

    import numpy as np

    cfg = released_config()
    shape = cfg.vision.input_spatial
    g = torch.Generator(device="cuda").manual_seed(11)
    os.makedirs(os.path.join(root, "0000"), exist_ok=True)
    split, caps = [], []
    for i in range(M3D_CASES):
        vol = torch.rand(cfg.num_chunks, *shape, generator=g, device="cuda")
        np.save(os.path.join(root, f"vol{i}.npy"), vol.cpu().numpy())
        mask = sphere(torch, shape, (0.2 * i - 0.3, 0.1 * i, -0.1 * i), 0.4)
        np.save(os.path.join(root, f"mask{i}.npy"),
                mask[None].to(torch.uint8).cpu().numpy())
        with open(os.path.join(root, f"txt{i}.txt"), "w") as f:
            f.write(green_answer(i))
        split.append({"image": f"vol{i}.npy", "label": f"mask{i}.npy",
                      "cls_id": 0})
        caps.append({"image": f"vol{i}.npy", "text": f"txt{i}.txt"})
    with open(os.path.join(root, "0000", "test.json"), "w") as f:
        json.dump(split, f)
    with open(os.path.join(root, "cap.json"), "w") as f:
        json.dump({"test": caps}, f)
    with open(os.path.join(root, "refseg.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["Image", "Mask", "Question",
                                          "Answer"])
        w.writeheader()
        for i in range(M3D_CASES):
            w.writerow({"Image": f"vol{i}.npy", "Mask": f"mask{i}.npy",
                        "Question": f"Segment the lesion of case {i} .",
                        "Answer": "It is [SEG] ."})


def m3d_tokenizer():
    """The whitespace tokenizer; its '[SEG]' is SEG_FIRST, which
    ``seg_bound_to`` binds. The M3D prompts hold a few hundred words, so
    every id stays far below the vocabulary."""
    from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer

    class SegTokenizer(MockTokenizer):
        def convert_tokens_to_ids(self, tokens):
            if tokens == "[SEG]":
                return SEG_FIRST
            return super().convert_tokens_to_ids(tokens)

    return SegTokenizer()


def seg_bound_to(make, pick):
    """``make_seg_generate_fn`` whose '[SEG]' id, when SEG_FIRST, is bound
    to ``pick(row 0's tokens)`` once its first case's tokens are generated,
    before the re-run reads it."""
    def build(model, gen, seg_token_id, *a, **kw):
        fn = make(model, gen, seg_token_id, *a, **kw)
        if seg_token_id == SEG_FIRST:
            inner = fn.gen_fn

            def bound(embeds, prompt_len, generator=None):
                tokens = inner(embeds, prompt_len, generator)
                if fn.seg_token_id == SEG_FIRST:
                    fn.seg_token_id = pick(tokens[0].tolist())
                return tokens

            fn.gen_fn = bound
        return fn

    return build


def first_token(tokens) -> int:
    return tokens[0]


def varied_token(tokens) -> int:
    """The first token that no earlier one equals and the next differs
    from (a seeded model repeats tokens, and the state one row past a
    repeat is nearly the same)."""
    pick = next((t for j, t in enumerate(tokens[:-1])
                 if t not in tokens[:j] and tokens[j + 1] != t), None)
    if pick is None:
        raise AssertionError(f"no token to bind '[SEG]' to in {tokens}")
    return pick


def seg_record(args, out) -> dict:
    """A ``SegGenerate`` call's prompt length, tokens and has_seg (B=1)."""
    return {"prompt_len": int(args[3][0]), "tokens": out[0][0].tolist(),
            "has_seg": bool(out[2][0])}


@contextlib.contextmanager
def itr_probe(torch, fa, da, m3d_bench):
    """``make_u2_itr_encoders`` with every image encode timed and its
    launches kept; yields the records."""
    make, records = m3d_bench.make_u2_itr_encoders, []

    def probed(model):
        enc_img, enc_txt = make(model)

        def run(images):
            before = read_launches(fa, da)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = enc_img(images)
            after = read_launches(fa, da)
            records.append({"s": time.perf_counter() - t0,
                            "launches": {k: n - before[k]
                                         for k, n in after.items()}})
            return out

        return run, enc_txt

    m3d_bench.make_u2_itr_encoders = probed
    try:
        yield records
    finally:
        m3d_bench.make_u2_itr_encoders = make


def m3d_task(torch, fa, da, root: str, cfg_path: str, task: str) -> tuple:
    """``cli eval-m3d --task task`` over M3D_TASK_CASES[task] cases, in
    this process, every case timed with its launches (M3D_LAUNCHES; an ITR
    image ITR_LAUNCHES). Returns (the line, the launches)."""
    from u2tokenizer_torch.eval import m3d_bench
    from u2tokenizer_torch.models import generate

    n = M3D_TASK_CASES[task]
    out = os.path.join(root, f"eval_m3d_{task}.json")
    argv = ["eval-m3d", "--task", task, "--config", cfg_path, "--data-root",
            root, "--seg-data-path", root, "--refseg-data-path",
            os.path.join(root, "refseg.csv"), "--cap-data-path",
            os.path.join(root, "cap.json"), "--max-new-tokens",
            str(M3D_TOKENS), "--max-cases", str(n), "--output", out]
    if task == "itr":
        probe, want = itr_probe(torch, fa, da, m3d_bench), ITR_LAUNCHES
    elif task in ("seg", "refseg"):
        probe, want = step_probe(torch, fa, da, generate,
                                 "make_seg_generate_fn",
                                 record=seg_record), M3D_LAUNCHES
    else:
        probe, want = step_probe(torch, fa, da, generate,
                                 "make_multimodal_generate_fn",
                                 record=generate_record), M3D_LAUNCHES
    reset_launches(fa, da)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with planted(generate, {"make_seg_generate_fn": seg_bound_to(
            generate.make_seg_generate_fn, first_token)}), probe as cases:
        result = cli_run(argv, tokenizer=m3d_tokenizer())
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_launches(fa, da)
    expect_launches(f"eval-m3d {task} case", cases, want)
    if len(cases) != n or len(result.rows) != n:
        raise AssertionError(f"eval-m3d {task}: {len(cases)} cases run, "
                             f"{len(result.rows)} rows")
    line = {"cases": n, "cli_total_s": total_s,
            "s_per_case": statistics.median(c["s"] for c in cases),
            "case_s": [c["s"] for c in cases],
            "launches_per_case": cases[-1]["launches"],
            "metrics": result.metrics,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if task in ("seg", "refseg"):
        has = [c["has_seg"] for c in cases]
        if not has[0] or [r["has_seg"] for r in result.rows] != has:
            raise AssertionError(f"eval-m3d {task}: the '[SEG]' branch of "
                                 f"case 0 not taken: {has}")
        line["has_seg"] = has
        line["dice"] = [r["dice"] for r in result.rows]
    if task != "itr":
        line["prompt_lens"] = [c["prompt_len"] for c in cases]
    return line, launches


def seg_generate_run(torch, model, inputs, seg_id: int, cache_dtype,
                     no_prompt=True):
    """((tokens, mask logits, has_seg, and with ``no_prompt`` the logits
    of no prompt), the '[SEG]' id) of one '[SEG]' generate on ``model``'s
    device; a ``seg_id`` of SEG_FIRST is bound to ``varied_token``."""
    from u2tokenizer_torch.config import GenerationConfig
    from u2tokenizer_torch.models import generate

    dev = model.device
    gen = GenerationConfig(max_new_tokens=SEG_CHECK_TOKENS, eos_token_id=-2)
    fn = seg_bound_to(generate.make_seg_generate_fn, varied_token)(
        model, gen, seg_id, cache_dtype=cache_dtype)
    ids, images, qids, plen, seg_image = (x.to(dev) for x in inputs)
    tokens, logits, has = fn(ids, images, qids, plen, seg_image)
    none = None
    if no_prompt:
        with torch.inference_mode():
            none = model.segment(seg_image, None).float().cpu()
    return ((tokens.cpu(), logits.float().cpu(), has.cpu(), none),
            fn.seg_token_id)


def seg_readings(cpu_run, gpu_run) -> dict:
    """The card's mask logits and their prompt part against the CPU's."""
    _, ref, ref_has, ref_none = cpu_run
    _, out, has, none = gpu_run
    part_ref, part = ref - ref_none, out - none
    return {"logits_rel_err": ((out - ref).abs().max()
                               / ref.abs().max()).item(),
            "prompt_part_rel_err": ((part - part_ref).abs().max()
                                    / part_ref.abs().max()).item(),
            "has_seg_equal": bool((has == ref_has).all())}


def seg_rejected(r: dict) -> bool:
    return not (r["logits_rel_err"] <= LOGIT_TOL
                and r["prompt_part_rel_err"] <= LOGIT_TOL
                and r["has_seg_equal"])


def seg_generate_check(torch, cpu) -> dict:
    """``make_seg_generate_fn`` of ``seg_reduced_config`` on the card (bf16
    weights and cache, the kernels) against the CPU model ``cpu`` (fp32,
    plain versions) on the same seeded weights: B=1, a 384-token prompt valid for 300 (a
    pad gap of 84 rows), SEG_CHECK_TOKENS greedy tokens, '[SEG]' the CPU's
    ``varied_token``. Tokens under the near-tie rule;
    has_seg equal; the mask logits and their prompt part within
    LOGIT_TOL; each of SEG_FAULTS rejected by the same limits."""
    from u2tokenizer_torch.models import generate
    from u2tokenizer_torch.models.quantize import cast_for_inference
    from u2tokenizer_torch.models.u2_model import U2CausalLM

    t0 = time.perf_counter()
    cfg = cpu.cfg
    gpu = cast_for_inference(U2CausalLM(cfg, dtype=torch.bfloat16,
                                        device="cuda", seed=2))
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(3)
    d, h, w = cfg.vision.input_spatial
    inputs = (torch.randint(0, cfg.llm.vocab_size, (1, 384), generator=g),
              torch.randn(1, cfg.num_chunks, d, h, w, generator=g),
              torch.randint(0, cfg.llm.vocab_size, (1, 32), generator=g),
              torch.tensor([300], dtype=torch.int32),
              torch.randn(1, 1, *cfg.seg.image_size, generator=g))
    with top_two(torch, cpu) as top:
        cpu_run, seg_id = seg_generate_run(torch, cpu, inputs, SEG_FIRST,
                                           torch.float32)
    tokens = cpu_run[0][0].tolist()
    gpu_run = seg_generate_run(torch, gpu, inputs, seg_id,
                               torch.bfloat16)[0]
    tie = tie_verdict(tokens, gpu_run[0][0].tolist(), top, -2)
    sound = seg_readings(cpu_run, gpu_run)
    if not (tie["holds"] and bool(cpu_run[2][0])) or seg_rejected(sound):
        raise AssertionError(f"reduced '[SEG]' generate: card vs CPU "
                             f"{sound}, tokens {tokens} / {gpu_run[0]}, "
                             f"{tie}")
    right_state = generate.seg_hidden_state
    right_layout = generate.teacher_forced_layout

    def late(hidden, tokens, s, seg_token_id):
        shifted = torch.cat([hidden[:, 1:], hidden[:, -1:]], dim=1)
        return right_state(shifted, tokens, s, seg_token_id)

    def gap_open(prompt_len, s, t):
        return right_layout(torch.full_like(prompt_len, s), s, t)

    faults = {}
    for label, (name, fn) in zip(SEG_FAULTS, (
            ("seg_hidden_state", late), ("teacher_forced_layout", gap_open))):
        with planted(generate, {name: fn}):
            wrong = seg_generate_run(torch, gpu, inputs, seg_id,
                                     torch.bfloat16, no_prompt=False)[0]
        r = seg_readings(cpu_run, (*wrong[:3], gpu_run[3]))
        if not seg_rejected(r):
            raise AssertionError(f"the '[SEG]' check does not reject the "
                                 f"planted fault {label}: {r}")
        faults[label] = {"rejected": True, **r}
    return {"model": "mu2Llama-3.2-1B + SegVol", "layers": {
        "vit": cfg.vision.num_layers, "decoder": cfg.llm.num_layers,
        "seg_encoder": cfg.seg.encoder_layers}, "seg_token": seg_id,
        **sound, "tol": LOGIT_TOL, "tokens_cpu": tokens,
        "tokens_gpu": gpu_run[0][0].tolist(), "near_tie": tie,
        "planted_faults": faults, "check_s": time.perf_counter() - t0}


def seg_batch(torch, cfg, seq: int, valid: int, prompt: int, seed: int):
    """``training_batch`` (B=1) with a '[SEG]' token 4 rows before the end
    of the valid span, its labels, a seeded volume for the head and a ball
    for its target."""
    from u2tokenizer_torch.train.sft import seg_positions_from_ids

    batch = training_batch(torch, cfg, seq, [valid], prompt, seed)
    seg_id = cfg.llm.vocab_size - 1
    batch["input_ids"][0, valid - 4] = seg_id
    batch["labels"][0, valid - 4] = seg_id
    pos, has = seg_positions_from_ids(batch["input_ids"].numpy(), seg_id)
    g = torch.Generator().manual_seed(seed + 1)
    batch.update({
        "seg_image": torch.randn(1, 1, *cfg.seg.image_size, generator=g),
        "seg": sphere(torch, cfg.seg.image_size, (0.1, -0.2, 0.2), 0.5,
                      device="cpu")[None, None],
        "seg_positions": torch.from_numpy(pos),
        "has_seg": torch.from_numpy(has)})
    return batch


def seg_left_out(name: str):
    """``ablation_left_out``, and "seg_key_bias" for the SegVol
    attentions' key biases, whose gradient is zero in exact arithmetic for
    the reason ``left_out`` gives for the μ²tokenizer's."""
    if name.startswith("seg_module.") and name.endswith("k_proj.bias"):
        return "seg_key_bias"
    return ablation_left_out(name)


def seg_judged(name: str) -> bool:
    return seg_left_out(name) is None


SEG_LEFT_OUT = ABLATION_LEFT_OUT + ("seg_key_bias",)
SEG_TRAIN_COS_MIN, SEG_TRAIN_NORM_TOL = 0.99, 8e-2


def seg_misfits(readings):
    """The judged parameters (``seg_judged``) whose gradient the joint
    step's limits reject."""
    return {name: r for name, r in readings.items()
            if seg_judged(name)
            and not (r["cos"] >= SEG_TRAIN_COS_MIN
                     and abs(r["norm_ratio"] - 1) <= SEG_TRAIN_NORM_TOL)}


def seg_train_reference(torch, fa, cpu) -> dict:
    """One joint step (``make_seg_train_step``) of ``seg_reduced_config``
    on the CPU model ``cpu`` (fp32, plain versions) and on the card (bf16
    compute; the kernels, then the plain attention) from the same weights,
    B=1, 384 tokens valid for 300, the '[SEG]' row gated in: the loss and
    its two parts within TRAIN_LOSS_TOL, and every parameter's gradient
    held to SEG_TRAIN_COS_MIN and SEG_TRAIN_NORM_TOL but SEG_LEFT_OUT's
    (named, their medians reported); the same limits must reject each of
    ``planted_faults``."""
    from u2tokenizer_torch.config import TrainConfig
    from u2tokenizer_torch.models.u2_model import U2CausalLM
    from u2tokenizer_torch.train import sft

    t0 = time.perf_counter()
    cfg = cpu.cfg
    batch = seg_batch(torch, cfg, 384, 300, 280, seed=5)
    gpu = U2CausalLM(cfg, dtype=torch.bfloat16, device="cuda", seed=2)
    gpu.load_state_dict(cpu.state_dict())
    weights = {k: v.clone() for k, v in gpu.state_dict().items()}

    def step(model, device_batch):
        state, _ = sft.make_trainer(model, TrainConfig(), 1)
        _, metrics = sft.make_seg_train_step(model)(state, device_batch)
        return ({k: float(metrics[k]) for k in ("loss", "lm_loss",
                                                "seg_loss")},
                model_grads(model))

    loss_cpu, grads = step(cpu, batch)
    ref = card_reference(grads)
    del grads
    card_batch = {k: v.to("cuda") for k, v in batch.items()}

    def card_step(replacements):
        gpu.load_state_dict(weights)
        with planted(fa, replacements):
            loss, grads = step(gpu, card_batch)
        return loss, gradient_readings(torch, grads, ref)

    loss_gpu, sound = card_step({})
    plain = card_step(plain_attention(fa))[1]
    caught = {}
    for label, rep in planted_faults(torch, fa).items():
        readings = card_step(rep)[1]
        caught[label] = {**worst_leaves(readings, seg_judged),
                         "leaves_rejected": len(seg_misfits(readings))}
    rel = {k: abs(loss_gpu[k] - loss_cpu[k]) / abs(loss_cpu[k])
           for k in loss_cpu}
    seg_leaves = [n for n in sound if n.startswith("seg_")]
    line = {"model": "mu2Llama-3.2-1B + SegVol, joint seg step",
            "loss_cpu": loss_cpu, "loss_gpu": loss_gpu, "loss_rel_err": rel,
            "loss_tol": TRAIN_LOSS_TOL, "grad_cos_min": SEG_TRAIN_COS_MIN,
            "grad_norm_tol": SEG_TRAIN_NORM_TOL,
            "leaves_held": sum(map(seg_judged, sound)), "leaves": len(sound),
            "seg_leaves_held": sum(map(seg_judged, seg_leaves)),
            "seg_leaves": len(seg_leaves),
            "held": worst_leaves(sound, seg_judged),
            "held_seg": worst_leaves({n: sound[n] for n in seg_leaves},
                                     seg_judged),
            "left_out": left_out_medians(sound, seg_left_out, SEG_LEFT_OUT),
            "plain_attention": worst_leaves(plain, seg_judged),
            "plain_attention_rejected": len(seg_misfits(plain)),
            "planted_faults": caught, "check_s": time.perf_counter() - t0}
    bad = seg_misfits(sound)
    missed = [f for f, r in caught.items() if not r["leaves_rejected"]]
    if not max(rel.values()) <= TRAIN_LOSS_TOL or bad or missed:
        raise AssertionError(f"reduced joint seg step: loss or gradients "
                             f"off the CPU's ({bad}), or planted faults not "
                             f"rejected ({missed}): {line}")
    return line


def m3d_train_leg(torch, fa, da) -> tuple:
    """M3D_TRAIN_STEPS joint steps of full-width μ²Llama-3.2-1B with the
    SegVol head (fp32 parameters, bf16 compute, AdamW through
    ``sft.make_trainer``'s optimizer, no remat), B=1, one row of
    M3D_TRAIN_SEQ tokens with a '[SEG]' and a ball target, timed by
    ``step_probe``. Returns (the line, the launches)."""
    from u2tokenizer_torch.config import TrainConfig
    from u2tokenizer_torch.models.u2_model import U2CausalLM
    from u2tokenizer_torch.train import sft

    cfg = m3d_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = U2CausalLM(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batch = {k: v.to("cuda") for k, v in seg_batch(
        torch, cfg, M3D_TRAIN_SEQ, M3D_TRAIN_VALID, M3D_TRAIN_PROMPT,
        seed=4).items()}
    state, _ = sft.make_trainer(model, TrainConfig(), M3D_TRAIN_STEPS)
    reset_launches(fa, da)
    with step_probe(torch, fa, da, sft, "make_seg_train_step") as recs:
        step = sft.make_seg_train_step(model)
        for _ in range(M3D_TRAIN_STEPS):
            state, _ = step(state, batch)
    launches = read_launches(fa, da)
    expect_launches("joint seg step", recs, M3D_TRAIN_LAUNCHES)
    readings = step_readings(recs)
    params = sum(p.numel() for p in model.parameters())
    seg = sum(p.numel() for n, p in model.named_parameters()
              if n.startswith("seg_"))
    line = {"steps": M3D_TRAIN_STEPS, "batch": 1, "seq": M3D_TRAIN_SEQ,
            "valid": M3D_TRAIN_VALID, "build_s": build_s,
            "params": params, "seg_params": seg, **readings,
            "lm_loss": [r["metrics"]["lm_loss"] for r in recs],
            "seg_loss": [r["metrics"]["seg_loss"] for r in recs],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if not all(math.isfinite(x) for x in line["loss"] + line["grad_norm"]):
        raise AssertionError(f"joint seg steps not finite: {line}")
    del model, state, step, batch
    return line, launches


# The tiny configs' forms (``U2ModelConfig.tiny()``, the path of ``cli
# selftest``, ``drive_dataprep``): K1 at the tiny ViT's call (2 volumes x
# 2 chunks of 64 patches and the cls token, 4 heads of 16, q/k/v views of
# the fused qkv) and K2 at the tiny decoder's training call (2 rows of 64
# tokens, 4 q / 2 kv heads of 32, 23 valid), K4a-c at both, timed; the
# ViT's last row 18 keys short, so that the lens mutants move its mask.
# Untimed: K1/K2 and K4a-c at both dims on the tile-edge shapes (193
# tokens; group 1 with fused q/k/v and group 2), causal and not, so that
# no tiny form goes unchecked.
TINY_VIT_CALL = dict(causal=False, b=4, s=65, h=4, hkv=4, d=16,
                     lens=[65, 65, 65, 47], fused=True)
TINY_DECODER_CALL = dict(causal=True, b=2, s=64, h=4, hkv=2, d=32,
                         lens=[23, 23], fused=False)
TINY_EDGE_CALLS = [dict(call, causal=causal, d=d) for d in (16, 32)
                   for call in EDGE_CALLS for causal in (False, True)]


# K3 at D=32: the tiny decoder's decode call over a quantized cache (B=2,
# 4/2 heads of 32, prompts of TINY_DECODE_SLOTS rows with 23 valid, step 3
# of TINY_QUANT_NEW), timed, whose (row, kv head)s are each one block's
# (fewer visible rows than EXACT_ROWS); untimed, a 3-token prompt, and at
# TINY_SPLIT_SLOTS + MAX_NEW slots (steps 0 and the last) one row on each
# path, the last split over just past EXACT_ROWS visible rows: over 1024 +
# 900 rows, 4 heads of 32 moved by less than the limits when one key was
# added or dropped (0.0015 on the H100), and the one-key mutants must be
# told apart.
TINY_DECODE_HEADS = (4, 2, 32)
TINY_SPLIT_SLOTS, TINY_SPLIT_PROMPT = 512, [400, 512]
TINY_DECODE_SLOTS = TINY_DECODER_CALL["s"]
TINY_QUANT_NEW = 8
TINY_PROMPT = TINY_DECODER_CALL["lens"]


def tiny_kernel_checks(torch, F, fa, da, attn) -> tuple:
    """The tiny forms: K1 at D=16 and K2 at D=32 at the selftest's calls,
    K4a-c at both, K3-int8 and K3-int4 at D=32 at the tiny decoder's
    decode call, timed; every flash form at both dims on the tile edges and
    K3 at D=32 on its split path, untimed. Returns (the timed entries,
    named by form, each with the largest error of its form's checks; every
    check)."""
    timed = {"flash_fwd_noncausal_d16": check_flash(torch, F, fa,
                                                    TINY_VIT_CALL, 90),
             "flash_fwd_causal_d32": check_flash(torch, F, fa,
                                                 TINY_DECODER_CALL, 91)}
    for d, call, seed in ((16, TINY_VIT_CALL, 92), (32, TINY_DECODER_CALL,
                                                     93)):
        for entry in check_flash_bwd(torch, F, fa, call, seed):
            timed[f"{entry['name']}_d{d}"] = entry
    # K1 at D=32 and K2 at D=16, which no path launches, timed at the tiny
    # calls with the other head dim
    checks = [check_flash(torch, F, fa, dict(TINY_VIT_CALL, d=32), 130),
              check_flash(torch, F, fa, dict(TINY_DECODER_CALL, d=16), 131)]
    for bits in (8, 4):
        timed[f"{da.KERNELS[bits]}_d32"] = check_decode(
            torch, da, attn, bits, 2, (TINY_QUANT_NEW - 1) // 2, TINY_PROMPT,
            heads=TINY_DECODE_HEADS, new=TINY_QUANT_NEW,
            slots=TINY_DECODE_SLOTS)
        checks += [check_decode(torch, da, attn, bits, 2, step,
                                TINY_SPLIT_PROMPT, timed=False,
                                heads=TINY_DECODE_HEADS,
                                slots=TINY_SPLIT_SLOTS)
                   for step in (0, MAX_NEW - 1)]
        checks.append(check_decode(torch, da, attn, bits, 2, 0, [3, 23],
                                   timed=False, heads=TINY_DECODE_HEADS,
                                   new=TINY_QUANT_NEW,
                                   slots=TINY_DECODE_SLOTS))
    for i, call in enumerate(TINY_EDGE_CALLS):
        checks.append(check_flash(torch, F, fa, call, 94 + i, timed=False))
        checks += check_flash_bwd(torch, F, fa, call, 110 + i, timed=False)
    for form, entry in timed.items():
        entry["head_dim"], entry["tiny"] = int(form[-2:]), True
        entry["kernel"], entry["name"] = entry["name"], form
        entry["max_abs_err"] = max(
            [entry["max_abs_err"]] + [c["max_abs_err"] for c in checks
                                      if c["name"] == entry["kernel"]
                                      and c["shape"]["q"][-1]
                                      == entry["head_dim"]])
    return timed, checks


def drive_m3d(torch, F, fa, da, tmp: str, card: str) -> tuple:
    """The M3D phase: a synthetic M3D root (``write_m3d_data``), ``cli
    eval-m3d`` for each task of M3D_TASK_CASES at ``m3d_config`` (seeded
    weights, no checkpoint), the reduced '[SEG]' generate check, the joint
    seg steps and their reduced check, and K2 and K4a-c at this phase's
    512-row calls (untimed). One printed line each; returns (the launches
    by path, the kernel checks, the phase's seconds by leg)."""
    from u2tokenizer_torch.models.u2_model import U2CausalLM

    root = os.path.join(tmp, "m3d")
    legs, counts, line = {}, {}, {}
    t0 = time.perf_counter()
    write_m3d_data(torch, root)
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as f:
        f.write(m3d_config().to_json())
    legs["write_data"] = time.perf_counter() - t0
    for task in M3D_TASK_CASES:
        t0 = time.perf_counter()
        line[task], counts[f"m3d_{task}"] = m3d_task(torch, fa, da, root,
                                                     cfg_path, task)
        legs[task] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # the reduced checks' fp32 model, drawn on the card and moved: the
    # CPU's generator draws several times slower
    cpu = U2CausalLM(seg_reduced_config(), dtype=torch.float32,
                     device="cuda", seed=1).to("cpu")
    line["seg_generate_check"] = seg_generate_check(torch, cpu)
    legs["seg_generate_check"] = time.perf_counter() - t0
    line["note"] = ("seeded weights, synthetic volumes: Dice, IoU and "
                    "recall show only that the machinery runs")
    line["card"] = card
    print(json.dumps({"m3d": line}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train, counts["m3d_seg_train"] = m3d_train_leg(torch, fa, da)
    legs["seg_train"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train["reference_check"] = seg_train_reference(torch, fa, cpu)
    del cpu
    legs["seg_train_reference"] = time.perf_counter() - t0
    train["card"] = card
    print(json.dumps({"m3d_seg_train": train}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    plens = line["seg"]["prompt_lens"]
    checks = [check_flash(torch, F, fa, dict(LLAMA_PREFILL_CALL, s=512,
                                             lens=plens[:1]),
                          40, timed=False),
              *check_flash_bwd(torch, F, fa, dict(
                  LLAMA_PREFILL_CALL, s=M3D_TRAIN_SEQ,
                  lens=[M3D_TRAIN_VALID]), 41, timed=False)]
    for k in checks:
        print(json.dumps({"kernel_check": k}), flush=True)
    return counts, checks, legs


# The data-preparation and operator phase (``drive_dataprep``): ``cli
# preprocess`` over the report phase's CT (``tmp/ct.nii``) copied into two
# directories under one name, with a corrupt file beside; the converters
# over synthetic AMOS-MM, CT-RATE and AbdomenAtlas trees; one
# ``AMOSMRGDataset`` item of that CT at full size (training, scripted
# draws) against the same item on the CPU within INGEST_TOL; ``cli
# selftest`` on the card, one of its train steps under
# ``utils.profiling.trace``, with its launches held to SELFTEST_LAUNCHES;
# ``cli serve-llm`` at its default (tiny) preset answering one chat
# request (K2 at D=32 on each of its 2 layers); a failing command's crash
# report. The selftest's launches (derived from the code: the tiny ViT's 2
# layers and the tiny decoder's 2, on 2 train steps of B=2 with the
# decoder under remat, then 2 cases x 2 greedy samples of 8 tokens, each
# sample one vision encode and one prefill):
#     K1 d16   2 x 2 (train) + 2 x 2 x 2 (generate) = 12
#     K2 d32   2 x 2 x 2 (train, with remat)  + 2 x 2 x 2 = 16
#     K4a-c    2 x 2 each at d16 and at d32 (train)
SELFTEST_LAUNCHES = {"flash_fwd_noncausal_d16": 12,
                     "flash_fwd_causal_d32": 16,
                     **{f"{name}_d{d}": 4 for d in (16, 32)
                        for name in ("flash_bwd_lse", "flash_bwd_dq",
                                     "flash_bwd_dkv")}}
# the kernels a traced selftest train step must show by name: the
# ``__global__`` names with their head-dim template argument. The trace of
# the card lost the step's first launches, the ViT's K1 at D=16, with a
# lead-in of 0.5 s as without one (two whole runs on the H100); it kept
# them once the window opened with TRACE_WARMUP small kernels of its own.
SELFTEST_TRACED = tuple(f"{k}<{d}," for k in ("flash_fwd_kernel",
                                              "lse_kernel", "dq_kernel",
                                              "dkv_kernel")
                        for d in (16, 32))
TRACE_WARMUP = 64
TINY_CHAT = "Rewrite the report : the lungs are clear ."


def nonzero(counts: dict) -> dict:
    return {k: n for k, n in counts.items() if n}


def preprocess_leg(torch, tmp: str) -> dict:
    """``cli preprocess`` over two directories holding the CT under one
    name and a corrupt volume: exit 1 with one FAILED line, JAX's
    collision names, each array ``U2VolumeTransform()`` of its file on the
    card bit for bit."""
    import numpy as np

    from u2tokenizer_torch import cli
    from u2tokenizer_torch.data.transforms import U2VolumeTransform

    src = os.path.join(tmp, "preprocess_in")
    out = os.path.join(tmp, "preprocess_out")
    paths = []
    for sub in ("a", "b"):
        os.makedirs(os.path.join(src, sub))
        paths.append(os.path.join(src, sub, "ct.nii"))
        shutil.copyfile(os.path.join(tmp, "ct.nii"), paths[-1])
    with open(os.path.join(src, "b", "corrupt.nii.gz"), "wb") as f:
        f.write(b"\x1f\x8b\x08 truncated")
    printed = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        try:
            cli.main(["preprocess", os.path.join(src, "a"),
                      os.path.join(src, "b"), "--out-dir", out,
                      "--workers", "4"])
            code = 0
        except SystemExit as e:
            code = e.code
    seconds = time.perf_counter() - t0
    lines = printed.getvalue().splitlines()
    if code != 1 or lines[0] != f"preprocess: 2/3 volumes -> {out}" or \
            len(lines) != 2 or not lines[1].startswith(
                f"  FAILED {os.path.join(src, 'b', 'corrupt.nii.gz')}: "):
        raise AssertionError(f"cli preprocess: exit {code}, {lines}")
    names = sorted(os.listdir(out))
    if names != ["a__ct.npy", "b__ct.npy"]:
        raise AssertionError(f"cli preprocess wrote {names}")
    transform = U2VolumeTransform()
    for path, name in zip(paths, names):
        got = torch.from_numpy(np.load(os.path.join(out, name)))
        if not torch.equal(got, transform(path).cpu()):
            raise AssertionError(f"cli preprocess: {name} is not "
                                 "U2VolumeTransform()'s output bit for bit")
    shutil.rmtree(src)
    shutil.rmtree(out)
    return {"volumes": 3, "written": names, "exit": code,
            "failed_line": lines[1][:120], "s": seconds,
            "bit_for_bit": True}


def converters_leg(tmp: str) -> dict:
    """The converters over synthetic trees in the datasets' layouts:
    AMOS-MM's dataset.json, CT-RATE's report csv, AbdomenAtlas's
    <case>/report.txt; rows counted against the trees."""
    import csv

    from u2tokenizer_torch.data import converters as conv

    root = os.path.join(tmp, "convert")
    os.makedirs(os.path.join(root, "atlas"))
    amos = {"training": [], "validation": []}
    for split, n in (("training", 4), ("validation", 2)):
        for i in range(n):
            amos[split].append({
                "image": f"./imagesTr/amos_{i:04d}.nii.gz",
                "labels": {"report": {"findings": {
                    "chest": f"clear lungs {i}", "abdomen": "normal liver",
                    "pelvis": "" if i % 2 else "normal bladder"}},
                    "qa": [{"question": f"Which organ {i}?",
                            "options": dict(zip("ABCD", ("liver", "spleen",
                                                         "kidney", "lung"))),
                            "answer": "A"}]}})
    with open(os.path.join(root, "dataset.json"), "w") as f:
        json.dump(amos, f)
    with open(os.path.join(root, "reports.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, ["VolumeName", "Findings_EN"])
        w.writeheader()
        for i in range(5):
            w.writerow({"VolumeName": f"train_{i}_a_1.nii.gz",
                        "Findings_EN": f"nodule {i} mm" if i else ""})
    for i in range(3):
        os.makedirs(os.path.join(root, "atlas", f"BDMAP_{i:08d}"))
        with open(os.path.join(root, "atlas", f"BDMAP_{i:08d}",
                               "report.txt"), "w") as f:
            f.write(f"liver lesion {i}")
    out = lambda name: os.path.join(root, "out", name + ".jsonl")
    rows = {
        "amos_mm_extract_qa": conv.amos_mm_extract_qa(
            os.path.join(root, "dataset.json"), out("qa")),
        "amos_mm_reports": conv.amos_mm_reports(
            os.path.join(root, "dataset.json"), out("reports")),
        "amos_mm_report_choice_questions":
            conv.amos_mm_report_choice_questions(
                os.path.join(root, "dataset.json"), out("choices")),
        "ct_rate_reports": conv.ct_rate_reports(
            os.path.join(root, "reports.csv"), out("ct_rate")),
        "abdomen_atlas_reports": conv.abdomen_atlas_reports(
            os.path.join(root, "atlas"), out("atlas"))}
    want = {"amos_mm_extract_qa": 2, "amos_mm_reports": 10,
            "amos_mm_report_choice_questions": 10, "ct_rate_reports": 4,
            "abdomen_atlas_reports": 3}
    if rows != want:
        raise AssertionError(f"converters: rows {rows} != {want}")
    return rows


def amos_item_leg(torch, tmp: str) -> dict:
    """An ``AMOSMRGDataset`` training item of the 512x512x300 CT on the
    card and on the CPU, each with draws from numpy's generator of one
    seed: tokens equal, images within INGEST_TOL."""
    import numpy as np

    from u2tokenizer_torch.data.amos_ct_datasets import AMOSMRGDataset
    from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer

    root = os.path.join(tmp, "amos")
    os.makedirs(os.path.join(root, "imagesTr"))
    os.symlink(os.path.join(tmp, "ct.nii"),
               os.path.join(root, "imagesTr", "amos_0001.nii"))
    with open(os.path.join(root, "dataset.json"), "w") as f:
        json.dump({"training": [{"image": "imagesTr/amos_0001.nii",
                                 "labels": {"report": {"findings": {
                                     "chest": "clear lungs",
                                     "abdomen": "", "pelvis": ""}}}}]}, f)
    items, seconds = {}, {}
    for dev in ("cuda", "cpu"):
        ds = AMOSMRGDataset(root, os.path.join(root, "dataset.json"),
                            MockTokenizer(), 512, device=dev)
        ds.draws = np.random.default_rng(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        items[dev] = ds[0]
        seconds[dev] = time.perf_counter() - t0
    card, cpu = items["cuda"], items["cpu"]
    for key in ("input_id", "label", "attention_mask", "question_ids"):
        if not torch.equal(card[key], cpu[key]):
            raise AssertionError(f"AMOS item: {key} differs card vs CPU")
    img = card["image"]
    if tuple(img.shape) != (1, 32, 256, 256) or not torch.isfinite(img).all():
        raise AssertionError(f"AMOS item: image {tuple(img.shape)}")
    err = (img - cpu["image"]).abs().max().item()
    if not err <= INGEST_TOL:
        raise AssertionError(f"AMOS item: card vs CPU {err:.3g} over "
                             f"{INGEST_TOL}")
    return {"shape": list(img.shape), "max_abs_err_vs_cpu": err,
            "tol": INGEST_TOL, "card_s": seconds["cuda"],
            "cpu_s": seconds["cpu"],
            "labels": int((card["label"] != -100).sum())}


def selftest_leg(torch, fa, da, tmp: str) -> tuple:
    """``cli selftest`` on the card: its launches by head dim, its second
    train step traced by ``utils.profiling.trace`` (the trace must name
    every tiny kernel), SELFTEST OK and the artifacts' rows."""
    from u2tokenizer_torch import cli
    from u2tokenizer_torch.train import sft
    from u2tokenizer_torch.utils import profiling

    trace_dir = os.path.join(tmp, "selftest_trace")
    make = sft.make_trainer
    steps = []

    def traced_trainer(*a, **kw):
        state, step = make(*a, **kw)

        def run(*args):
            steps.append(1)
            if len(steps) != 2:
                return step(*args)
            with profiling.trace(trace_dir):
                x = torch.zeros(1, device="cuda")
                for _ in range(TRACE_WARMUP):
                    x.add_(1)
                torch.cuda.synchronize()
                out = step(*args)
                torch.cuda.synchronize()
            return out

        return state, run

    printed = io.StringIO()
    old_tmp = tempfile.tempdir
    tempfile.tempdir = tmp
    sft.make_trainer = traced_trainer
    reset_launches(fa, da)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            work = cli.main(["selftest"])
        torch.cuda.synchronize()
    finally:
        sft.make_trainer = make
        tempfile.tempdir = old_tmp
    seconds = time.perf_counter() - t0
    launches = nonzero(read_launches(fa, da, by_dim=True))
    if launches != SELFTEST_LAUNCHES:
        raise AssertionError(f"selftest launches {launches} != "
                             f"{SELFTEST_LAUNCHES}")
    if printed.getvalue().splitlines()[-1] != "SELFTEST OK":
        raise AssertionError(f"selftest: {printed.getvalue()[-300:]!r}")
    rows = {}
    for name in ("preds", "greened", "dpo"):
        with open(os.path.join(work, name + ".jsonl")) as f:
            rows[name] = [json.loads(line) for line in f]
    if [len(r["predictions"]) for r in rows["preds"]] != [2, 2] or \
            len(rows["dpo"]) != 2:
        raise AssertionError(f"selftest rows: {rows}")
    with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    forms = {k: sum(k in n for n in names) for k in SELFTEST_TRACED}
    missing = [k for k, n in forms.items() if not n]
    if missing:
        raise AssertionError(f"selftest trace names no {missing}")
    return {"s": seconds, "launches": launches, "steps": len(steps),
            "traced_kernels": len(names), "traced_forms": forms,
            "predictions": [r["predictions"][0] for r in rows["preds"]],
            "dpo_pairs": len(rows["dpo"]),
            "chosen_equals_rejected": [p["chosen"] == p["rejected"]
                                       for p in rows["dpo"]]}, work


def serve_llm_tiny_leg(torch, fa, da) -> tuple:
    """``cli serve-llm`` with no preset flag (``tiny``) on the card, one
    chat request over HTTP: a reply, and K2 at D=32 once a layer (the
    prompt's prefill; speculative verify blocks attend in plain PyTorch)."""
    from u2tokenizer_torch import cli
    from u2tokenizer_torch.serve import serve_background
    from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer

    args = cli.build_parser().parse_args(
        ["serve-llm", "--host", "127.0.0.1", "--port", "0"])
    lm = cli.build_llm_server(args, tokenizer=MockTokenizer())
    server = serve_background(lm, port=0, transform=False)
    reset_launches(fa, da)
    t0 = time.perf_counter()
    try:
        out = http_ok(f"http://127.0.0.1:{server.server_address[1]}"
                      "/v1/chat/completions",
                      {"messages": [{"role": "user", "content": TINY_CHAT}]})
    finally:
        server.shutdown()
    seconds = time.perf_counter() - t0
    launches = nonzero(read_launches(fa, da, by_dim=True))
    want = {"flash_fwd_causal_d32": lm.model.cfg.num_layers}
    if launches != want:
        raise AssertionError(f"serve-llm tiny launches {launches} != {want}")
    text = out["choices"][0]["message"]["content"]
    if not isinstance(text, str):
        raise AssertionError(f"serve-llm tiny: {out}")
    return {"preset": args.preset, "s": seconds, "reply_chars": len(text),
            "launches": launches}, launches


def tiny_quantized_decode_leg(torch, fa, da) -> tuple:
    """``U2ModelConfig.tiny()`` on the card in bf16: TINY_QUANT_NEW greedy
    tokens of B=2 prompts of TINY_DECODE_SLOTS rows (TINY_PROMPT valid)
    through ``make_multimodal_generate_fn`` over an int8 and over an int4
    cache, K3 at D=32 once a layer a decode step; beside each, the tokens
    of the same run with K3's plain version in the decoder's place (a
    seeded tiny model's near-ties may part them, so they are read, not
    held). Returns (the line, the launches by form and head dim)."""
    from u2tokenizer_torch.config import GenerationConfig, U2ModelConfig
    from u2tokenizer_torch.models.generate import make_multimodal_generate_fn
    from u2tokenizer_torch.models.llm import decoder
    from u2tokenizer_torch.models.quantize import cast_for_inference
    from u2tokenizer_torch.models.u2_model import U2CausalLM

    cfg = U2ModelConfig.tiny()
    model = cast_for_inference(U2CausalLM(cfg, dtype=torch.bfloat16,
                                          device="cuda", seed=0))
    g = torch.Generator(device="cuda").manual_seed(5)
    b, s = 2, TINY_DECODE_SLOTS
    ids = torch.randint(3, cfg.llm.vocab_size, (b, s), generator=g,
                        device="cuda")
    images = torch.randn(b, cfg.num_chunks, *cfg.vision.input_spatial,
                         generator=g, device="cuda")
    qids = torch.randint(3, cfg.llm.vocab_size, (b, 6), generator=g,
                         device="cuda")
    plen = torch.tensor(TINY_PROMPT, dtype=torch.int32, device="cuda")
    gen = GenerationConfig(max_new_tokens=TINY_QUANT_NEW, eos_token_id=-2)
    line, counts = {}, {}
    for cache in ("int8", "int4"):
        name = da.KERNELS[int(cache[3:])]
        fn = make_multimodal_generate_fn(model, gen, cache_dtype=cache)
        reset_launches(fa, da)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            tokens = fn(ids, images, qids, plen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = nonzero(read_launches(fa, da, by_dim=True))
        want = (TINY_QUANT_NEW - 1) * cfg.llm.num_layers
        if launches.get(name) != want:
            raise AssertionError(f"tiny {cache} cache: launches {launches}, "
                                 f"{name} should be {want}")
        if tokens.shape != (b, TINY_QUANT_NEW) or not bool(
                ((tokens >= 0) & (tokens < cfg.llm.vocab_size)).all()):
            raise AssertionError(f"tiny {cache} cache tokens {tokens}")
        kernel = decoder.decode_attention_quantized
        decoder.decode_attention_quantized = da.decode_attention_reference
        try:
            with torch.no_grad():
                plain = fn(ids, images, qids, plen)
        finally:
            decoder.decode_attention_quantized = kernel
        line[cache] = {"s": seconds, "launches": launches,
                       "tokens_equal_plain": bool(torch.equal(tokens, plain)),
                       "tokens_agree_plain": float(
                           (tokens == plain).float().mean())}
        counts[f"tiny_{cache}_cache"] = {f"{name}_d32": launches[name]}
    return line, counts


def crash_report_leg(torch, tmp: str, work: str) -> dict:
    """A command that fails after building its model on the card
    (``generate`` into a directory that does not exist), run through
    ``cli.main`` from ``tmp``: the report in ``tmp/error_reports`` names
    the card and its bytes."""
    from u2tokenizer_torch import cli

    here = os.getcwd()
    os.chdir(tmp)
    try:
        cli.main(["generate", "--tiny", "--base-path", work, "--jsonl-path",
                  "train.jsonl", "--max-length", "64", "--max-new-tokens",
                  "4", "--output", os.path.join(tmp, "absent", "p.jsonl")])
        raise AssertionError("generate into a missing directory did not "
                             "fail")
    except FileNotFoundError:
        pass
    finally:
        os.chdir(here)
    (name,) = os.listdir(os.path.join(tmp, "error_reports"))
    with open(os.path.join(tmp, "error_reports", name)) as f:
        report = json.load(f)
    want = torch.cuda.get_device_name(0)
    if (report.get("device_name"), report.get("backend"),
            report.get("exception_type")) != (want, "cuda",
                                              "FileNotFoundError") or \
            not report.get("memory_allocated"):
        raise AssertionError(f"crash report: {report}")
    return {k: report[k] for k in ("exception_type", "backend",
                                   "device_name", "memory_allocated",
                                   "max_memory_allocated", "process_index",
                                   "process_count")}


def drive_dataprep(torch, fa, da, tmp: str, card: str) -> tuple:
    """The data-preparation and operator phase (after the M3D phase; needs
    the report phase's ``tmp/ct.nii``). One printed line; returns the
    launches of its paths by head dim and each leg's seconds."""
    legs, line = {}, {}
    for name, leg in (("preprocess", lambda: preprocess_leg(torch, tmp)),
                      ("converters", lambda: converters_leg(tmp)),
                      ("amos_item", lambda: amos_item_leg(torch, tmp))):
        t0 = time.perf_counter()
        line[name] = leg()
        legs[name] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    counts = {}
    t0 = time.perf_counter()
    line["selftest"], work = selftest_leg(torch, fa, da, tmp)
    counts["selftest"] = line["selftest"]["launches"]
    legs["selftest"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line["serve_llm_tiny"], counts["serve_llm_tiny"] = serve_llm_tiny_leg(
        torch, fa, da)
    legs["serve_llm_tiny"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line["tiny_quantized_decode"], quantized = tiny_quantized_decode_leg(
        torch, fa, da)
    counts.update(quantized)
    legs["tiny_quantized_decode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line["crash_report"] = crash_report_leg(torch, tmp, work)
    legs["crash_report"] = time.perf_counter() - t0
    line["card"] = card
    print(json.dumps({"dataprep": line}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts, legs


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == MESH_RANK_FLAG:
        return mesh_train_rank(sys.argv[2], sys.argv[3:])
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--max-new", type=int, default=B4_MAX_NEW)
    parser.add_argument("--kernels-only", action="store_true",
                        help="build and check the kernels, then stop "
                        "(no result line)")
    parser.add_argument("--qlora-reference-at", type=float, nargs="+",
                        metavar="STD", help="build the kernels, read the "
                        "2-layer QLoRA step against the CPU with lora_b "
                        "drawn at each spread, with the kernels and with "
                        "the plain attention, then stop (no result line)")
    parser.add_argument("--serving-repeats", type=int, metavar="N",
                        help="build the kernels, run the report phase, "
                        "then the serving phase N times, then stop (no "
                        "result line)")
    args = parser.parse_args()
    t_start = time.perf_counter()

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
    for std in args.qlora_reference_at or ():
        print(json.dumps({"qlora_reference_readings": qlora_reference_line(
            torch, fa, std), "card": card}), flush=True)
    if args.qlora_reference_at:
        return 0
    if args.serving_repeats:
        return serving_repeats(torch, fa, da, card, args.serving_repeats)

    # each phase's seconds, printed on the script_s line
    phases_s, t_phase = {}, time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        phases_s[name] = now - t_phase
        t_phase = now

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
    # the stage-2 phase's calls: K2 at the DPO call and the judge's
    green_fwd = {"prefill_dpo": check_flash(torch, F, fa, DPO_CALL, 18),
                 "prefill_judge": check_flash(torch, F, fa, JUDGE_CALL, 19)}
    fwd_calls.update(green_fwd)
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
    dpo_bwd = check_flash_bwd(torch, F, fa, DPO_CALL, 20)
    edge_bwd = [e for i, call in enumerate(EDGE_CALLS + [LLAMA_TRAIN_CALL])
                for e in check_flash_bwd(torch, F, fa, call, 7 + i,
                                         timed=False)]
    for k in [int8, int4, int4_b4] + edge_decode + vit_bwd + dec_bwd \
            + b1_bwd + dpo_bwd + edge_bwd:
        print(json.dumps({"kernel_check": k}), flush=True)
    print(json.dumps({"decode_calls": decode_summary(
        {f"int8_b{BATCH}": int8, f"int4_b{QUANT_BATCH}": int4,
         f"int4_b{BATCH}": int4_b4}), "card": card}), flush=True)
    # printed after the Phi forms, with the QLoRA path's D=96 call
    bwd_calls = flash_bwd_summary(
        {"vit": vit_bwd, "decoder": dec_bwd, "decoder_b1": b1_bwd,
         "decoder_dpo": dpo_bwd})
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
                          "prefill_mu2llama", "prefill_dpo",
                          "prefill_judge")}
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
    for i, (vit, dec, b1, dpo) in enumerate(zip(vit_bwd, dec_bwd, b1_bwd,
                                                dpo_bwd)):
        vit["max_abs_err"] = max(e["max_abs_err"] for e in
                                 (vit, dec, b1, dpo, *edge_bwd[i::3]))
        vit["decoder_call"] = {key: dec[key] for key in beside}
        vit["decoder_call_b1"] = {key: b1[key] for key in beside}
        vit["decoder_call_dpo"] = {key: dpo[key] for key in beside}
        kernels.append(vit)
    del int4_b4, vit_bwd, dec_bwd, b1_bwd, dpo_bwd, edge_bwd, fwd_calls, \
        edge_fwd, edge_decode
    gc.collect()
    torch.cuda.empty_cache()
    # the Phi forms: K2 at D=96 and D=80 and K3 at both, one entry each,
    # its error the largest of its form's checks
    phi_timed, phi_checks = phi_kernel_checks(torch, F, fa, da, attn)
    for k in list(phi_timed.values()) + phi_checks:
        print(json.dumps({"kernel_check": k}), flush=True)
    print(json.dumps({"phi_calls": {
        "flash_fwd": flash_fwd_summary({f: e for f, e in phi_timed.items()
                                        if f.startswith("flash_fwd")}),
        "decode": decode_summary({f: e for f, e in phi_timed.items()
                                  if f.startswith("decode")}),
        "flash_fwd_no_path": flash_fwd_summary(
            {f"flash_fwd_noncausal_d{c['shape']['q'][-1]}": c
             for c in phi_checks if c["name"] == "flash_fwd_noncausal"
             and c["ms"] is not None})},
        "card": card}), flush=True)
    bwd_calls.update(flash_bwd_summary(
        {label: tuple(phi_timed[f"{name}_d{d}"] for name in fa.BWD_KERNELS)
         for label, d in (("qlora_mu2phi3_d96", 96), ("phi2_shaped_d80", 80))}))
    # the μ²Qwen3-8B forms: K2, K3-int4 and K4a-c at D=128, group 4
    q8_timed, q8_checks = qwen8b_kernel_checks(torch, F, fa, da, attn)
    for k in list(q8_timed.values()) + q8_checks:
        print(json.dumps({"kernel_check": k}), flush=True)
    print(json.dumps({"qwen3_8b_calls": {
        "flash_fwd": flash_fwd_summary(
            {"prefill_mu2qwen3_8b": q8_timed["flash_fwd_causal_d128_g4"]}),
        "decode": decode_summary(
            {"decode_mu2qwen3_8b": q8_timed["decode_attention_int4_d128_g4"]}
        )}, "card": card}), flush=True)
    bwd_calls.update(flash_bwd_summary({"qlora_mu2qwen3_8b_d128_g4": tuple(
        q8_timed[f"{name}_d128_g4"] for name in fa.BWD_KERNELS)}))
    # the tiny forms: K1 at D=16, K2 at D=32, K4a-c at both
    tiny_timed, tiny_checks = tiny_kernel_checks(torch, F, fa, da, attn)
    for k in list(tiny_timed.values()) + tiny_checks:
        print(json.dumps({"kernel_check": k}), flush=True)
    print(json.dumps({"tiny_calls": {
        "flash_fwd": flash_fwd_summary({f: e for f, e in tiny_timed.items()
                                        if f.startswith("flash_fwd")}),
        "flash_fwd_no_path": flash_fwd_summary(
            {f"{c['name']}_d{c['shape']['q'][-1]}": c for c in tiny_checks
             if c["name"].startswith("flash_fwd") and c["ms"] is not None}),
        "decode": decode_summary({f: e for f, e in tiny_timed.items()
                                  if f.startswith("decode")})},
        "card": card}), flush=True)
    bwd_calls.update(flash_bwd_summary(
        {label: tuple(tiny_timed[f"{name}_d{d}"] for name in fa.BWD_KERNELS)
         for label, d in (("selftest_vit_d16", 16),
                          ("selftest_decoder_d32", 32))}))
    print(json.dumps({"flash_bwd_calls": bwd_calls, "card": card}),
          flush=True)
    for entry in phi_timed.values():
        entry["max_abs_err"] = max(
            [entry["max_abs_err"]] + [c["max_abs_err"] for c in phi_checks
                                      if c["name"] == entry["kernel"]
                                      and c["shape"]["q"][-1]
                                      == entry["head_dim"]])
    kernels += phi_timed.values()
    kernels += q8_timed.values()
    kernels += tiny_timed.values()
    del phi_checks, q8_checks, tiny_checks
    gc.collect()
    torch.cuda.empty_cache()
    if args.kernels_only:
        return 0
    phase_done("kernel_checks")

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
    phase_done("serve")
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
        phase_done("report")
        counts.update(drive_speculative(torch, fa, da, volume, tmp,
                                        greedy_tokens, quant_run, card))
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("speculative")
        counts.update(drive_serving(torch, fa, da, volume, tmp, card))
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("serving")
        t0 = time.perf_counter()
        green_counts, green_calls, tok = drive_green_dpo(torch, F, fa, da,
                                                         tmp, card)
        green_s = time.perf_counter() - t0
        counts.update(green_counts)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        counts.update(drive_eval(torch, fa, da, tmp, tok, card))
        eval_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phi_counts, qlora_calls, qlora_s = drive_phi(
            torch, F, fa, da, volume, tmp,
            os.path.join(tmp, "green_dpo", "preds.jsonl"), card)
        phi_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        counts.update(drive_ablation(torch, fa, da, volume, tmp, card))
        ablation_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        m3d_counts, m3d_calls, m3d_legs = drive_m3d(torch, F, fa, da, tmp,
                                                    card)
        m3d_s = time.perf_counter() - t0
        counts.update(m3d_counts)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tiny_counts, dataprep_legs = drive_dataprep(torch, fa, da, tmp, card)
        dataprep_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        q8_counts, q8_calls, q8_legs = drive_qwen3_8b(
            torch, F, fa, da, volume, tmp, tok, card)
        q8_s = time.perf_counter() - t0
    del volume
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("stage2_to_8b")
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
    phase_done("reference_checks")

    train = drive_training(torch, fa, da, TRAIN_STEPS)
    counts["train"] = train["launches"]
    # per step: the ViT's 12 layers (not rematerialised) and the decoder's
    # TRAIN_LAYERS, forward again in the backward under remat
    per_step = {name: 0 for name in counts["train"]}
    per_step.update({"flash_fwd_noncausal": 12,
                     "flash_fwd_causal": 2 * TRAIN_LAYERS,
                     **{name: 12 + TRAIN_LAYERS for name in fa.BWD_KERNELS}})
    train["card"] = card
    print(json.dumps({"train_path": train}), flush=True)
    want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    if counts["train"] != want:
        raise AssertionError(f"training launches {counts['train']} != "
                             f"expected {want}")
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("train")
    print(json.dumps({"train_reference_check": check_train_reference(
        torch, fa)}), flush=True)
    phase_done("train_reference")

    # the stage-2 and M3D phases' own calls of K2 and K4a-c, checked untimed
    for new in green_calls + m3d_calls:
        entry = next(k for k in kernels if k["name"] == new["name"])
        entry["max_abs_err"] = max(entry["max_abs_err"], new["max_abs_err"])
    # the QLoRA steps' other valid lengths, checked untimed
    for new, d in [(c, 96) for c in qlora_calls] + [(c, 128)
                                                      for c in q8_calls]:
        entry = next(k for k in kernels if k.get("kernel") == new["name"]
                     and k["head_dim"] == d)
        entry["max_abs_err"] = max(entry["max_abs_err"], new["max_abs_err"])
    # a Phi form's launches are its kernel's on the paths of its head dim,
    # which run each kernel at that dim alone (the ViT's K1 at D=64 counts
    # to the D=64 entry); the QLoRA steps are held to it by head dim
    family = {96: "mu2phi3", 80: "phi2"}
    for k in kernels:
        if k.get("tiny"):  # the selftest's and serve-llm's by head dim
            by_path = {path: n.get(f"{k['kernel']}_d{k['head_dim']}", 0)
                       for path, n in tiny_counts.items()}
        elif k.get("group") == 4:  # the μ²Qwen3-8B forms: its paths' launches
            by_path = {path: n.get(k["kernel"], 0)
                       for path, n in q8_counts.items()}
        elif "head_dim" in k:
            by_path = {path: n.get(k["kernel"], 0)
                       for path, n in phi_counts.items()
                       if family[k["head_dim"]] in path}
        else:
            by_path = {path: n[k["name"]] for path, n in counts.items()}
        if k["name"] == "flash_fwd_noncausal":  # μ²Phi-3's, μ²Qwen3-8B's ViT
            by_path.update({path: n.get(k["name"], 0) for path, n in
                            list(phi_counts.items()) + list(q8_counts.items())})
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        if not k["launches"] and k["name"] not in NO_PATH_FORMS:
            raise AssertionError(f"{k['name']}: no launch on its paths")
        for key in ("shape", "check", "ref_scale", "plain_rows",
                    "device_ms_traced", "tiny"):
            k.pop(key, None)
    print(json.dumps({"script_s": time.perf_counter() - t_start,
                      "green_dpo_phase_s": green_s, "eval_phase_s": eval_s,
                      "phi_phase_s": phi_s,
                      "qlora_phase_s": qlora_s,
                      "ablation_phase_s": ablation_s,
                      "m3d_phase_s": m3d_s, "m3d_legs_s": m3d_legs,
                      "dataprep_phase_s": dataprep_s,
                      "dataprep_legs_s": dataprep_legs,
                      "qwen3_8b_phase_s": q8_s,
                      "qwen3_8b_legs_s": q8_legs,
                      "build_s": build_s, "phases_s": phases_s}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
