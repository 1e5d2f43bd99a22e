"""Quantization-quality report: the validation gate for quantized serving
(counterpart of ``u2tokenizer_tpu/eval/quant_report.py``).

Given a float model (from a checkpoint, or random at a config's geometry),
it produces

  * a per-layer weight round-trip report: SNR (dB) and max scaled error
    of the int8 or int4 quantization of each decoder kernel and of the
    embedding table, one leaf at a time, each named by the JAX package's
    parameter path (``llm/model/layers_0/self_attn/q_proj``), so that the
    two packages' reports compare key for key;
  * a teacher-forced forward comparison: top-1/top-5 agreement, mean KL
    and max scaled logit error between the float model and its quantized
    copy on shared multimodal batches, reduced on the device;
  * an optional greedy-decode agreement: the first step where the two
    stacks' tokens part and the token match fraction over n new tokens;
  * ``decide``: the go/no-go verdict from ``DECISION_THRESHOLDS``.

The JAX package walks a parameter tree; the port walks the built model's
``QDense`` layers and its embedding table, and quantizes each leaf in the
JAX layout (the (in, out) kernel is ``weight.t()``) with
``models.quantize``'s own functions, which give the JAX package's integers
and scales. The quantized model is a copy of the float one quantized in
place by ``quantize_llm_weights``. Exposed as ``cli quant-report``.
"""

from __future__ import annotations

import copy
import os
import sys
from typing import Any, Dict, List

import numpy as np
import torch

from ..config import GenerationConfig
from ..models.generate import make_multimodal_generate_fn
from ..models.llm.decoder import QDense, unpack_int4
from ..models.quantize import (quantize_channels, quantize_kernel_int4,
                               quantize_llm_weights)
from ..weights import flax_path


def trace_rss(tag: str) -> None:
    """Stderr breadcrumb (peak + current host RSS) between report legs,
    enabled by ``U2_QR_TRACE=1``, so that a leg killed for memory names
    itself."""
    if os.environ.get("U2_QR_TRACE") != "1":
        return
    hwm = cur = "?"
    try:
        for line in open("/proc/self/status"):
            if line.startswith("VmHWM"):
                hwm = f"{int(line.split()[1]) / 1e6:.1f}"
            elif line.startswith("VmRSS"):
                cur = f"{int(line.split()[1]) / 1e6:.1f}"
    except OSError:
        pass
    print(f"[quant-report rss] {tag}: rss_gb={cur} peak_gb={hwm}",
          file=sys.stderr, flush=True)


def _kernels(model):
    """(JAX path, leaf name, float (in, out) kernel or (V, E) table) of
    every decoder leaf the quantization touches, in the JAX package's
    order (its tree walked with sorted keys)."""
    lm = model.llm if hasattr(model, "llm") else model
    prefix = "llm." if lm is not model else ""
    modules = dict(model.named_modules())
    leaves = []
    for name, layer in lm.named_modules():
        if isinstance(layer, QDense):
            if layer.mode is not None:
                raise ValueError("layer_quant_report needs float weights")
            path = flax_path(f"{prefix}{name}.weight", modules)
            leaves.append((path, name.rsplit(".", 1)[-1], layer.weight.t()))
    path = flax_path(f"{prefix}model.embed_tokens", modules)
    leaves.append((path, "embed_tokens", lm.model.embed_tokens))
    # "params/llm/.../q_proj/kernel" -> "llm/.../q_proj"; the table keeps
    # its leaf name, as in the JAX report
    leaves = [(p[len("params/"):].removesuffix("/kernel"), key, w)
              for p, key, w in leaves]
    return sorted(leaves, key=lambda leaf: leaf[0].split("/"))


def _roundtrip(key: str, w: torch.Tensor, mode: str) -> torch.Tensor:
    """One leaf quantized as ``quantize_llm_weights`` does it (the untied
    ``lm_head`` int8 in int4 mode, the embedding table int8 per row in
    both) and folded back to fp32."""
    if key == "embed_tokens":
        q, scale = quantize_channels(w, dim=0)
        return q.float() * scale
    if mode == "int4" and key != "lm_head":
        q, scale = quantize_kernel_int4(w)
        k = unpack_int4(q).float() * scale[:, None, :]
        return k.reshape(w.shape)
    q, scale = quantize_channels(w, dim=1)
    return q.float() * scale


@torch.no_grad()
def layer_quant_report(model, mode: str = "int8") -> Dict[str, Any]:
    """Per-layer weight round-trip error of the decoder of ``model`` (a
    ``U2CausalLM`` or a bare ``CausalLM`` with float weights).

    SNR(dB) = 10·log10(Σw² / Σ(w−ŵ)²); ``max_scaled_err`` is the worst
    |w−ŵ| normalized by that leaf's absolute max. The error is taken in
    fp32 and its squares summed in fp64, on the leaf's device, one leaf at
    a time; only scalars reach the host."""
    layers, snrs = {}, []
    for path, key, kernel in _kernels(model):
        w = kernel.float()
        err = (w - _roundtrip(key, w, mode)).ravel()
        wf = w.ravel().double()
        ed = err.double()
        p_sig = float(torch.dot(wf, wf))
        p_err = float(torch.dot(ed, ed))
        del wf, ed
        # numpy's float64 and its rounding, as the JAX report's
        snr = 10.0 * np.log10(p_sig / p_err) if p_err > 0 else float("inf")
        scale = max(float(w.abs().max()), 1e-12)
        max_err = np.float32(float(err.abs().max()))
        layers[path] = {
            "shape": list(kernel.shape),
            "snr_db": round(snr, 2),
            "max_scaled_err": round(float(max_err / scale), 6),
        }
        snrs.append(snr)
        del w, err
    finite = [s for s in snrs if np.isfinite(s)]
    return {
        "mode": mode,
        "num_layers": len(layers),
        "snr_db_min": round(min(finite), 2) if finite else None,
        "snr_db_mean": round(float(np.mean(finite)), 2) if finite else None,
        "layers": layers,
    }


def quantized_copy(model, mode: str):
    """A copy of the float ``model`` with its decoder quantized to ``mode``
    in place (the float model is left as it is)."""
    return quantize_llm_weights(copy.deepcopy(model), mode)


def logit_agreement_metrics(lf: torch.Tensor, lq: torch.Tensor):
    """Device-side reduction of two (B, S, V) logit sets to four scalars:
    top-1 match, float-top-5-contains-quant-top-1, mean fp32
    KL(float‖quant), max |Δlogit| scaled by the float set's absolute max
    (at least 1). Returns them as host floats, read in one transfer."""
    lf, lq = lf.float(), lq.float()
    af, aq = lf.argmax(-1), lq.argmax(-1)
    k = min(5, lf.shape[-1])
    tf5 = lf.topk(k, dim=-1).indices
    pf, pq = lf.log_softmax(-1), lq.log_softmax(-1)
    out = torch.stack([
        (af == aq).float().mean(),
        (tf5 == aq[..., None]).any(-1).float().mean(),
        (pf.exp() * (pf - pq)).sum(-1).mean(),
        (lf - lq).abs().max() / torch.clamp(lf.abs().max(), min=1.0)])
    return dict(zip(("top1", "top5", "kl", "max_err"), out.tolist()))


def _forward_logits(model, batch):
    logits, _, _ = model(batch["input_ids"], batch["images"],
                         batch["question_ids"],
                         attention_mask=batch.get("attention_mask"))
    return logits


def forward_agreement(model, batches: List[Dict[str, Any]],
                      mode: str = "int8", qmodel=None) -> Dict[str, Any]:
    """Teacher-forced logit agreement between the float ``model`` and its
    ``mode``-quantized copy (``qmodel``, made here when not given, so that
    ``greedy_agreement`` can share one) on shared batches (ids, CT volume,
    question ids). Positions are compared over the full sequence; KL takes
    the fp32 softmax of both logit sets."""
    if qmodel is None:
        qmodel = quantized_copy(model, mode)
    top1, top5, kls, max_errs = [], [], [], []
    for i, batch in enumerate(batches):
        with torch.inference_mode():
            m = logit_agreement_metrics(_forward_logits(model, batch),
                                        _forward_logits(qmodel, batch))
        trace_rss(f"forward[{mode}] batch {i}")
        top1.append(m["top1"])
        top5.append(m["top5"])
        kls.append(m["kl"])
        max_errs.append(m["max_err"])
    return {
        "mode": mode,
        "num_batches": len(batches),
        "top1_match": round(float(np.mean(top1)), 4),
        "float_top5_contains_q_top1": round(float(np.mean(top5)), 4),
        "mean_kl": round(float(np.mean(kls)), 6),
        "max_scaled_logit_err": round(float(np.max(max_errs)), 6),
    }


def greedy_agreement(model, batch: Dict[str, Any], mode: str = "int8",
                     max_new_tokens: int = 32, qmodel=None) -> Dict[str, Any]:
    """Greedy-decode both stacks from the batch's first row (bf16 cache);
    report the first step where the tokens part and the match fraction.
    Each stack feeds its own argmax back (serving behavior, not teacher
    forced), so one early flip can cascade: first_divergence is the
    honest number, match_fraction the color."""
    if qmodel is None:
        qmodel = quantized_copy(model, mode)
    gen = GenerationConfig(max_new_tokens=max_new_tokens, do_sample=False,
                           eos_token_id=-2, pad_token_id=0)
    ids = batch["input_ids"][:1]
    mask = batch.get("attention_mask")
    plen = (mask.sum(-1)[:1] if mask is not None
            else torch.tensor([ids.shape[1]], device=ids.device))
    args = (ids, batch["images"][:1], batch["question_ids"][:1],
            plen.to(torch.int32))
    tf = make_multimodal_generate_fn(model, gen)(*args).cpu().numpy()
    tq = make_multimodal_generate_fn(qmodel, gen)(*args).cpu().numpy()
    n = min(tf.shape[-1], tq.shape[-1])
    same = tf[0, :n] == tq[0, :n]
    div = int(np.argmin(same)) if not same.all() else -1
    return {
        "mode": mode,
        "new_tokens": int(n),
        "first_divergence": div,
        "match_fraction": round(float(same.mean()), 4),
    }


def synthetic_batches(cfg, num_batches: int = 2, batch: int = 1,
                      seq_extra: int = 16, seed: int = 0, device="cpu"):
    """Deterministic multimodal probe batches at the config's geometry,
    the JAX package's numpy draws (int32 ids and mask, fp32 volumes), on
    ``device`` (used when no dataset is mounted; real batches give the
    meaningful verdict)."""
    rng = np.random.default_rng(seed)
    d, h, w = cfg.vision.input_spatial
    s = cfg.proj_out_num + seq_extra
    to = lambda a, dtype: torch.from_numpy(a.astype(dtype)).to(device)
    out = []
    for _ in range(num_batches):
        out.append({
            "input_ids": to(rng.integers(0, cfg.llm.vocab_size, (batch, s)),
                            np.int32),
            "images": to(rng.normal(size=(batch, cfg.num_chunks, d, h, w))
                         * 0.5, np.float32),
            "question_ids": to(rng.integers(0, cfg.llm.vocab_size,
                                            (batch, 8)), np.int32),
            "attention_mask": to(np.ones((batch, s)), np.int32),
        })
    return out


# ---------------------------------------------------------------------------
# go/no-go decision
# ---------------------------------------------------------------------------

# Numeric thresholds for the serving-precision decision, the JAX package's.
# int8 is the sanity gate: per-channel symmetric int8 should be essentially
# transparent on a healthy conversion, so a failure means investigate the
# conversion, not the quantizer. int4 (group-128) is the flip-to-default
# gate. SNR floors reflect the round-trip envelope on gaussian-ish kernels
# (int8 per-channel ~35-48 dB, int4 group-128 ~20-26 dB).
DECISION_THRESHOLDS: Dict[str, Dict[str, float]] = {
    "int8": {"snr_db_min": 30.0, "top1_match_min": 0.99,
             "mean_kl_max": 1e-3, "greedy_match_min": 0.99},
    "int4": {"snr_db_min": 18.0, "top1_match_min": 0.97,
             "mean_kl_max": 1e-2, "greedy_match_min": 0.95},
}


def decide(entry: Dict[str, Any], mode: str,
           decision_grade: bool = True) -> Dict[str, Any]:
    """Apply DECISION_THRESHOLDS to one quant-report mode entry.

    Returns {"pass": bool|None, "checks": {...}, "complete": bool,
    "decision_grade": bool}. ``pass`` is None when no check could be
    evaluated (weights-only run with no forward/greedy sections), and is
    never True unless ALL four checks were evaluable AND passed — a
    weights-only run must not produce a go verdict from the SNR check
    alone (``complete=False`` names the missing checks in ``note``).
    ``decision_grade=False`` marks runs on synthetic/random weights: the
    machinery is exercised but only a real checkpoint's verdict may flip
    a default."""
    th = DECISION_THRESHOLDS.get(mode)
    if th is None:
        return {"pass": None, "checks": {},
                "note": f"no thresholds defined for mode {mode!r}"}
    checks: Dict[str, Any] = {}

    def check(name, value, bound, larger_is_better):
        if value is None:
            return
        ok = value >= bound if larger_is_better else value <= bound
        checks[name] = {"value": value, "threshold": bound,
                        "ok": bool(ok)}

    w = entry.get("weights") or {}
    check("snr_db_min", w.get("snr_db_min"), th["snr_db_min"], True)
    f = entry.get("forward") or {}
    check("top1_match", f.get("top1_match"), th["top1_match_min"], True)
    check("mean_kl", f.get("mean_kl"), th["mean_kl_max"], False)
    g = entry.get("greedy") or {}
    check("greedy_match_fraction", g.get("match_fraction"),
          th["greedy_match_min"], True)
    required = ("snr_db_min", "top1_match", "mean_kl",
                "greedy_match_fraction")
    missing = [n for n in required if n not in checks]
    complete = not missing
    if not checks:
        ok = None
    elif any(not c["ok"] for c in checks.values()):
        ok = False
    else:
        # every evaluated check passed — but "go" needs the full battery
        ok = True if complete else None
    out = {"pass": ok, "checks": checks, "complete": complete,
           "decision_grade": decision_grade}
    if missing and checks:
        out["note"] = ("incomplete battery — not evaluated: "
                       + ", ".join(missing)
                       + "; a go verdict needs all four checks "
                         "(re-run without --weights-only / with "
                         "--greedy-tokens)")
    if not decision_grade:
        # append rather than replace: a rehearsal --weights-only run must
        # still name the checks that were never evaluated
        grade_note = ("random/synthetic weights: thresholds exercised but "
                      "NOT decision-grade — re-run on a real checkpoint")
        out["note"] = (out["note"] + " | " + grade_note
                       if "note" in out else grade_note)
    return out
