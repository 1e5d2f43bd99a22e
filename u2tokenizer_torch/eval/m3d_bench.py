"""M3D-Bench tasks: positioning (REC/REG), segmentation, retrieval
(counterpart of ``u2tokenizer_tpu/eval/m3d_bench.py``).

  * ``evaluate_rec``: eval/M3D-Bench/eval/eval_pos.py (--rec): generate,
    extract the 3D box from prediction and answer, IoU per case (-1 when
    either box is unparseable), mean IoU over valid cases and acc@0.5.
  * ``evaluate_reg``: eval_pos.py (--rec false): the generation against
    the term answer, BLEU-1/ROUGE-1/METEOR/BERTScore-F1.
  * ``evaluate_seg``: eval/M3D-Bench/eval/eval_seg.py: generate with the
    '[SEG]' path (``models.generate.make_seg_generate_fn``), the mask
    sigmoid(logits) > 0.5, binary Dice per case.
  * ``evaluate_itr``: eval/M3D-Bench/eval/eval_itr.py: encode every
    image/text pair, the dot-product similarity matrix, recall@{1,5,10} in
    both directions (the diagonal is the ground truth).

Cases run one at a time (B=1) on the model's device; where the JAX package
splits a ``jax.random`` key a case, the port draws from one seeded
``torch.Generator`` (greedy tokens do not depend on it). Rows go into
``EvalResult.rows`` and the aggregates into ``EvalResult.metrics``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..models.seg import trilinear_resize
from ..utils.box import box_iou_3d, dice_score, extract_box_from_text
from .evaluators import (EvalResult, ReportGenerator, _case_generator,
                         _decode_tokens)
from .metrics import bert_score_f1, bleu, meteor, rouge_n


def _question(sample):
    return sample.get("prompt_question", sample.get("question"))


def evaluate_rec(dataset, generator: ReportGenerator,
                 max_cases: int = 10**9, seed: int = 0,
                 iou_threshold: float = 0.5) -> EvalResult:
    """REC: the question names a term, the model answers with a 3D box."""
    rng = _case_generator(generator, seed)
    result = EvalResult()
    ious = []
    for idx in range(min(max_cases, len(dataset))):
        sample = dataset[idx]
        if sample is None:
            continue
        pred = generator(sample, rng)
        pred_box = extract_box_from_text(pred)
        gold_box = extract_box_from_text(sample["answer"])
        # the reference reports -1 for an unparseable box and keeps the row
        iou = (box_iou_3d(pred_box, gold_box)
               if pred_box and gold_box else -1.0)
        if iou >= 0:
            ious.append(iou)
        result.rows.append({
            "question_type": sample.get("question_type", "REC"),
            "question": _question(sample),
            "answer": sample["answer"], "prediction": pred, "iou": iou,
        })
    result.metrics["mean_iou"] = float(np.mean(ious)) if ious else 0.0
    result.metrics["acc_at_05"] = (
        float(np.mean([i >= iou_threshold for i in ious])) if ious else 0.0)
    result.metrics["parse_rate"] = len(ious) / max(len(result.rows), 1)
    return result


def evaluate_reg(dataset, generator: ReportGenerator,
                 max_cases: int = 10**9, seed: int = 0,
                 compute_bertscore: bool = True) -> EvalResult:
    """REG: the question carries a box, the model names the structure."""
    rng = _case_generator(generator, seed)
    result = EvalResult()
    refs, hyps = [], []
    for idx in range(min(max_cases, len(dataset))):
        sample = dataset[idx]
        if sample is None:
            continue
        pred = generator(sample, rng).strip()
        answer = str(sample["answer"]).strip()
        refs.append(answer)
        hyps.append(pred)
        result.rows.append({
            "question": _question(sample),
            "answer": answer, "prediction": pred,
            "bleu": bleu(answer, pred, max_n=1),
            "rouge1": rouge_n(answer, pred, 1)["f"],
            "meteor": meteor(answer, pred),
        })
    for key in ("bleu", "rouge1", "meteor"):
        result.metrics[key] = (
            float(np.mean([r[key] for r in result.rows]))
            if result.rows else 0.0)
    if compute_bertscore and refs:
        result.metrics["bert_f1"] = float(np.mean(bert_score_f1(refs, hyps)))
    return result


def _resized(volume: np.ndarray, size, device) -> torch.Tensor:
    """(C, D, H, W) -> (1, C, *size) on ``device``, resized as the JAX
    package's ``trilinear_resize`` when ``size`` is given."""
    x = torch.as_tensor(volume, dtype=torch.float32)[None].to(device)
    return x if size is None else trilinear_resize(x, tuple(size))


def evaluate_seg(dataset, seg_generate_fn: Callable, tokenizer,
                 max_cases: int = 10**9, seed: int = 0, pad_id: int = 0,
                 eos_id: int = 1, seg_image_size: Optional[tuple] = None,
                 device=None) -> EvalResult:
    """SEG/RefSEG: generate text (expected to carry '[SEG]'), the mask from
    the '[SEG]' hidden state, binary Dice per case.

    ``seg_generate_fn`` is ``make_seg_generate_fn``'s (input_ids, images,
    question_ids, prompt_len, seg_image, generator) -> (tokens,
    seg_logits, has_seg), on ``device`` (by default its model's).
    ``seg_image_size``: the (D, H, W) the SegVol head takes where it
    differs from the volumes' geometry; image and target mask are resized
    to it (the reference evaluates at the native (32, 256, 256), where the
    two coincide).
    """
    dev = torch.device(device) if device else seg_generate_fn.model.device
    rng = torch.Generator(dev).manual_seed(seed)
    result = EvalResult()
    dices = []
    for idx in range(min(max_cases, len(dataset))):
        sample = dataset[idx]
        if sample is None:
            continue
        seg_image = np.asarray(sample["image"], np.float32)
        if seg_image.ndim == 4:  # (T, D, H, W) -> one chunk (1, D, H, W)
            seg_image = seg_image[:1]
        tokens, seg_logits, has_seg = seg_generate_fn(
            *[torch.as_tensor(sample[key])[None].to(dev)
              for key in ("input_id", "image", "question_ids")],
            torch.tensor([int(sample["attention_mask"].sum())],
                         dtype=torch.int32, device=dev),
            _resized(seg_image, seg_image_size, dev), rng)
        pred_text = _decode_tokens(tokenizer, tokens[0].tolist(), pad_id,
                                   eos_id)
        target = np.asarray(sample["seg"], np.float32)
        if target.ndim == 3:
            target = target[None]
        target = _resized(target, seg_image_size, dev)[0].cpu().numpy()
        logits = seg_logits[0].float().cpu().numpy()
        pred_mask = (1.0 / (1.0 + np.exp(-logits)) > 0.5).astype(np.float32)
        dice = dice_score(pred_mask, (target > 0.5).astype(np.float32))
        dices.append(dice)
        result.rows.append({
            "question_type": sample.get("question_type", "SEG"),
            "question": _question(sample),
            "answer": sample["answer"], "prediction": pred_text,
            "dice": dice, "has_seg": bool(has_seg[0]),
        })
    result.metrics["mean_dice"] = float(np.mean(dices)) if dices else 0.0
    result.metrics["seg_token_rate"] = (
        float(np.mean([r["has_seg"] for r in result.rows]))
        if result.rows else 0.0)
    return result


def recall_at_k(similarity: np.ndarray, k: int) -> float:
    """Diagonal recall@k of a (N, N) query x gallery score matrix
    (eval_itr.py:39-44)."""
    order = np.argsort(-similarity, axis=1)[:, :k]
    gold = np.arange(similarity.shape[0])[:, None]
    return float((order == gold).any(axis=1).mean())


def evaluate_itr(dataset, encode_image_fn: Callable, encode_text_fn: Callable,
                 max_cases: int = 10**9) -> EvalResult:
    """Image-text retrieval recall@{1,5,10} in both directions.

    ``encode_image_fn(image[None])`` and ``encode_text_fn(input_id[None],
    attention_mask[None])`` each return a (1, E) feature row (the reference
    takes the CLS token of M3D-CLIP's encoders, eval_itr.py:83-84).
    """
    img_feats, txt_feats = [], []
    result = EvalResult()
    for idx in range(min(max_cases, len(dataset))):
        sample = dataset[idx]
        if sample is None:
            continue
        img_feats.append(np.asarray(
            encode_image_fn(np.asarray(sample["image"])[None]))[0])
        txt_feats.append(np.asarray(encode_text_fn(
            np.asarray(sample["input_id"])[None],
            np.asarray(sample["attention_mask"])[None]))[0])
    if not img_feats:
        return result
    scores = np.stack(img_feats) @ np.stack(txt_feats).T
    for k in (1, 5, 10):
        kk = min(k, scores.shape[0])
        result.metrics[f"ir_r{k}"] = recall_at_k(scores, kk)
        result.metrics[f"tr_r{k}"] = recall_at_k(scores.T, kk)
    result.rows = [{"index": i,
                    "ir_top1": int(np.argmax(scores[i])),
                    "tr_top1": int(np.argmax(scores[:, i]))}
                   for i in range(scores.shape[0])]
    return result


def make_u2_itr_encoders(model):
    """Default ITR feature adapters on the μ² stack, on the model's
    device: the image feature is the projected ViT tokens' mean over
    chunks and tokens, the text feature the masked mean of the decoder's
    token embeddings; both L2-normalised in the model's dtype and handed
    back as fp32 numpy rows. A stand-in for the reference's M3D-CLIP dual
    encoder (eval_itr.py:56-60), so that ``evaluate_itr`` runs on any
    ``U2CausalLM``."""
    dev = model.device

    def _unit(feats):
        feats = feats / (torch.linalg.vector_norm(feats, dim=-1,
                                                  keepdim=True) + 1e-8)
        return feats.float().cpu().numpy()

    @torch.inference_mode()
    def encode_image(images):
        images = torch.as_tensor(images).to(dev)
        b, t = images.shape[:2]
        feats = model.encode_images(
            images.reshape(b * t, 1, *images.shape[2:]))
        return _unit(feats.reshape(b, t, *feats.shape[1:]).mean(dim=(1, 2)))

    @torch.inference_mode()
    def encode_text(input_ids, attention_mask):
        emb = model.embed_tokens(torch.as_tensor(input_ids).to(dev))
        m = torch.as_tensor(attention_mask).to(dev)[..., None].to(emb.dtype)
        return _unit((emb * m).sum(1) / m.sum(1).clamp_min(1.0))

    return encode_image, encode_text
