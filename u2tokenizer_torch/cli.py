"""Command-line entry points of the port (counterpart of
``u2tokenizer_tpu/cli.py``, whose other subcommands are not ported yet):

  python -m u2tokenizer_torch.cli train       stage-1 SFT from a jsonl
  python -m u2tokenizer_torch.cli generate    CT volumes -> predictions
                                              jsonl (n samples a case)
  python -m u2tokenizer_torch.cli green       GREEN-score and sort the
                                              samples of a predictions jsonl
  python -m u2tokenizer_torch.cli dpo-convert greened jsonl -> DPO pairs
  python -m u2tokenizer_torch.cli dpo         stage-2 DPO on those pairs
  python -m u2tokenizer_torch.cli serve --checkpoint DIR [--slots 8]
      HTTP report serving (``serve.py``: POST /v1/report, /v1/upload,
      OpenAI chat); ``--slots`` > 1 serves concurrent requests from one
      pool of decode slots (``models.slot_serving.EngineInference``)
  python -m u2tokenizer_torch.cli serve-llm [--model-dir DIR | --preset P]
      OpenAI-protocol serving of a bare decoder (``serve.TextLMServer``)

Every subcommand that runs a model runs it on the GPU unless ``--device
cpu`` is given. The model subcommands take the μ²tokenizer ablation flags
of the JAX package's CLI (--attn-type, --enable-diffts, --enable-dmtp,
--no-multi-scale, --disable-u2tokenizer, --top-k, --num-query-tokens) over
``--config`` (a ``U2ModelConfig`` JSON file) or ``--tiny``; without either
the checkpoint's own config is read, and without a checkpoint the
published μ²Qwen3-1.7B config is built. ``--pretrained`` and
``--checkpoint`` name an HF-layout μ² checkpoint (``model.safetensors``
shards or ``pytorch_model.bin``, ``models.hf_weights``). A tokenizer is an
HF tokenizer directory (``transformers`` is then imported), or omitted (or
``mock``) for the whitespace ``MockTokenizer``.

The ``cmd_*`` functions and ``build_served_model`` / ``build_llm_server``
take the parsed arguments and a ``tokenizer=`` that replaces
``--tokenizer``, so that a script can run exactly what the CLI runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _add_common(p):
    p.add_argument("--config", type=str, default=None,
                   help="U2ModelConfig JSON file (default: the "
                        "checkpoint's own config)")
    p.add_argument("--tiny", action="store_true",
                   help="use the tiny test config")
    # μ²tokenizer ablation matrix (the reference launcher's flags)
    p.add_argument("--attn-type", choices=["rma", "rope", "vanilla"],
                   default=None)
    p.add_argument("--enable-diffts", action="store_true")
    p.add_argument("--enable-dmtp", action="store_true")
    p.add_argument("--no-multi-scale", dest="no_multi_scale",
                   action="store_true")
    p.add_argument("--disable-u2tokenizer", action="store_true",
                   help="LinVT-style baseline: raw projected tokens, no μ²")
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--num-query-tokens", type=int, default=None)


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the GPU; "
                        "'cpu' runs the kernels' plain versions)")


def _load_model_config(args, base=None):
    from .config import U2ModelConfig

    if args.tiny:
        cfg = U2ModelConfig.tiny()
    elif args.config:
        with open(args.config) as f:
            cfg = U2ModelConfig.from_dict(json.load(f))
    else:
        cfg = base or U2ModelConfig()
    u2t = cfg.u2t
    if getattr(args, "attn_type", None):
        u2t = dataclasses.replace(u2t, attn_type=args.attn_type)
    if getattr(args, "enable_diffts", False):
        u2t = dataclasses.replace(u2t, enable_diffts=True)
    if getattr(args, "enable_dmtp", False):
        u2t = dataclasses.replace(u2t, enable_dmtp=True)
    if getattr(args, "no_multi_scale", False):
        u2t = dataclasses.replace(u2t, use_multi_scale=False)
    if getattr(args, "disable_u2tokenizer", False):
        u2t = dataclasses.replace(u2t, enable=False)
    if getattr(args, "top_k", None):
        u2t = dataclasses.replace(u2t, top_k=args.top_k)
    if getattr(args, "num_query_tokens", None):
        u2t = dataclasses.replace(u2t, num_query_tokens=args.num_query_tokens)
    if u2t is not cfg.u2t:
        cfg = dataclasses.replace(cfg, u2t=u2t)
    return cfg


def _load_tokenizer(path):
    if path is None or path == "mock":
        from .utils.mock_tokenizer import MockTokenizer

        return MockTokenizer()
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path, trust_remote_code=False)


def _config_for(args, checkpoint):
    """The model config: --tiny or --config, else the checkpoint's own,
    else the published μ²Qwen3-1.7B config; the ablation flags over it."""
    base = None
    if checkpoint and not (args.tiny or args.config):
        from .eval.inference import load_model_config

        base = load_model_config(checkpoint)
    return _load_model_config(args, base)


def _load_pretrained_into(model, path, cfg):
    """Converted HF-layout μ² weights (safetensors shards or
    pytorch_model.bin) copied into ``model``'s parameters."""
    if os.path.isdir(path) and os.path.exists(
            os.path.join(path, "u2_params.msgpack")):
        raise NotImplementedError(
            "the JAX package's u2_params.msgpack checkpoint form comes with "
            "its convert-checkpoint subcommand, which the port does not "
            "have yet (ROADMAP.md queue 1, item 12); pass an HF-layout "
            "checkpoint directory")
    from .eval.inference import load_state_dict
    from .models.hf_weights import convert_u2_checkpoint
    from .weights import flatten, load_flax_params

    load_flax_params(model, flatten(convert_u2_checkpoint(
        load_state_dict(path), cfg)))
    return model


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def cmd_train(args, tokenizer=None):
    """Stage-1 SFT on one card: ``FusedDataset`` (training augmentations)
    through ``DataLoader``, ``sft.make_trainer`` and
    ``loop.run_training``. Returns the final ``TrainState``."""
    import torch

    from .config import MeshConfig, TrainConfig
    from .data.datasets import DataLoader, FusedDataset
    from .models.u2_model import U2CausalLM, resolve_device
    from .train.loop import MetricLogger, run_training
    from .train.sft import make_trainer

    if max(args.mesh_data, args.mesh_fsdp, args.mesh_tensor) > 1:
        raise NotImplementedError(
            "meshes need the JAX package's parallel/ module, which the "
            "port does not have yet (ROADMAP.md queue 1, parallel/); the "
            "port trains on one card")
    dev = resolve_device(args.device)
    cfg = _config_for(args, args.pretrained)
    tokenizer = tokenizer or _load_tokenizer(args.tokenizer)
    tcfg = TrainConfig(
        learning_rate=args.learning_rate, num_epochs=args.epochs,
        per_device_batch_size=args.batch_size, model_max_length=args.max_length,
        output_dir=args.output_dir, save_steps=args.save_steps,
        max_steps=args.max_steps,
        remat=(False if args.remat == "off" else
               True if args.remat == "nothing" else args.remat),
        ce_chunk=args.ce_chunk,
        mesh=MeshConfig(data=args.mesh_data, fsdp=args.mesh_fsdp,
                        tensor=args.mesh_tensor))

    ds = FusedDataset(
        args.train_base_path, args.train_jsonl_path, tokenizer,
        max_length=tcfg.model_max_length, image_tokens_num=cfg.proj_out_num,
        data_type="training", num_chunks=cfg.num_chunks,
        chunk_depth=cfg.vision.input_spatial[0],
        target_size=cfg.vision.input_spatial[1], device=dev)
    loader = DataLoader(ds, batch_size=args.batch_size, seed=tcfg.seed,
                        num_workers=args.num_workers)
    steps_per_epoch = len(loader)
    total = tcfg.max_steps or int(steps_per_epoch * tcfg.num_epochs)

    model = U2CausalLM(cfg, dtype=torch.bfloat16 if tcfg.bf16
                       else torch.float32, device=dev, seed=tcfg.seed,
                       remat=tcfg.remat)
    if args.pretrained:
        _load_pretrained_into(model, args.pretrained, cfg)
    if args.qlora != "off":
        return _run_qlora_training(args, model, tcfg, loader, total,
                                   steps_per_epoch)
    trainable = None
    if args.freeze_vision_tower:
        trainable = lambda p: "vision_tower" not in p
    state, train_step = make_trainer(model, tcfg, total, trainable)

    logger = MetricLogger(tcfg.output_dir, use_wandb=args.wandb,
                          wandb_project=args.wandb_project)
    state = run_training(tcfg, state, train_step, lambda epoch: iter(loader),
                         steps_per_epoch=steps_per_epoch, logger=logger)
    print("training complete", file=sys.stderr)
    return state


def _run_qlora_training(args, model, tcfg, loader, total_steps,
                        steps_per_epoch):
    """QLoRA SFT on one card (the JAX CLI's ``_run_qlora_training``): the
    float ``model``'s decoder quantized to ``--qlora`` in place and frozen,
    fp32 adapters of ``--lora-rank`` / ``--lora-alpha`` on its
    projections, the μ²tokenizer and projector trained full-rank in bf16
    (Adafactor), the adapters by AdamW (``lora.make_qlora_trainer``). The
    frozen base is not checkpointed: resume re-derives it from
    ``--pretrained`` by the same deterministic quantization, and only the
    trainable leaves and the optimizer state go into the checkpoints. At
    the end the trainable tree is written to
    ``<output_dir>/qlora_adapters.msgpack`` in flax's msgpack form.
    Returns the ``QLoraState``."""
    from .train.checkpoint import save_params_msgpack
    from .train.lora import flax_tree, make_qlora_trainer
    from .train.loop import MetricLogger, run_training

    state, train_step = make_qlora_trainer(
        model, tcfg, total_steps, args.qlora, args.lora_rank,
        args.lora_alpha)
    logger = MetricLogger(tcfg.output_dir, use_wandb=args.wandb,
                          wandb_project=args.wandb_project)
    state = run_training(tcfg, state, train_step, lambda epoch: iter(loader),
                         steps_per_epoch=steps_per_epoch, logger=logger)
    out = os.path.join(tcfg.output_dir, "qlora_adapters.msgpack")
    save_params_msgpack(out, flax_tree(state.model, state.train))
    print(f"qlora adapters saved to {out} (merge for export with "
          "train.lora.merge_qlora over the quantized base)", file=sys.stderr)
    print("training complete", file=sys.stderr)
    return state


# ---------------------------------------------------------------------------
# dpo
# ---------------------------------------------------------------------------

def cmd_dpo(args, tokenizer=None):
    """Stage-2 DPO on one card: pairs from ``FusedDataset(dpo_mode=True)``
    in numpy's ``default_rng(epoch)`` order, their volumes through the
    training transform at collate time, the policy and its frozen
    reference copy from ``--pretrained``, ``dpo.make_dpo_train_step``.
    Returns (state, reference model)."""
    import numpy as np
    import torch

    from .config import DPOConfig, TrainConfig
    from .data.datasets import FusedDataset
    from .data.transforms import U2VolumeTransform
    from .models.u2_model import U2CausalLM, resolve_device
    from .train.dpo import (collate_preference_batch, frozen_reference,
                            make_dpo_train_step)
    from .train.loop import MetricLogger
    from .train.sft import TrainState, make_optimizer

    dev = resolve_device(args.device)
    cfg = _config_for(args, args.pretrained)
    tokenizer = tokenizer or _load_tokenizer(args.tokenizer)
    dcfg = DPOConfig(beta=args.beta, learning_rate=args.learning_rate,
                     ce_chunk=args.ce_chunk)
    tcfg = TrainConfig(learning_rate=args.learning_rate,
                       output_dir=args.output_dir)

    # max_length is the prompt's 512: the question ids the μ²tokenizer
    # reads are padded to it, as in the JAX package
    ds = FusedDataset(
        args.train_base_path, args.train_jsonl_path, tokenizer,
        max_length=dcfg.max_prompt_length, image_tokens_num=cfg.proj_out_num,
        data_type="training", dpo_mode=True, return_image=False)
    transform = U2VolumeTransform(
        data_type="training", target_size=cfg.vision.input_spatial[1],
        chunk_depth=cfg.vision.input_spatial[0], num_chunks=cfg.num_chunks,
        device=dev)

    model = U2CausalLM(cfg, dtype=torch.bfloat16, device=dev, seed=0,
                       remat=True)
    if args.pretrained:
        _load_pretrained_into(model, args.pretrained, cfg)
    total = args.max_steps or (len(ds) // args.batch_size) * int(args.epochs)
    ref_model = frozen_reference(model)
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(tcfg, model.parameters(),
                                                total))
    step_fn = make_dpo_train_step(model, dcfg)

    logger = MetricLogger(tcfg.output_dir)
    step = 0
    for epoch in range(int(args.epochs)):
        order = np.random.default_rng(epoch).permutation(len(ds))
        for i in range(0, len(order) - args.batch_size + 1, args.batch_size):
            samples = [ds[int(j)] for j in order[i:i + args.batch_size]]
            batch = collate_preference_batch(
                samples, tokenizer, dcfg.max_prompt_length,
                dcfg.max_completion_length, transform)
            state, metrics = step_fn(state, ref_model, batch)
            step += 1
            if step % 10 == 0:
                logger.log(step, {k: float(v) for k, v in metrics.items()})
            if args.max_steps and step >= args.max_steps:
                break
        if args.max_steps and step >= args.max_steps:
            break
    print("dpo complete", file=sys.stderr)
    return state, ref_model


# ---------------------------------------------------------------------------
# generate / green / dpo-convert
# ---------------------------------------------------------------------------

def check_report_validity(text: str, min_len: int = 20) -> bool:
    """Reject CJK characters / too-short generations
    (pred_then_green.py:97-103)."""
    if len(text) < min_len:
        return False
    return not any("一" <= ch <= "鿿" for ch in text)


def _init_or_load(args, cfg, dev, seed: int = 0):
    """The model for generation: built on ``dev`` from ``seed``, the
    checkpoint's weights copied in when one is named, cast to bf16."""
    import torch

    from .models.quantize import cast_for_inference
    from .models.u2_model import U2CausalLM

    model = U2CausalLM(cfg, dtype=torch.bfloat16, device=dev, seed=seed)
    if getattr(args, "checkpoint", None):
        _load_pretrained_into(model, args.checkpoint, cfg)
    return cast_for_inference(model)


def cmd_generate(args, tokenizer=None):
    """CT volumes -> predictions jsonl (pred_then_green.py generate
    parity): ``--num-samples`` samples a case, kept by the validity filter
    (the last sample always). Sampled decoding is speculative unless
    ``--no-speculative``; several samples a case then take the fan-out
    route (the vision encode and prefill once a case)."""
    import torch

    from .config import GenerationConfig
    from .data.datasets import FusedDataset
    from .models.generate import (make_fanout_multimodal_generate_fn,
                                  make_multimodal_generate_fn)
    from .models.speculative import make_spec_multimodal_generate_fn
    from .models.u2_model import resolve_device

    dev = resolve_device(args.device)
    cfg = _config_for(args, args.checkpoint)
    tokenizer = tokenizer or _load_tokenizer(args.tokenizer)
    ds = FusedDataset(
        args.base_path, args.jsonl_path, tokenizer,
        max_length=args.max_length, image_tokens_num=cfg.proj_out_num,
        data_type="validation", num_chunks=cfg.num_chunks,
        chunk_depth=cfg.vision.input_spatial[0],
        target_size=cfg.vision.input_spatial[1], device=dev)

    gen = GenerationConfig(
        max_new_tokens=args.max_new_tokens, do_sample=args.do_sample,
        top_p=args.top_p, eos_token_id=tokenizer.eos_token_id,
        pad_token_id=tokenizer.pad_token_id or 0)
    model = _init_or_load(args, cfg, dev)
    fan_fn = gen_fn = None
    spec = args.speculative or (args.do_sample and not args.no_speculative)
    if spec and args.do_sample and args.num_samples > 1:
        # vision encode and prefill once a case, speculative sampled decode
        # of the n samples over the shared prompt cache
        fan_fn = make_spec_multimodal_generate_fn(model, gen,
                                                  fanout=args.num_samples)
    elif spec:
        gen_fn = make_spec_multimodal_generate_fn(model, gen)
    else:
        gen_fn = make_multimodal_generate_fn(model, gen)
        if args.do_sample and args.num_samples > 1:
            fan_fn = make_fanout_multimodal_generate_fn(model, gen,
                                                        args.num_samples)

    generator = torch.Generator(dev).manual_seed(args.seed)
    skip = (gen.pad_token_id, tokenizer.eos_token_id)
    decode_row = lambda row: tokenizer.decode(
        [t for t in row if t not in skip], skip_special_tokens=True)
    with open(args.output, "w") as f:
        for idx in range(args.start, min(args.end, len(ds))):
            s = ds[idx]
            if s is None:
                continue
            ids = s["input_id"][None].to(dev)
            images = s["image"][None].to(dev)
            qids = s["question_ids"][None].to(dev)
            plen = s["attention_mask"].sum()[None].to(dev, torch.int32)
            if fan_fn is not None:
                toks = fan_fn(ids, images, qids, plen, generator)
                texts = [decode_row(row) for row in toks.tolist()]
                # the per-sample loop's filter: valid texts, and the last
                # sample whatever it is
                preds = [t for k, t in enumerate(texts)
                         if check_report_validity(t) or k == len(texts) - 1]
            else:
                preds = []
                for k in range(args.num_samples):
                    toks = gen_fn(ids, images, qids, plen, generator)
                    text = decode_row(toks[0].tolist())
                    if (check_report_validity(text)
                            or k == args.num_samples - 1):
                        preds.append(text)
            row = {"image": s["image_path"], "question": s["prompt_question"],
                   "answer": s["answer"], "predictions": preds}
            f.write(json.dumps(row) + "\n")
            f.flush()
    print(f"wrote {args.output}", file=sys.stderr)


def cmd_green(args, tokenizer=None):
    """GREEN-score a predictions jsonl and sort each row's samples best
    to worst (pred_then_green.py evaluate parity). ``tokenizer`` is the
    judge's."""
    from .data.datasets import load_jsonl
    from .eval.green import GreenScorer

    judge = _build_judge(args, tokenizer)
    rows = load_jsonl(args.predictions)
    scorer = GreenScorer(judge, compute_summary_stats=not args.no_summary,
                         judge_name=args.judge or "stub")

    with open(args.output, "w") as f:
        for row in rows:
            preds = row.get("predictions") or [row.get("prediction")]
            result = scorer([row["answer"]] * len(preds), preds)
            order = sorted(range(len(preds)),
                           key=lambda i: -(result.scores[i] or 0.0))
            row["predictions"] = [preds[i] for i in order]
            row["green_scores"] = [result.scores[i] for i in order]
            f.write(json.dumps(row) + "\n")
    print(f"wrote {args.output}", file=sys.stderr)


def stub_judge(prompts):
    """The judge without a model (pipeline testing): every response one
    matched finding and no error, so every GREEN score is 1.0."""
    return ["[Explanation]:\nstub\n\n[Clinically Significant Errors]:\n"
            "(a) False report of a finding in the candidate: 0.\n\n"
            "[Matched Findings]:\n1. stub\n" for _ in prompts]


def _build_judge(args, tokenizer=None):
    """The judge of ``green``: the stub judge without ``--judge``, else a
    ``TorchJudge`` over the decoder of the HF directory ``--judge`` in
    bf16, or with ``--judge-weights int8`` its bf16 weights quantized to
    int8 (weight-only; a 7B judge then takes ~7 GB)."""
    if args.judge is None:
        return stub_judge
    import torch

    from .eval.green import TorchJudge
    from .models.hf_weights import (convert_decoder, llm_config_from_hf,
                                    load_safetensors_dir)
    from .models.llm.decoder import CausalLM
    from .models.quantize import cast_for_inference, quantize_llm_weights
    from .models.u2_model import resolve_device
    from .weights import flatten, load_flax_params

    weights = getattr(args, "judge_weights", "bf16")
    if weights not in (None, "bf16", "int8"):
        raise SystemExit(f"--judge-weights {weights} unsupported for the "
                         "judge; use bf16 or int8")
    dev = resolve_device(args.device)
    with open(os.path.join(args.judge, "config.json")) as f:
        cfg = llm_config_from_hf(json.load(f))
    model = CausalLM(cfg, dtype=torch.bfloat16, device=dev)
    sd = {k: v.float().numpy()
          for k, v in load_safetensors_dir(args.judge).items()}
    load_flax_params(model, flatten(convert_decoder(sd, cfg)))
    del sd
    cast_for_inference(model)
    if weights == "int8":
        quantize_llm_weights(model, "int8")
    tokenizer = tokenizer or _load_tokenizer(args.judge)
    return TorchJudge(model, tokenizer, device=dev)


def cmd_dpo_convert(args):
    """greened jsonl -> DPO pairs {chosen=best, rejected=worst}, dropping
    cases whose best score is 0 or None (src/utils/dpo_dataset_convert.py
    :6-30)."""
    from .data.datasets import load_jsonl

    rows = load_jsonl(args.greened)
    n = 0
    with open(args.output, "w") as f:
        for row in rows:
            preds = row.get("predictions", [])
            scores = row.get("green_scores", [])
            if not preds or not scores or not scores[0]:
                continue
            f.write(json.dumps({
                "image": row["image"], "question": row["question"],
                "answer": row["answer"], "chosen": preds[0],
                "rejected": preds[-1]}) + "\n")
            n += 1
    print(f"wrote {n} pairs to {args.output}", file=sys.stderr)


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def build_served_model(args, tokenizer=None):
    """What ``serve`` serves: a ``U2InferenceModel`` of the checkpoint,
    wrapped in an ``EngineInference`` of ``args.slots`` slots when that is
    above 1. ``tokenizer`` replaces ``--tokenizer``."""
    from .eval.inference import U2InferenceModel

    cfg = _load_model_config(args) if (args.tiny or args.config) else None
    spec = args.speculative
    tokenizer = tokenizer or _load_tokenizer(args.tokenizer)
    model = U2InferenceModel(
        args.checkpoint, tokenizer=tokenizer, model_config=cfg,
        max_new_tokens=args.max_new_tokens, do_sample=args.do_sample,
        top_p=args.top_p,
        # None = the model's default (on for sampled report serving);
        # 'off' disables for low-acceptance content
        speculative=None if spec is None else spec != "off",
        weights=args.weights, device=args.device)
    if args.slots > 1:
        # continuous batching: concurrent requests share a slot pool
        from .models.slot_serving import EngineInference

        model = EngineInference(
            model.model, model.tokenizer, model.cfg,
            max_new_tokens=args.max_new_tokens, do_sample=args.do_sample,
            top_p=args.top_p, num_slots=args.slots,
            prompt_buf=args.max_length,
            speculative=("auto" if spec == "auto" else
                         False if spec == "off" else
                         True if spec else None),
            device=args.device)
    return model


def cmd_serve(args):
    """HTTP serving (serve.py): POST /v1/report {image_path, question}."""
    from .serve import serve

    model = build_served_model(args)
    if args.slots > 1:
        print(f"continuous batching: {args.slots} slots", file=sys.stderr)
    print(f"serving on {args.host}:{args.port}", file=sys.stderr)
    serve(model, host=args.host, port=args.port)


# ---------------------------------------------------------------------------
# serve-llm
# ---------------------------------------------------------------------------

def build_llm_server(args, tokenizer=None, seed: int = 0):
    """What ``serve-llm`` serves: a ``TextLMServer`` over a bf16 decoder,
    from an HF checkpoint directory (``--model-dir``) or an ``LLMConfig``
    preset with random weights drawn from ``seed``."""
    import torch

    from .config import LLMConfig
    from .models.layers import cast_for_inference, init_weights
    from .models.llm.decoder import CausalLM
    from .models.u2_model import resolve_device
    from .serve import TextLMServer
    from .weights import flatten, load_flax_params

    if args.tensor_parallel > 1:
        raise NotImplementedError(
            "--tensor-parallel needs the JAX package's parallel/ module, "
            "which the port does not have yet")
    dev = resolve_device(args.device)
    if args.model_dir:  # HF checkpoint directory
        from .models.hf_weights import (convert_decoder, llm_config_from_hf,
                                        load_safetensors_dir)

        with open(os.path.join(args.model_dir, "config.json")) as f:
            cfg = llm_config_from_hf(json.load(f))
        model = CausalLM(cfg, dtype=torch.bfloat16, device=dev)
        sd = {k: v.float().numpy()
              for k, v in load_safetensors_dir(args.model_dir).items()}
        load_flax_params(model, flatten(convert_decoder(sd, cfg)))
    else:
        cfg = getattr(LLMConfig, args.preset)()
        model = CausalLM(cfg, dtype=torch.bfloat16, device=dev)
        init_weights(model, seed)
    cast_for_inference(model)
    return TextLMServer(model, tokenizer or _load_tokenizer(args.tokenizer),
                        max_new_tokens=args.max_new_tokens,
                        do_sample=args.do_sample, top_p=args.top_p,
                        name=args.model_dir or args.preset, device=dev)


def cmd_serve_llm(args):
    """OpenAI-protocol text-LM server: any ported decoder family, for the
    synthesis pipeline or GREEN judging."""
    from http.server import ThreadingHTTPServer

    from .serve import U2Server, make_handler

    lm = build_llm_server(args)
    httpd = ThreadingHTTPServer((args.host, args.port),
                                make_handler(U2Server(lm, transform=False)))
    print(f"serving OpenAI-protocol LLM on {args.host}:{args.port}",
          file=sys.stderr)
    httpd.serve_forever()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="u2tokenizer_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    _add_common(t)
    t.add_argument("--tokenizer", default=None)
    t.add_argument("--train-base-path", dest="train_base_path", required=True)
    t.add_argument("--train-jsonl-path", dest="train_jsonl_path",
                   required=True)
    t.add_argument("--learning-rate", type=float, default=4e-6)
    t.add_argument("--epochs", type=float, default=4.0)
    t.add_argument("--batch-size", type=int, default=1)
    t.add_argument("--max-length", type=int, default=1024)
    t.add_argument("--output-dir", default="./output/u2-sft")
    t.add_argument("--save-steps", type=int, default=2000)
    t.add_argument("--max-steps", type=int, default=None)
    t.add_argument("--mesh-data", type=int, default=1)
    t.add_argument("--mesh-fsdp", type=int, default=1)
    t.add_argument("--mesh-tensor", type=int, default=1)
    t.add_argument("--num-workers", type=int, default=4)
    t.add_argument("--freeze-vision-tower", action="store_true")
    t.add_argument("--remat", default="nothing",
                   choices=["nothing", "dots_no_batch", "dots", "off"],
                   help="gradient checkpointing of the decoder layers: "
                        "'nothing' recomputes everything, 'off' none "
                        "('dots' policies are not ported yet)")
    t.add_argument("--ce-chunk", dest="ce_chunk", type=int, default=0,
                   help="> 0: compute the LM loss in sequence chunks of "
                        "this size, never materializing the (B, S, vocab) "
                        "logits; same numbers as the plain loss")
    t.add_argument("--pretrained", default=None)
    t.add_argument("--qlora", default="off", choices=["off", "int8", "int4"],
                   help="quantized-base LoRA (not ported yet)")
    t.add_argument("--lora-rank", type=int, default=16)
    t.add_argument("--lora-alpha", type=float, default=32.0)
    t.add_argument("--wandb", action="store_true")
    t.add_argument("--wandb-project", default="AMOS-MM")
    _add_device(t)
    t.set_defaults(fn=cmd_train)

    d = sub.add_parser("dpo")
    _add_common(d)
    d.add_argument("--tokenizer", default=None)
    d.add_argument("--train-base-path", dest="train_base_path", required=True)
    d.add_argument("--train-jsonl-path", dest="train_jsonl_path",
                   required=True)
    d.add_argument("--learning-rate", type=float, default=4e-6)
    d.add_argument("--beta", type=float, default=0.1)
    d.add_argument("--epochs", type=float, default=6.0)
    d.add_argument("--batch-size", type=int, default=1)
    d.add_argument("--output-dir", default="./output/u2-dpo")
    d.add_argument("--max-steps", type=int, default=None)
    d.add_argument("--pretrained", default=None)
    d.add_argument("--ce-chunk", dest="ce_chunk", type=int, default=0,
                   help="> 0: compute completion log-probs in sequence "
                        "chunks, never materializing the (2B, S, vocab) "
                        "logits (policy and reference forward)")
    _add_device(d)
    d.set_defaults(fn=cmd_dpo)

    g = sub.add_parser("generate")
    _add_common(g)
    g.add_argument("--tokenizer", default=None)
    g.add_argument("--base-path", dest="base_path", required=True)
    g.add_argument("--jsonl-path", dest="jsonl_path", required=True)
    g.add_argument("--checkpoint", default=None)
    g.add_argument("--output", required=True)
    g.add_argument("--max-length", type=int, default=1024)
    g.add_argument("--max-new-tokens", type=int, default=768)
    g.add_argument("--do-sample", action="store_true")
    g.add_argument("--top-p", type=float, default=0.9)
    g.add_argument("--num-samples", type=int, default=8)
    g.add_argument("--no-speculative", action="store_true",
                   help="disable the sampled path's speculative default")
    g.add_argument("--speculative", action="store_true",
                   help="n-gram-drafted speculative decode (the same "
                        "tokens greedy, the same distribution sampled)")
    g.add_argument("--start", type=int, default=0)
    g.add_argument("--end", type=int, default=10**9)
    g.add_argument("--seed", type=int, default=0)
    _add_device(g)
    g.set_defaults(fn=cmd_generate)

    gr = sub.add_parser("green")
    gr.add_argument("--predictions", required=True)
    gr.add_argument("--judge", default=None,
                    help="HF checkpoint dir of the judge LLM "
                         "(GREEN-RadLlama2); none: the stub judge")
    gr.add_argument("--judge-weights", dest="judge_weights", default="bf16",
                    choices=["bf16", "int8"],
                    help="judge weight precision: int8 halves the judge's "
                         "weight footprint")
    gr.add_argument("--output", required=True)
    gr.add_argument("--no-summary", action="store_true")
    _add_device(gr)
    gr.set_defaults(fn=cmd_green)

    dc = sub.add_parser("dpo-convert")
    dc.add_argument("--greened", required=True)
    dc.add_argument("--output", required=True)
    dc.set_defaults(fn=cmd_dpo_convert)

    sv = sub.add_parser("serve")
    sv.add_argument("--slots", type=int, default=1,
                    help=">1 enables continuous batching over a slot pool")
    sv.add_argument("--max-length", dest="max_length", type=int,
                    default=1024)
    _add_common(sv)
    sv.add_argument("--checkpoint", required=True)
    sv.add_argument("--tokenizer", default=None)
    sv.add_argument("--host", default="0.0.0.0")
    sv.add_argument("--port", type=int, default=8088)
    sv.add_argument("--max-new-tokens", type=int, default=768)
    sv.add_argument("--do-sample", action="store_true")
    sv.add_argument("--top-p", type=float, default=0.9)
    sv.add_argument("--speculative", nargs="?", const="on", default=None,
                    choices=["on", "auto", "off"],
                    help="n-gram-drafted decode (the same tokens or "
                         "distribution either way). Default: on for the "
                         "single-request path when sampling, off on the "
                         "slot engine; 'off' disables; 'auto' (slot "
                         "engine) walks a ladder of verify-block sizes "
                         "(1..block_len) on measured acceptance")
    sv.add_argument("--weights", choices=["bf16", "int8", "int4"],
                    default="bf16",
                    help="serving weight precision")
    _add_device(sv)
    sv.set_defaults(fn=cmd_serve)

    sl = sub.add_parser("serve-llm")
    sl.add_argument("--model-dir", dest="model_dir", default=None,
                    help="HF checkpoint dir (safetensors + config.json)")
    sl.add_argument("--preset", default="tiny",
                    help="LLMConfig classmethod when no --model-dir "
                         "(tiny/qwen3_1_7b/qwen3_8b/llama_3_2_1b/...)")
    sl.add_argument("--tokenizer", default=None)
    sl.add_argument("--tensor-parallel", dest="tensor_parallel", type=int,
                    default=1)
    sl.add_argument("--host", default="0.0.0.0")
    sl.add_argument("--port", type=int, default=8088)
    sl.add_argument("--max-new-tokens", dest="max_new_tokens", type=int,
                    default=512)
    sl.add_argument("--do-sample", dest="do_sample", action="store_true")
    sl.add_argument("--top-p", dest="top_p", type=float, default=0.9)
    _add_device(sl)
    sl.set_defaults(fn=cmd_serve_llm)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
