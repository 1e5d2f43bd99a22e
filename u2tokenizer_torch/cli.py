"""Command-line entry points of the port (counterpart of
``u2tokenizer_tpu/cli.py``; its ``verify-checkpoint`` is not ported yet):

  python -m u2tokenizer_torch.cli train       stage-1 SFT from a jsonl, on
                                              one card or (torchrun) a
                                              data/fsdp/tensor mesh
  python -m u2tokenizer_torch.cli generate    CT volumes -> predictions
                                              jsonl (n samples a case)
  python -m u2tokenizer_torch.cli green       GREEN-score and sort the
                                              samples of a predictions jsonl
  python -m u2tokenizer_torch.cli dpo-convert greened jsonl -> DPO pairs
  python -m u2tokenizer_torch.cli dpo         stage-2 DPO on those pairs
  python -m u2tokenizer_torch.cli eval        MRG / VQA evaluation of a
                                              model over a jsonl of cases
  python -m u2tokenizer_torch.cli eval-m3d    M3D-Bench: rec, reg, seg,
                                              refseg, itr
  python -m u2tokenizer_torch.cli eval-predictions
                                              the metric battery over any
                                              model's predictions jsonl
  python -m u2tokenizer_torch.cli quant-report
                                              int8/int4 serving-quality
                                              gate against the float model
  python -m u2tokenizer_torch.cli convert-checkpoint
                                              a released HF μ² checkpoint ->
                                              u2_config.json +
                                              u2_params.msgpack (host only)
  python -m u2tokenizer_torch.cli demo        one CT volume -> report text
                                              (one question, or a REPL);
                                              --attention draws the
                                              μ²tokenizer's maps to a PNG
  python -m u2tokenizer_torch.cli serve --checkpoint DIR [--slots 8]
      HTTP report serving (``serve.py``: POST /v1/report, /v1/upload,
      OpenAI chat); ``--slots`` > 1 serves concurrent requests from one
      pool of decode slots (``models.slot_serving.EngineInference``)
  python -m u2tokenizer_torch.cli serve-llm [--model-dir DIR | --preset P]
      OpenAI-protocol serving of a bare decoder (``serve.TextLMServer``)
  python -m u2tokenizer_torch.cli preprocess IN... --out-dir D
                                              NIfTI files -> preprocessed
                                              .npy (``data/preprocess.py``)
  python -m u2tokenizer_torch.cli selftest    train -> generate -> green ->
                                              dpo-convert at the tiny
                                              config on synthetic volumes

``main`` writes a JSON crash report (``utils/errors.record``) into
``./error_reports`` when a subcommand raises.

Every subcommand that runs a model runs it on the GPU unless ``--device
cpu`` is given. The model subcommands take the μ²tokenizer ablation flags
of the JAX package's CLI (--attn-type rma|rope|vanilla, --enable-diffts,
--enable-dmtp, --no-multi-scale, --disable-u2tokenizer, --top-k,
--num-query-tokens) over
``--config`` (a ``U2ModelConfig`` JSON file) or ``--tiny``; without either
the checkpoint's own config is read, and without a checkpoint the
published μ²Qwen3-1.7B config is built. ``--pretrained`` and
``--checkpoint`` name an HF-layout μ² checkpoint (``model.safetensors``
shards or ``pytorch_model.bin``, ``models.hf_weights``) or a directory
that ``convert-checkpoint`` wrote. A tokenizer is an
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
    """μ² weights copied into ``model``'s parameters: a directory written
    by ``convert-checkpoint`` (``u2_params.msgpack``, the flax tree) or a
    converted HF-layout checkpoint (safetensors shards or
    pytorch_model.bin)."""
    from .eval.inference import CONVERTED_PARAMS, load_state_dict
    from .weights import flatten, load_flax_params

    if os.path.isdir(path) and os.path.exists(
            os.path.join(path, CONVERTED_PARAMS)):
        from .train.checkpoint import load_params_msgpack

        tree = load_params_msgpack(os.path.join(path, CONVERTED_PARAMS))
    else:
        from .models.hf_weights import convert_u2_checkpoint

        tree = convert_u2_checkpoint(load_state_dict(path), cfg)
    load_flax_params(model, flatten(tree))
    return model


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def _launched() -> bool:
    """Whether a launcher (``torchrun``) started this process as a rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _mesh_for(mesh_cfg, dev):
    """(mesh, device, whether this call initialised the process group)
    of a rank that ``torchrun`` started: cuda:LOCAL_RANK over NCCL on the
    GPU, gloo with ``--device cpu``; the group is initialised from the
    launcher's environment unless it already is."""
    import torch
    import torch.distributed as dist

    from .parallel.mesh import make_mesh

    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    owns = not dist.is_initialized()
    if owns:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return make_mesh(mesh_cfg, dev), dev, owns


def cmd_train(args, tokenizer=None):
    """Stage-1 SFT: ``FusedDataset`` (training augmentations, each item's
    drawn from the run's seed, its epoch and its index) through
    ``DataLoader`` and ``loop.run_training``, on one card
    (``sft.make_trainer``), or, in a process that ``torchrun`` started, on
    the (data, fsdp, tensor) mesh of ``--mesh-data/--mesh-fsdp/
    --mesh-tensor`` over its ranks (``sft.make_sharded_trainer``; every rank
    reads its rows of the global batch of ``--batch-size`` x data x fsdp).
    A mesh of more than one device without a launcher raises. ``--qlora``
    trains on one card before any mesh, with the mesh's global batch, as
    the JAX CLI does. Returns the final state."""
    import torch

    from .config import MeshConfig, TrainConfig
    from .data.datasets import DataLoader, FusedDataset
    from .models.u2_model import U2CausalLM, resolve_device
    from .train.loop import MetricLogger, run_training
    from .train.sft import make_sharded_trainer, make_trainer

    mesh_cfg = MeshConfig(data=args.mesh_data, fsdp=args.mesh_fsdp,
                          tensor=args.mesh_tensor)
    qlora = args.qlora != "off"
    if qlora and _launched() and int(os.environ["WORLD_SIZE"]) > 1:
        raise ValueError("--qlora trains in one process on one card (the "
                         "JAX CLI's path before the mesh): run it without "
                         "torchrun")
    if not qlora and mesh_cfg.num_devices > 1 and not _launched():
        raise ValueError(
            f"a mesh of {mesh_cfg.num_devices} devices runs one process a "
            "device: start it with torchrun (python -m torch.distributed.run "
            f"--nproc-per-node {mesh_cfg.num_devices} -m u2tokenizer_torch.cli "
            "train ...)")
    dev = resolve_device(args.device)
    mesh, owns_group = None, False
    if _launched() and not qlora:
        mesh, dev, owns_group = _mesh_for(mesh_cfg, dev)
    cfg = _config_for(args, args.pretrained)
    tokenizer = tokenizer or _load_tokenizer(args.tokenizer)
    tcfg = TrainConfig(
        learning_rate=args.learning_rate, num_epochs=args.epochs,
        per_device_batch_size=args.batch_size, model_max_length=args.max_length,
        output_dir=args.output_dir, save_steps=args.save_steps,
        max_steps=args.max_steps,
        remat=(False if args.remat == "off" else
               True if args.remat == "nothing" else args.remat),
        ce_chunk=args.ce_chunk, mesh=mesh_cfg)

    ds = FusedDataset(
        args.train_base_path, args.train_jsonl_path, tokenizer,
        max_length=tcfg.model_max_length, image_tokens_num=cfg.proj_out_num,
        data_type="training", num_chunks=cfg.num_chunks,
        chunk_depth=cfg.vision.input_spatial[0],
        target_size=cfg.vision.input_spatial[1], device=dev,
        item_seed=tcfg.seed)
    global_batch = args.batch_size * mesh_cfg.data * mesh_cfg.fsdp
    loader = DataLoader(ds, batch_size=global_batch, seed=tcfg.seed,
                        num_workers=args.num_workers,
                        rows=mesh and mesh.batch_rows(global_batch))
    steps_per_epoch = len(loader)
    total = tcfg.max_steps or int(steps_per_epoch * tcfg.num_epochs)

    model = U2CausalLM(cfg, dtype=torch.bfloat16 if tcfg.bf16
                       else torch.float32, device=dev, seed=tcfg.seed,
                       remat=tcfg.remat)
    if args.pretrained:
        _load_pretrained_into(model, args.pretrained, cfg)
    if qlora:
        return _run_qlora_training(args, model, tcfg, loader, total,
                                   steps_per_epoch)
    trainable = None
    if args.freeze_vision_tower:
        trainable = lambda p: "vision_tower" not in p
    if mesh is None:
        state, train_step = make_trainer(model, tcfg, total, trainable)
    else:
        state, train_step, _ = make_sharded_trainer(
            model, tcfg, total, mesh, trainable, tcfg.ce_chunk)
    main = mesh is None or mesh.is_main
    logger = MetricLogger(tcfg.output_dir, use_wandb=args.wandb,
                          wandb_project=args.wandb_project) if main else None
    state = run_training(tcfg, state, train_step, lambda epoch: iter(loader),
                         steps_per_epoch=steps_per_epoch, logger=logger)
    if owns_group:
        import torch.distributed as dist

        dist.destroy_process_group()
    if main:
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
# eval / eval-predictions / quant-report
# ---------------------------------------------------------------------------

def _green_scorer(args, tokenizer=None):
    """The GREEN scorer of ``--judge`` (``_build_judge``, no summary), or
    None without one."""
    if args.judge is None:
        return None
    from .eval.green import GreenScorer

    return GreenScorer(_build_judge(args, tokenizer),
                       compute_summary_stats=False, judge_name=args.judge)


def cmd_eval(args, tokenizer=None, judge_tokenizer=None):
    """MRG / VQA evaluation (eval/mrg.py, eval/vqa.py parity): greedy
    reports of the first ``--max-cases`` cases, one at a time, scored
    with GREEN when ``--judge`` names a judge (MRG), or the first token
    against the answer choice (VQA). ``judge_tokenizer`` replaces the
    judge directory's tokenizer. Returns the ``EvalResult``."""
    from .config import GenerationConfig
    from .data.datasets import FusedDataset
    from .eval.evaluators import ReportGenerator, evaluate_mrg, evaluate_vqa
    from .models.generate import make_multimodal_generate_fn
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
    max_new = 1 if args.task == "vqa" else args.max_new_tokens
    gen = GenerationConfig(max_new_tokens=max_new, do_sample=False,
                           eos_token_id=tokenizer.eos_token_id,
                           pad_token_id=tokenizer.pad_token_id or 0)
    model = _init_or_load(args, cfg, dev)
    generator = ReportGenerator(model, tokenizer,
                                make_multimodal_generate_fn(model, gen),
                                pad_id=gen.pad_token_id,
                                eos_id=tokenizer.eos_token_id)
    if args.task == "vqa":
        result = evaluate_vqa(ds, generator, max_cases=args.max_cases)
    else:
        result = evaluate_mrg(ds, generator,
                              _green_scorer(args, judge_tokenizer),
                              max_cases=args.max_cases)
    with open(args.output, "w") as f:
        f.write(result.to_json())
    print(json.dumps(result.metrics))
    print(f"wrote {args.output}", file=sys.stderr)
    return result


def cmd_eval_m3d(args, tokenizer=None):
    """M3D-Bench tasks (eval/M3D-Bench/eval/eval_pos.py,
    eval_seg.py, eval_itr.py): rec (box IoU, acc@0.5), reg (box -> term
    NLG), seg and refseg (Dice through the '[SEG]' path; the config must
    enable the seg head), itr (retrieval recall@k). Greedy, one case at a
    time, over a bf16 cache. Without ``--checkpoint`` every parameter,
    the seg head's included, is drawn from seed 0. Returns the
    ``EvalResult``."""
    from .config import GenerationConfig
    from .data.m3d_datasets import (M3DITRDataset, M3DPosRECDataset,
                                    M3DPosREGDataset, M3DRefSegDataset,
                                    M3DSegDataset)
    from .eval.evaluators import ReportGenerator
    from .eval.m3d_bench import (evaluate_itr, evaluate_rec, evaluate_reg,
                                 evaluate_seg, make_u2_itr_encoders)
    from .models.generate import (make_multimodal_generate_fn,
                                  make_seg_generate_fn)
    from .models.u2_model import resolve_device

    dev = resolve_device(args.device)
    cfg = _config_for(args, args.checkpoint)
    if args.task in ("seg", "refseg") and not cfg.seg.enable:
        raise ValueError(f"--task {args.task} needs the segmentation head: "
                         "give a --config whose seg.enable is true")
    tokenizer = tokenizer or _load_tokenizer(args.tokenizer)
    dkw = dict(tokenizer=tokenizer, max_length=args.max_length,
               proj_out_num=cfg.proj_out_num, mode="test")
    if args.task == "rec":
        ds = M3DPosRECDataset(args.data_root, args.seg_data_path,
                              tag=args.tag, **dkw)
    elif args.task == "reg":
        ds = M3DPosREGDataset(args.data_root, args.seg_data_path,
                              tag=args.tag, **dkw)
    elif args.task == "seg":
        ds = M3DSegDataset(args.data_root, args.seg_data_path,
                           tag=args.tag, **dkw)
    elif args.task == "refseg":
        ds = M3DRefSegDataset(args.data_root, args.refseg_data_path, **dkw)
    else:
        ds = M3DITRDataset(args.data_root, args.cap_data_path, **dkw)

    gen = GenerationConfig(max_new_tokens=args.max_new_tokens,
                           do_sample=False,
                           eos_token_id=tokenizer.eos_token_id,
                           pad_token_id=tokenizer.pad_token_id or 0)
    model = _init_or_load(args, cfg, dev)
    if args.task in ("rec", "reg"):
        generator = ReportGenerator(model, tokenizer,
                                    make_multimodal_generate_fn(model, gen),
                                    pad_id=gen.pad_token_id,
                                    eos_id=tokenizer.eos_token_id)
        fn = evaluate_rec if args.task == "rec" else evaluate_reg
        result = fn(ds, generator, max_cases=args.max_cases)
    elif args.task in ("seg", "refseg"):
        seg_fn = make_seg_generate_fn(
            model, gen, tokenizer.convert_tokens_to_ids("[SEG]"))
        result = evaluate_seg(ds, seg_fn, tokenizer,
                              max_cases=args.max_cases,
                              pad_id=gen.pad_token_id,
                              eos_id=tokenizer.eos_token_id,
                              seg_image_size=cfg.seg.image_size, device=dev)
    else:
        enc_img, enc_txt = make_u2_itr_encoders(model)
        result = evaluate_itr(ds, enc_img, enc_txt, max_cases=args.max_cases)
    with open(args.output, "w") as f:
        f.write(result.to_json())
    print(json.dumps(result.metrics))
    print(f"wrote {args.output}", file=sys.stderr)
    return result


def cmd_eval_predictions(args, tokenizer=None):
    """Score an external predictions jsonl (any model's outputs) with the
    full metric battery: the generic replacement for the reference's
    per-model comparative scripts (evalscipt/m3d_*.py, radfm_*.py,
    CT-CHAT_ctrate.py). Runs on the host; only ``--judge`` takes the
    card. ``tokenizer`` is the judge's. Returns the ``EvalResult``."""
    from .data.datasets import load_jsonl
    from .eval.evaluators import evaluate_predictions

    result = evaluate_predictions(load_jsonl(args.predictions),
                                  _green_scorer(args, tokenizer),
                                  compute_bertscore=not args.no_bertscore)
    with open(args.output, "w") as f:
        f.write(result.to_json())
    print(json.dumps(result.metrics))
    print(f"wrote {args.output}", file=sys.stderr)
    return result


def _checkpoint_cfg_and_sd(hf_dir, num_chunks):
    """A released μ² HF checkpoint's config (``config.json`` through
    ``u2_config_from_hf``) and its raw state dict (safetensors shards, else
    pytorch_model.bin)."""
    from .eval.inference import load_state_dict
    from .models.hf_weights import u2_config_from_hf

    with open(os.path.join(hf_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    return (u2_config_from_hf(hf_cfg, num_chunks=num_chunks),
            load_state_dict(hf_dir))


def cmd_convert_checkpoint(args):
    """A released μ² HF checkpoint (μ²Qwen3-1.7B/8B, μ²Llama-3.2-1B
    layouts) converted to the framework's form, on the host: ``--output``
    gets ``u2_config.json`` (the config's JSON) and ``u2_params.msgpack``
    (the flax parameter tree in flax's msgpack form, as the JAX package's
    command writes it), which every command's ``--checkpoint`` and
    ``--pretrained`` read. Prints {params, source_tensors, output} as one
    JSON line and returns it."""
    from .eval.inference import CONVERTED_CONFIG, CONVERTED_PARAMS
    from .models.hf_weights import convert_u2_checkpoint
    from .train.checkpoint import save_params_msgpack
    from .weights import flatten

    cfg, sd = _checkpoint_cfg_and_sd(args.hf_dir, args.num_chunks)
    params = convert_u2_checkpoint(sd, cfg)
    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, CONVERTED_CONFIG), "w") as f:
        f.write(cfg.to_json())
    count = sum(int(leaf.size) for leaf in flatten(params).values())
    save_params_msgpack(os.path.join(args.output, CONVERTED_PARAMS), params)
    line = {"params": count, "source_tensors": len(sd),
            "output": args.output}
    print(json.dumps(line))
    return line


def cmd_quant_report(args):
    """Quantization-quality gate (``eval/quant_report.py``): per-layer
    weight round-trip SNR, teacher-forced logit agreement and optional
    greedy-decode agreement between the float model (fp32 parameters,
    bf16 compute) and its int8/int4 serving copies, with ``decide``'s
    verdict a mode. Without ``--checkpoint`` the model is random, drawn
    from seed 0 at the config's geometry, and the verdict is not
    decision grade; nor is it with ``--rehearsal``. Prints the report as
    one JSON line and returns it."""
    import torch

    from .eval.quant_report import (decide, forward_agreement,
                                    greedy_agreement, layer_quant_report,
                                    quantized_copy, synthetic_batches,
                                    trace_rss)
    from .models.u2_model import U2CausalLM, resolve_device

    dev = resolve_device(args.device)
    cfg = _config_for(args, args.checkpoint)
    batches = synthetic_batches(cfg, num_batches=args.num_batches,
                                seq_extra=args.seq_extra, device=dev)
    model = U2CausalLM(cfg, dtype=torch.bfloat16, device=dev, seed=0)
    if args.checkpoint:
        _load_pretrained_into(model, args.checkpoint, cfg)
    trace_rss("params loaded")
    report = {"checkpoint": args.checkpoint or "random-init"}
    decision_grade = bool(args.checkpoint) and not args.rehearsal
    for mode in args.modes.split(","):
        weights = layer_quant_report(model, mode)
        trace_rss(f"weights leg [{mode}]")
        if not args.per_layer:
            weights = {k: v for k, v in weights.items() if k != "layers"}
        entry = {"weights": weights}
        if not args.weights_only:
            qmodel = quantized_copy(model, mode)
            trace_rss(f"quantized copy [{mode}]")
            entry["forward"] = forward_agreement(model, batches, mode,
                                                 qmodel=qmodel)
            if args.greedy_tokens:
                entry["greedy"] = greedy_agreement(
                    model, batches[0], mode,
                    max_new_tokens=args.greedy_tokens, qmodel=qmodel)
                trace_rss(f"greedy leg [{mode}]")
            del qmodel
        entry["decision"] = decide(entry, mode,
                                   decision_grade=decision_grade)
        report[mode] = entry
    print(json.dumps(report))
    return report


# ---------------------------------------------------------------------------
# demo
# ---------------------------------------------------------------------------

def cmd_demo(args, tokenizer=None):
    """One CT volume to report text (src/demo/demo.py:29-91): the answer to
    ``--question``, or a REPL on stdin; with ``--attention`` the
    μ²tokenizer's first-layer attention maps drawn over the volume into a
    PNG first (the reference's demo_show.ipynb). The volume is a NIfTI
    file through the validation transform, or a preprocessed ``.npy``.
    Returns the answers it printed."""
    import numpy as np
    import torch

    from .config import GenerationConfig
    from .data.transforms import U2VolumeTransform
    from .eval.attention_viz import (capture_attention_maps,
                                     render_attention_png)
    from .models.generate import make_multimodal_generate_fn
    from .models.u2_model import resolve_device

    dev = resolve_device(args.device)
    cfg = _config_for(args, args.checkpoint)
    tokenizer = tokenizer or _load_tokenizer(args.tokenizer)
    if args.image.endswith(".npy"):
        image = np.load(args.image).astype(np.float32)
        if image.ndim == 4 and image.shape[0] == 1:  # one chunk, linear mode
            image = np.repeat(image, cfg.num_chunks, axis=0)
        image = torch.from_numpy(image).to(dev)
    else:
        image = U2VolumeTransform(
            data_type="validation", target_size=cfg.vision.input_spatial[1],
            chunk_depth=cfg.vision.input_spatial[0],
            num_chunks=cfg.num_chunks, device=dev)(args.image)
    gen = GenerationConfig(
        max_new_tokens=args.max_new_tokens, do_sample=args.do_sample,
        top_p=args.top_p, eos_token_id=tokenizer.eos_token_id,
        pad_token_id=tokenizer.pad_token_id or 0)
    model = _init_or_load(args, cfg, dev)
    gen_fn = make_multimodal_generate_fn(model, gen)
    generator = torch.Generator(dev).manual_seed(0)
    pad = gen.pad_token_id

    def encode(question: str):
        """(ids (1, max_length), question ids (1, 64), prompt length (1,))
        on the device: the image placeholders, then the question, in the
        tokenizer's chat template where it has one."""
        prompt = "<im_patch>" * cfg.proj_out_num + question
        if hasattr(tokenizer, "apply_chat_template"):
            prompt = tokenizer.apply_chat_template(
                [{"role": "user", "content": prompt}], tokenize=False,
                add_generation_prompt=True)
        ids = tokenizer(prompt, add_special_tokens=False)["input_ids"][
            :args.max_length]
        qids = tokenizer(question, add_special_tokens=False)["input_ids"][:64]
        row = lambda x, n: torch.tensor([x + [pad] * (n - len(x))],
                                        dtype=torch.long, device=dev)
        return (row(ids, args.max_length), row(qids, 64),
                torch.tensor([len(ids)], dtype=torch.int32, device=dev))

    def answer(question: str) -> str:
        ids, q, plen = encode(question)
        toks = gen_fn(ids, image[None], q, plen, generator)
        return tokenizer.decode([t for t in toks[0].tolist()
                                 if t not in (pad, tokenizer.eos_token_id)],
                                skip_special_tokens=True)

    if args.attention:
        _, q, _ = encode(args.question or "Describe the findings.")
        maps = capture_attention_maps(model, image[None], q)
        gp = cfg.projector.grid_post(cfg.vision.image_size,
                                     cfg.vision.patch_size)
        render_attention_png(maps, image, args.attention,
                             grid_hw=(gp[0], gp[1] * gp[2]))
        print(f"wrote {args.attention}", file=sys.stderr)
        if not args.question:
            return []
    if args.question:
        answers = [answer(args.question)]
        print(answers[0])
        return answers
    print("u2 demo — type a question (empty line to exit)", file=sys.stderr)
    answers = []
    while True:
        try:
            question = input("> ").strip()
        except EOFError:
            break
        if not question:
            break
        answers.append(answer(question))
        print(answers[-1])
    return answers


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
            "--tensor-parallel needs generation from parameters split over "
            "a tensor mesh, which the port does not have yet (parallel/ "
            "holds the training meshes only)")
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


# ---------------------------------------------------------------------------
# preprocess / selftest
# ---------------------------------------------------------------------------

def cmd_preprocess(args):
    """Offline bulk ingest: NIfTI volumes -> preprocessed (T, D, H, W)
    ``.npy`` files through ``data.preprocess.bulk_preprocess`` (host
    threads read and write, the ingest runs on ``--device``; reference
    counterpart: src/utils/ct_rate_reduction.py /
    abdomen_atlas_reduction.py). Exits 1 if any volume failed. Returns the
    results."""
    from .data.preprocess import bulk_preprocess

    paths = []
    for inp in args.inputs:
        if os.path.isdir(inp):
            for name in sorted(os.listdir(inp)):
                if name.endswith((".nii", ".nii.gz")):
                    paths.append(os.path.join(inp, name))
        else:
            paths.append(inp)
    results = bulk_preprocess(
        paths, target=args.target,
        chunk_depth=args.chunk_depth, num_chunks=args.num_chunks,
        num_workers=args.workers, out_dir=args.out_dir, device=args.device)
    failed = [(p, e) for p, _, e in results if e]
    print(f"preprocess: {len(results) - len(failed)}/{len(results)} volumes "
          f"-> {args.out_dir}")
    for p, e in failed:
        print(f"  FAILED {p}: {e}")
    if failed:
        raise SystemExit(1)
    return results


def cmd_selftest(args, tokenizer=None):
    """Tiny end-to-end pipeline on synthetic data (the JAX CLI's
    ``selftest``): two NIfTI volumes and a jsonl in a new temporary
    directory, then ``train --tiny`` for 2 steps, ``generate`` (2 cases x 2
    greedy samples of 8 tokens), ``green`` with the stub judge and
    ``dpo-convert``, each through this parser, so its defaults apply; every
    model stage runs on ``--device``. Returns the directory."""
    import tempfile

    import numpy as np

    from .data.nifti import write_nifti

    tmp = tempfile.mkdtemp(prefix="u2selftest_")
    rng = np.random.default_rng(0)
    for i in range(2):
        write_nifti(os.path.join(tmp, f"case{i}.nii.gz"),
                    rng.uniform(-1000, 400, (40, 48, 36)).astype(np.float32))
    with open(os.path.join(tmp, "train.jsonl"), "w") as f:
        for i in range(2):
            f.write(json.dumps({
                "image": f"case{i}.nii.gz",
                "question": "Please describe the findings",
                "answer": f"The study {i} shows clear lungs and a normal heart"
            }) + "\n")
    tokenizer = tokenizer or _load_tokenizer(args.tokenizer)
    model_args = ["--tiny", "--device", args.device]
    parser = build_parser()
    cmd_train(parser.parse_args([
        "train", *model_args, "--train-base-path", tmp,
        "--train-jsonl-path", "train.jsonl", "--learning-rate", "1e-4",
        "--epochs", "1", "--batch-size", "2", "--max-length", "64",
        "--output-dir", os.path.join(tmp, "out"), "--save-steps", "1000",
        "--max-steps", "2", "--num-workers", "1"]), tokenizer=tokenizer)
    cmd_generate(parser.parse_args([
        "generate", *model_args, "--base-path", tmp, "--jsonl-path",
        "train.jsonl", "--max-length", "64", "--max-new-tokens", "8",
        "--num-samples", "2", "--end", "2",
        "--output", os.path.join(tmp, "preds.jsonl")]),
        tokenizer=tokenizer)
    cmd_green(parser.parse_args([
        "green", "--predictions", os.path.join(tmp, "preds.jsonl"),
        "--no-summary", "--output", os.path.join(tmp, "greened.jsonl"),
        "--device", args.device]))
    cmd_dpo_convert(parser.parse_args([
        "dpo-convert", "--greened", os.path.join(tmp, "greened.jsonl"),
        "--output", os.path.join(tmp, "dpo.jsonl")]))
    print(f"selftest artifacts in {tmp}")
    print("SELFTEST OK")
    return tmp


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
    mesh_help = ("the {} dim of the (data, fsdp, tensor) mesh; a mesh of "
                 "more than one device runs one process a device under "
                 "torchrun (python -m torch.distributed.run "
                 "--nproc-per-node N -m u2tokenizer_torch.cli train ...)")
    t.add_argument("--mesh-data", type=int, default=1,
                   help=mesh_help.format("data (replicas)"))
    t.add_argument("--mesh-fsdp", type=int, default=1,
                   help=mesh_help.format("fsdp (parameters and AdamW state "
                                         "sharded)"))
    t.add_argument("--mesh-tensor", type=int, default=1,
                   help=mesh_help.format("tensor (the decoder's heads, MLP "
                                         "and vocabulary split)"))
    t.add_argument("--num-workers", type=int, default=4)
    t.add_argument("--freeze-vision-tower", action="store_true")
    t.add_argument("--remat", default="nothing",
                   choices=["nothing", "dots_no_batch", "dots", "off"],
                   help="gradient checkpointing of the decoder layers: "
                        "'nothing' recomputes everything; 'dots_no_batch' "
                        "keeps the weight matmul outputs, 'dots' every "
                        "matmul output (more activation memory, less "
                        "recompute); 'off' disables remat")
    t.add_argument("--ce-chunk", dest="ce_chunk", type=int, default=0,
                   help="> 0: compute the LM loss in sequence chunks of "
                        "this size, never materializing the (B, S, vocab) "
                        "logits; same numbers as the plain loss")
    t.add_argument("--pretrained", default=None)
    t.add_argument("--qlora", default="off", choices=["off", "int8", "int4"],
                   help="QLoRA: the decoder quantized and frozen, LoRA "
                        "adapters of --lora-rank on its projections")
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

    ev = sub.add_parser("eval")
    _add_common(ev)
    ev.add_argument("--task", choices=["mrg", "vqa"], default="mrg")
    ev.add_argument("--tokenizer", default=None)
    ev.add_argument("--base-path", dest="base_path", required=True)
    ev.add_argument("--jsonl-path", dest="jsonl_path", required=True)
    ev.add_argument("--checkpoint", default=None)
    ev.add_argument("--judge", default=None,
                    help="HF checkpoint dir of the GREEN judge (MRG)")
    ev.add_argument("--judge-weights", dest="judge_weights",
                    default="bf16", choices=["bf16", "int8"])
    ev.add_argument("--output", required=True)
    ev.add_argument("--max-length", type=int, default=1024)
    ev.add_argument("--max-new-tokens", type=int, default=768)
    ev.add_argument("--max-cases", type=int, default=100)
    _add_device(ev)
    ev.set_defaults(fn=cmd_eval)

    em = sub.add_parser("eval-m3d")
    _add_common(em)
    em.add_argument("--task", choices=["rec", "reg", "seg", "refseg", "itr"],
                    required=True)
    em.add_argument("--tokenizer", default=None)
    em.add_argument("--data-root", dest="data_root", required=True)
    em.add_argument("--seg-data-path", dest="seg_data_path", default=None)
    em.add_argument("--refseg-data-path", dest="refseg_data_path",
                    default=None)
    em.add_argument("--cap-data-path", dest="cap_data_path", default=None)
    em.add_argument("--tag", default="0000")
    em.add_argument("--checkpoint", default=None)
    em.add_argument("--output", required=True)
    em.add_argument("--max-length", type=int, default=512)
    em.add_argument("--max-new-tokens", type=int, default=256)
    em.add_argument("--max-cases", type=int, default=10**9)
    _add_device(em)
    em.set_defaults(fn=cmd_eval_m3d)

    qr = sub.add_parser("quant-report",
                        help="int8/int4 serving-quality gate: per-layer "
                             "SNR + logit/greedy agreement vs float")
    _add_common(qr)
    qr.add_argument("--checkpoint", default=None,
                    help="HF-layout μ² checkpoint directory; default "
                         "random-init at the config geometry")
    qr.add_argument("--modes", default="int8,int4",
                    help="comma-separated: int8, int4")
    qr.add_argument("--num-batches", type=int, default=2)
    qr.add_argument("--seq-extra", type=int, default=16,
                    help="text tokens past the image block per probe batch")
    qr.add_argument("--greedy-tokens", type=int, default=0,
                    help="also greedy-decode n tokens with both stacks")
    qr.add_argument("--weights-only", action="store_true",
                    help="skip the forward comparison")
    qr.add_argument("--per-layer", action="store_true",
                    help="include the per-layer SNR table")
    qr.add_argument("--rehearsal", action="store_true",
                    help="mark the checkpoint as fake/synthetic: the "
                         "go/no-go decision is computed but flagged "
                         "non-decision-grade")
    _add_device(qr)
    qr.set_defaults(fn=cmd_quant_report)

    ep = sub.add_parser("eval-predictions")
    ep.add_argument("--predictions", required=True)
    ep.add_argument("--output", required=True)
    ep.add_argument("--judge", default=None)
    ep.add_argument("--judge-weights", dest="judge_weights",
                    default="bf16", choices=["bf16", "int8"])
    ep.add_argument("--no-bertscore", action="store_true")
    _add_device(ep)
    ep.set_defaults(fn=cmd_eval_predictions)

    cc = sub.add_parser("convert-checkpoint",
                        help="released HF μ² checkpoint -> framework params")
    cc.add_argument("--hf-dir", dest="hf_dir", required=True)
    cc.add_argument("--output", required=True)
    cc.add_argument("--num-chunks", type=int, default=8)
    cc.set_defaults(fn=cmd_convert_checkpoint)

    dm = sub.add_parser("demo")
    _add_common(dm)
    dm.add_argument("--tokenizer", default=None)
    dm.add_argument("--image", required=True, help=".nii/.nii.gz/.npy volume")
    dm.add_argument("--checkpoint", default=None)
    dm.add_argument("--question", default=None, help="one-shot; omit for REPL")
    dm.add_argument("--max-length", type=int, default=1024)
    dm.add_argument("--max-new-tokens", type=int, default=256)
    dm.add_argument("--do-sample", action="store_true")
    dm.add_argument("--top-p", type=float, default=0.9)
    dm.add_argument("--attention", default=None, metavar="OUT_PNG",
                    help="draw the μ²tokenizer's attention maps into this "
                         "PNG (demo_show.ipynb's)")
    _add_device(dm)
    dm.set_defaults(fn=cmd_demo)

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

    st = sub.add_parser("selftest")
    st.add_argument("--tokenizer", default=None,
                    help="HF tokenizer dir; omit to use the built-in mock")
    _add_device(st)
    st.set_defaults(fn=cmd_selftest)

    pp = sub.add_parser(
        "preprocess",
        help="bulk NIfTI -> preprocessed .npy (host threads read and "
             "write, the ingest runs on --device)")
    pp.add_argument("inputs", nargs="+", help="NIfTI files or directories")
    pp.add_argument("--out-dir", dest="out_dir", required=True)
    pp.add_argument("--target", type=int, default=256)
    pp.add_argument("--chunk-depth", dest="chunk_depth", type=int, default=32)
    pp.add_argument("--num-chunks", dest="num_chunks", type=int, default=8)
    pp.add_argument("--workers", type=int, default=None)
    _add_device(pp)
    pp.set_defaults(fn=cmd_preprocess)
    return p


def main(argv=None):
    from .utils.errors import record

    args = build_parser().parse_args(argv)
    # a JSON crash report for every entry point (the reference wraps its
    # train mains with torch elastic's @record, train_stage1.py:30-31)
    return record(args.fn)(args)


if __name__ == "__main__":
    main()
