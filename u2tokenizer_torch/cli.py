"""Command-line entry points of the port (counterpart of
``u2tokenizer_tpu/cli.py``, whose other subcommands are not ported yet):

  python -m u2tokenizer_torch.cli serve --checkpoint DIR [--slots 8]
      HTTP report serving (``serve.py``: POST /v1/report, /v1/upload,
      OpenAI chat); ``--slots`` > 1 serves concurrent requests from one
      pool of decode slots (``models.slot_serving.EngineInference``)
  python -m u2tokenizer_torch.cli serve-llm [--model-dir DIR | --preset P]
      OpenAI-protocol serving of a bare decoder (``serve.TextLMServer``)

Both run on the GPU unless ``--device cpu`` is given. ``serve`` takes the
μ²tokenizer ablation flags of the JAX package's CLI (--attn-type,
--enable-diffts, --enable-dmtp, --no-multi-scale, --disable-u2tokenizer,
--top-k, --num-query-tokens) over ``--config`` (a ``U2ModelConfig`` JSON
file) or ``--tiny``; without either the checkpoint's own config is read.
A tokenizer is an HF tokenizer directory (``transformers`` is then
imported), or omitted (or ``mock``) for the whitespace ``MockTokenizer``.

``build_served_model`` and ``build_llm_server`` build what the two
subcommands serve from parsed arguments, so that a script can start
exactly what the CLI starts (``serve.serve_background``).
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
                   help="torch device to serve on (default: the GPU; "
                        "'cpu' runs the kernels' plain versions)")


def _load_model_config(args):
    from .config import U2ModelConfig

    if args.tiny:
        cfg = U2ModelConfig.tiny()
    elif args.config:
        with open(args.config) as f:
            cfg = U2ModelConfig.from_dict(json.load(f))
    else:
        cfg = U2ModelConfig()
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
