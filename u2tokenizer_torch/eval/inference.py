"""Report generation from a checkpoint directory (counterpart of
``u2tokenizer_tpu/eval/inference.py``): ``U2InferenceModel``, the answer
validity filter, ``AnswerValidator`` and the GREEN chat format.

    from u2tokenizer_torch.data.transforms import U2VolumeTransform
    from u2tokenizer_torch.eval.inference import U2InferenceModel

    model = U2InferenceModel("ckpt/", tokenizer=tok)
    volume = U2VolumeTransform()("ct.nii.gz")     # (8, 32, 256, 256)
    print(model.inference(volume, "Describe the findings."))

The directory holds an HF-layout μ² checkpoint (``model.safetensors``
shards, else ``pytorch_model.bin``) with ``u2_tpu_config.json`` or a
``config.json`` (``hf_weights.u2_config_from_hf``). Weights are converted
leaf by leaf into a model built on the device, then served with the
matrices cast to the compute ``dtype`` ("bf16"), or cast to bf16 and the
decoder's quantized ("int8", "int4", ``models.quantize``); the KV cache is
bf16, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..config import GenerationConfig, U2ModelConfig
from ..models.generate import make_multimodal_generate_fn
from ..models.hf_weights import (convert_u2_checkpoint, load_safetensors_dir,
                                 load_torch_bin, u2_config_from_hf)
from ..models.quantize import (cast_for_inference, quantize_llm_weights,
                               quantized_llm_config)
from ..models.speculative import make_spec_multimodal_generate_fn
from ..models.u2_model import U2CausalLM, resolve_device
from ..train.lora import load_lora_dir, merge_lora
from ..weights import flatten, load_flax_params

WEIGHTS = ("bf16", "int8", "int4")
# ``cli convert-checkpoint``'s directory: the config's JSON and the flax
# parameter tree in flax's msgpack form
CONVERTED_CONFIG, CONVERTED_PARAMS = "u2_config.json", "u2_params.msgpack"


def check_character_and_length(text: str, min_len: int = 20) -> bool:
    """Validity filter of pred_then_green.py:97-103: reject CJK output and
    generations shorter than ``min_len``."""
    if len(text) < min_len:
        return False
    return not any("一" <= ch <= "鿿" for ch in text)


def load_model_config(checkpoint_path: str) -> U2ModelConfig:
    """``u2_tpu_config.json`` where the directory has one, or
    ``u2_config.json`` (``cli convert-checkpoint``'s), else the μ² config
    that ``config.json`` describes."""
    for name in ("u2_tpu_config.json", CONVERTED_CONFIG):
        path = os.path.join(checkpoint_path, name)
        if os.path.exists(path):
            with open(path) as f:
                return U2ModelConfig.from_json(f.read())
    with open(os.path.join(checkpoint_path, "config.json")) as f:
        return u2_config_from_hf(json.load(f))


def load_state_dict(checkpoint_path: str):
    """The checkpoint's tensors: its .safetensors shards where it has any,
    else ``pytorch_model.bin`` (or the .bin file the path names)."""
    if os.path.isdir(checkpoint_path) and any(
            f.endswith(".safetensors") for f in os.listdir(checkpoint_path)):
        return load_safetensors_dir(checkpoint_path)
    bin_path = (checkpoint_path if checkpoint_path.endswith(".bin")
                else os.path.join(checkpoint_path, "pytorch_model.bin"))
    return load_torch_bin(bin_path)


class U2InferenceModel:
    """Checkpoint directory -> ``inference(volume, question)`` -> report
    text, on ``device`` (the GPU unless the caller names another).

    ``tokenizer`` is an HF-style tokenizer (``__call__``, ``decode``,
    ``eos_token_id``, ``pad_token_id``); without one the directory's is
    loaded with ``transformers``, which must then be installed. Sampling
    (``do_sample``, ``top_p``) draws from a generator seeded with ``seed``.
    ``speculative`` (None: as ``do_sample``, the JAX package's default)
    decodes with n-gram drafts (``models.speculative``): the same tokens
    when greedy, the same distribution when sampling; ``spec_stats``
    counts its emitted tokens (after the first, which the prefill gives)
    and verify steps, so that their ratio is the mean acceptance.
    ``lora_path`` names an adapter directory (``adapter.msgpack``,
    ``adapter_config.json``; ``train.lora.save_lora_dir``) whose adapters
    are folded into the checkpoint's fp32 weights on the host, kernel +
    (alpha/r) A @ B, before the bf16 cast or the quantization, as in the
    JAX package."""

    def __init__(self, checkpoint_path: str, tokenizer=None,
                 model_config: Optional[U2ModelConfig] = None,
                 dtype=torch.bfloat16, max_length: int = 1024,
                 max_new_tokens: int = 768, do_sample: bool = True,
                 top_p: float = 0.9, lora_path: Optional[str] = None,
                 seed: int = 0, speculative: Optional[bool] = None,
                 weights: str = "bf16", device="cuda"):
        if speculative is None:
            speculative = bool(do_sample)
        if weights not in WEIGHTS:
            raise ValueError(f"weights must be one of {WEIGHTS}, got "
                             f"{weights!r}")
        self.device = resolve_device(device)
        self.cfg = model_config or load_model_config(checkpoint_path)
        if tokenizer is None:
            try:
                from transformers import AutoTokenizer
            except ImportError as e:
                raise ImportError(
                    "U2InferenceModel needs a tokenizer: pass tokenizer=, or "
                    "install transformers to load the checkpoint's") from e
            tokenizer = AutoTokenizer.from_pretrained(checkpoint_path)
        self.tokenizer = tokenizer

        model = U2CausalLM(self.cfg, dtype=dtype, device=self.device,
                           seed=seed)
        params = convert_u2_checkpoint(load_state_dict(checkpoint_path),
                                       self.cfg)
        if lora_path is not None:
            params = self._merge_lora(params, lora_path)
        load_flax_params(model, flatten(params))
        # as the JAX package: "bf16" computes in ``dtype``; int8 and int4
        # quantize the bf16-cast weights
        cast_for_inference(model, dtype if weights == "bf16"
                           else torch.bfloat16)
        if weights != "bf16":
            quantize_llm_weights(model, weights)
            self.cfg = quantized_llm_config(self.cfg, weights)
        self.model = model
        self.weights = weights
        self.max_length = max_length
        self.gen_cfg = GenerationConfig(
            max_new_tokens=max_new_tokens, do_sample=do_sample, top_p=top_p,
            eos_token_id=tokenizer.eos_token_id,
            pad_token_id=tokenizer.pad_token_id or 0)
        self._speculative = speculative
        if speculative:
            self._gen_fn = make_spec_multimodal_generate_fn(
                model, self.gen_cfg, return_stats=True)
        else:
            self._gen_fn = make_multimodal_generate_fn(model, self.gen_cfg)
        self._generator = torch.Generator(self.device).manual_seed(seed)
        self.spec_stats = {"emitted_tokens": 0, "verify_steps": 0}

    @staticmethod
    def _merge_lora(params, lora_path: str):
        """``params`` (the converted fp32 tree) with the adapters of
        ``lora_path`` folded in (``train.lora.merge_lora``)."""
        lora, lcfg = load_lora_dir(lora_path)
        return merge_lora(params, lora, lcfg)

    def _encode_prompt(self, question: str, with_image: bool = True):
        """(ids padded to ``max_length``, question ids padded to 64, the
        prompt's length): ``proj_out_num`` <im_patch> tokens, then the
        question."""
        n_img = self.cfg.proj_out_num
        prompt = ("<im_patch>" * n_img + question) if with_image else question
        ids = self.tokenizer(prompt, add_special_tokens=False)["input_ids"]
        ids = ids[: self.max_length]
        out = np.full(self.max_length, self.gen_cfg.pad_token_id, np.int64)
        out[: len(ids)] = ids
        q = self.tokenizer(question,
                           add_special_tokens=False)["input_ids"][:64]
        qids = np.full(64, self.gen_cfg.pad_token_id, np.int64)
        qids[: len(q)] = q
        return out, qids, len(ids)

    def generate_tokens(self, image, question: str) -> torch.Tensor:
        """The (max_new_tokens,) int64 tokens of one report: ``image`` a
        preprocessed (T, D, H, W) volume (``U2VolumeTransform``), or None
        for the text-only path."""
        images = None
        if image is not None:
            images = torch.as_tensor(image).to(self.device, torch.float32)
            expected = (self.cfg.num_chunks, *self.cfg.vision.input_spatial)
            if tuple(images.shape) != expected:
                raise ValueError(
                    f"volume shape {tuple(images.shape)} does not match the "
                    f"model's chunk geometry {expected}; preprocess with "
                    "data.transforms.U2VolumeTransform")
            images = images[None]
        ids, qids, plen = self._encode_prompt(question, image is not None)
        dev = self.device
        tokens = self._gen_fn(torch.from_numpy(ids[None]).to(dev), images,
                              torch.from_numpy(qids[None]).to(dev),
                              torch.tensor([plen], dtype=torch.int32,
                                           device=dev),
                              self._generator)
        if self._speculative:
            tokens, steps = tokens
            eos = (tokens[0] == self.tokenizer.eos_token_id).nonzero()
            emitted = int(eos[0, 0]) + 1 if len(eos) else tokens.shape[1]
            self.spec_stats["emitted_tokens"] += max(emitted - 1, 0)
            self.spec_stats["verify_steps"] += steps
        return tokens[0]

    def inference(self, image, question: str) -> str:
        """Preprocessed (T, D, H, W) volume (or None) + question -> report
        text (lu2_model.py:52-66 protocol)."""
        skip = (self.gen_cfg.pad_token_id, self.tokenizer.eos_token_id)
        ids = [t for t in self.generate_tokens(image, question).tolist()
               if t not in skip]
        return self.tokenizer.decode(ids, skip_special_tokens=True).strip()

    def sample_valid(self, image, question: str, attempts: int = 5) -> str:
        """Resample until the validity filter passes (pred_then_green.py
        :77-82)."""
        text = ""
        for _ in range(attempts):
            text = self.inference(image, question)
            if check_character_and_length(text):
                return text
        return text


class AnswerValidator:
    """LLM yes/no check that a generated answer addresses the question
    (answer_validator.py:8-53)."""

    PROMPT = (
        "You are verifying a VQA system's output. Question: {question}\n"
        "Generated answer: {answer}\n"
        "Is this a plausible, on-topic answer to the question? "
        "Reply with only YES or NO.")

    def __init__(self, backend: Callable[[str], str]):
        self.backend = backend

    def __call__(self, question: str, answer: str) -> bool:
        out = self.backend(self.PROMPT.format(question=question,
                                              answer=answer))
        return out.strip().upper().startswith("YES")


def green_chat_format(prompt: str, eos_token: str = "</s>") -> str:
    """The GREEN judge chat rendering (green.py:59 custom template): a human
    turn, an empty assistant turn, then the generation prompt."""
    return (f"\n<|user|>\n{prompt}{eos_token}\n\n<|assistant|>\n{eos_token}\n"
            f"\n<|assistant|>")
