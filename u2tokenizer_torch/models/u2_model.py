"""μ²LLM, the full multimodal causal LM (counterpart of
``u2tokenizer_tpu/models/u2_model.py``).

3D ViT per depth chunk -> SPP projector -> μ²tokenizer (with the question
tokens' embeddings as text condition) -> image tokens spliced over prompt
rows [1, 1 + n_img) -> decoder.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import U2ModelConfig
from .layers import init_weights
from .llm.decoder import CausalLM
from .projector import build_projector
from .u2tok.u2tokenizer import U2Tokenizer
from .vit3d import ViT3DTower


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the GPU unless the caller names
    another. Raises when a CUDA device is asked for and none is present,
    rather than running somewhere the caller did not ask for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the GPU by "
            "default; pass device='cpu' to run the plain PyTorch versions "
            "of its kernels on the CPU")
    return dev


def resolve_model_device(model: nn.Module, device="cuda") -> torch.device:
    """``resolve_device(device)`` for an entry point handed a built model,
    which must lie there: raises when its parameters are elsewhere."""
    dev = resolve_device(device)
    have = next(model.parameters()).device
    if (have.type, have.index or 0) != (dev.type, dev.index or 0):
        raise ValueError(f"the model's parameters are on {have}, the entry "
                         f"point runs on {dev}: build the model there")
    return dev


def causal_padding_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, S) {0,1} -> bool (B, 1, S, S) causal mask without padded keys."""
    s = attention_mask.shape[1]
    causal = torch.ones(s, s, dtype=torch.bool,
                        device=attention_mask.device).tril()[None, None]
    return causal & attention_mask[:, None, None, :].bool()


class U2CausalLM(nn.Module):
    """The model, built on ``device`` (the GPU unless the caller passes
    another) with fp32 parameters drawn from ``seed``; every product runs
    in ``dtype``, as ``U2CausalLM(cfg, dtype)`` with ``model.init`` gives in
    the JAX package. Training updates the fp32 parameters; serving first
    casts the matrices to ``dtype`` with ``quantize.cast_for_inference``
    and may then quantize the decoder's weights in place with
    ``quantize.quantize_llm_weights`` (int8 or int4), or build the model
    with ``cfg.llm.quantized_weights`` set and load quantized weights.
    ``remat`` checkpoints each decoder layer (``DecoderModel``)."""

    def __init__(self, cfg: U2ModelConfig, dtype=torch.bfloat16,
                 device="cuda", seed: int = 0, remat=False):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.vision_tower = ViT3DTower(cfg.vision, dtype, device)
        self.mm_projector = build_projector(cfg.projector, cfg.vision,
                                            cfg.llm.hidden_size, dtype, device)
        if not cfg.u2t.enable:
            raise NotImplementedError("the port needs the μ²tokenizer enabled")
        self.u2tokenizer = U2Tokenizer(cfg.llm.hidden_size, cfg.u2t, dtype,
                                       device)
        self.llm = CausalLM(cfg.llm, dtype, device, remat)
        init_weights(self, seed)

    @property
    def device(self) -> torch.device:
        return self.llm.model.embed_tokens.device

    # --- vision ---

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """(N, 1, D, H, W) chunks -> (N, proj_out_num, llm_hidden)."""
        return self.mm_projector(self.vision_tower(images))

    def encode_vision(self, images: torch.Tensor,
                      question_ids: torch.Tensor) -> torch.Tensor:
        """(B, T, D, H, W) volume chunks -> (B, n_img, llm_hidden)."""
        b, t = images.shape[:2]
        feats = self.encode_images(images.reshape(b * t, 1, *images.shape[2:]))
        return self.fuse_vision(feats.reshape(b, t, *feats.shape[-2:]),
                                question_ids)

    def fuse_vision(self, v_tokens: torch.Tensor,
                    question_ids: torch.Tensor) -> torch.Tensor:
        """(B, T, N, E) per-chunk features -> (B, n_img, E) image tokens."""
        return self.u2tokenizer(v_tokens, self.llm.embed_tokens(question_ids))

    def splice_embeds(self, input_ids: torch.Tensor,
                      image_features: torch.Tensor) -> torch.Tensor:
        """Prompt embeddings with rows [1, 1 + n_img) overwritten by the
        image tokens, whatever the token ids there."""
        embeds = self.llm.embed_tokens(input_ids)
        img = image_features.to(embeds.dtype)
        n = img.shape[1]
        return torch.cat([embeds[:, :1], img, embeds[:, 1 + n:]], dim=1)

    def prepare_inputs_embeds(self, input_ids, images, question_ids):
        if images is None:
            return self.llm.embed_tokens(input_ids)
        return self.splice_embeds(input_ids,
                                  self.encode_vision(images, question_ids))

    # --- language model ---

    def forward(self, input_ids, images=None, question_ids=None,
                attention_mask=None, cache=None, write_index=None):
        embeds = self.prepare_inputs_embeds(input_ids, images, question_ids)
        return self.forward_embeds(embeds, attention_mask, cache, write_index)

    def forward_embeds(self, inputs_embeds, attention_mask=None, cache=None,
                       write_index=None, positions=None, mask=None, lens=None,
                       compute_logits: bool = True):
        b, s, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        if attention_mask is None and mask is None:
            attention_mask = torch.ones(b, s, dtype=torch.int32, device=dev)
        if mask is None:
            mask = causal_padding_mask(attention_mask)
            if lens is None:
                lens = attention_mask.sum(-1).to(torch.int32)
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=dev).expand(b, s)
        return self.llm(inputs_embeds, positions, mask, cache, write_index,
                        lens, compute_logits)

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.llm.embed_tokens(input_ids)

    def decode_step(self, token_embeds, positions, mask, cache, write_index,
                    decode_bounds=None, prefix_cache=None, prefix_mask=None,
                    compute_logits: bool = True):
        """One decode step: (B, 1, E) embeds against the whole cache, or a
        (B, S, E) block written per row; with ``prefix_cache`` against a
        case-shared prompt prefix plus the per-row suffix cache (fan-out
        decoding, ``generate.make_fanout_generate_fn``)."""
        return self.llm.decode_step(token_embeds, positions, mask, cache,
                                    write_index, decode_bounds, prefix_cache,
                                    prefix_mask, compute_logits)

    def lm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.llm.lm_logits(hidden)
