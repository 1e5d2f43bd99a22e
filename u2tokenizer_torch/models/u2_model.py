"""μ²LLM, the full multimodal causal LM (counterpart of
``u2tokenizer_tpu/models/u2_model.py``).

3D ViT per depth chunk -> projector (SPP, linear or none) -> μ²tokenizer
(with the question tokens' embeddings as text condition), or with
``cfg.u2t.enable`` off the chunks' tokens concatenated (the LinVT-style
baseline) -> image tokens spliced over prompt rows [1, 1 + n_img) ->
decoder. With ``cfg.seg.enable`` the model also holds the SegVol head
(``models/seg.py``) and its projector, read from the '[SEG]' token's
hidden state (``forward_seg``, ``segment``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import U2ModelConfig
from .layers import init_weights
from .llm.decoder import CausalLM
from .projector import build_projector
from .seg import SegProjector, SegVol3D
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
        if cfg.u2t.enable:
            self.u2tokenizer = U2Tokenizer(cfg.llm.hidden_size, cfg.u2t,
                                           dtype, device)
        self.llm = CausalLM(cfg.llm, dtype, device, remat)
        if cfg.seg.enable:
            # registered after the decoder, so that enabling the head
            # leaves every other parameter's seeded draw as it was
            self.seg_module = SegVol3D(cfg.seg, dtype, device)
            self.seg_projector = SegProjector(
                cfg.llm.hidden_size, cfg.seg.prompt_dim, dtype, device)
        init_weights(self, seed)

    @property
    def device(self) -> torch.device:
        return self.llm.model.embed_tokens.device

    # --- vision ---

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """(N, 1, D, H, W) chunks -> (N, tokens, llm_hidden): proj_out_num
        tokens through SPP, every patch token through 'linear' or
        'identity'."""
        feats = self.vision_tower(images)
        if self.mm_projector is not None:
            feats = self.mm_projector(feats)
        return feats

    def encode_vision(self, images: torch.Tensor,
                      question_ids: torch.Tensor) -> torch.Tensor:
        """(B, T, D, H, W) volume chunks -> (B, n_img, llm_hidden)."""
        b, t = images.shape[:2]
        feats = self.encode_images(images.reshape(b * t, 1, *images.shape[2:]))
        return self.fuse_vision(feats.reshape(b, t, *feats.shape[-2:]),
                                question_ids)

    def fuse_vision(self, v_tokens: torch.Tensor,
                    question_ids: torch.Tensor) -> torch.Tensor:
        """(B, T, N, E) per-chunk features -> (B, n_img, E) image tokens:
        the μ²tokenizer's, or without it the flat concat (B, T·N, E)."""
        if not self.cfg.u2t.enable:
            b, t, n, e = v_tokens.shape
            return v_tokens.reshape(b, t * n, e)
        return self.u2tokenizer(v_tokens, self.llm.embed_tokens(question_ids))

    def splice_embeds(self, input_ids: torch.Tensor,
                      image_features: torch.Tensor) -> torch.Tensor:
        """Prompt embeddings with rows [1, 1 + n_img) overwritten by the
        image tokens, whatever the token ids there. Raises when the prompt
        has fewer rows after its first than image tokens, where the JAX
        package's splice lengthens the sequence past the prompt."""
        embeds = self.llm.embed_tokens(input_ids)
        img = image_features.to(embeds.dtype)
        n = img.shape[1]
        if 1 + n > embeds.shape[1]:
            raise ValueError(
                f"{n} image tokens do not fit a prompt of "
                f"{embeds.shape[1]} tokens after its first: the image rows "
                f"[1, {1 + n}) must lie inside it (without the μ²tokenizer "
                f"each of the {self.cfg.num_chunks} chunks gives all its "
                "tokens; give the prompt that many rows, or fewer chunks)")
        return torch.cat([embeds[:, :1], img, embeds[:, 1 + n:]], dim=1)

    def prepare_inputs_embeds(self, input_ids, images, question_ids):
        if images is None:
            return self.llm.embed_tokens(input_ids)
        return self.splice_embeds(input_ids,
                                  self.encode_vision(images, question_ids))

    def encode_vision_with_attention(self, images: torch.Tensor,
                                     question_ids: torch.Tensor
                                     ) -> torch.Tensor:
        """``encode_vision`` with the μ²tokenizer's attention capture: the
        first SVR and TTA layers' maps are left on their modules' ``attn``
        (``eval/attention_viz.capture_attention_maps`` reads them); maps of
        an earlier capture are cleared first."""
        if not self.cfg.u2t.enable:
            raise ValueError("attention capture reads the μ²tokenizer's "
                             "maps; this model has none")
        for module in self.u2tokenizer.modules():
            if hasattr(module, "attn"):
                module.attn = None
        b, t = images.shape[:2]
        feats = self.encode_images(images.reshape(b * t, 1, *images.shape[2:]))
        return self.u2tokenizer(feats.reshape(b, t, *feats.shape[-2:]),
                                self.llm.embed_tokens(question_ids),
                                capture_attention=True)

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

    # --- segmentation ---

    def forward_seg(self, input_ids, images, question_ids, seg_image,
                    seg_positions, attention_mask=None):
        """LM forward and mask logits from the hidden state at
        ``seg_positions`` (B,), each row's '[SEG]' index: the joint
        training forward (LM cross-entropy + BCE/Dice). Returns (logits,
        masks (B, 1, D, H, W))."""
        logits, hidden, _ = self(input_ids, images, question_ids,
                                 attention_mask)
        seg_hidden = hidden.gather(1, seg_positions.long()[:, None, None]
                                   .expand(-1, 1, hidden.shape[-1]))[:, 0]
        return logits, self.segment(seg_image, seg_hidden)

    def segment(self, seg_image: torch.Tensor,
                seg_hidden: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, 1, D, H, W) volume + (B, llm_hidden) '[SEG]' hidden state,
        or None for no prompt -> (B, 1, D, H, W) mask logits
        (``generate(..., seg_enable=True)``, src/demo/demo.py:64)."""
        if not self.cfg.seg.enable:
            raise ValueError("this model has no segmentation head: build "
                             "it with cfg.seg.enable")
        prompt = None if seg_hidden is None else self.seg_projector(seg_hidden)
        return self.seg_module(seg_image, prompt)
