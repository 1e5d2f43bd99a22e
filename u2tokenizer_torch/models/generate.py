"""Autoregressive generation (counterpart of
``u2tokenizer_tpu/models/generate.py``): one-shot prefill of the
right-padded prompt, then a decode loop over the KV cache, greedy or, with
``GenerationConfig.do_sample``, top-p sampling from a ``torch.Generator``
(``ops.sampling``).

Per-row prompt lengths are handled with masks: decode token i lives at
cache slot S+i for every row, its RoPE position is the row's true
``prompt_len + i``, and attention sees keys j < prompt_len or
S <= j <= S+i (the two-interval mask). Rows that emitted EOS keep emitting
``pad_token_id``.

The model may hold float or weight-only quantized decoder weights
(``models.quantize.quantize_llm_weights``); the cache is float (bf16 by
default, as in the JAX package), int8 or packed int4 (``cache_dtype``), and
with int8 or int4 every decode step's attention runs through kernel K3 on
the GPU.

Not ported yet: chunked prefill and decode (``prefill_chunk``,
``decode_chunk``), shared-prefix prefill, fan-out and speculative
decoding.
"""

from __future__ import annotations

import torch

from ..config import GenerationConfig
from ..ops.sampling import sample
from .llm.decoder import KVCache
from .u2_model import U2CausalLM, causal_padding_mask


class Generate:
    """generate(inputs_embeds (B, S, E), prompt_len (B,), generator=None)
    -> (B, max_new) int64 tokens; sampled decoding draws from
    ``generator``, which it needs. The two stages are public so a caller
    can time them."""

    def __init__(self, model, gen: GenerationConfig,
                 cache_dtype=torch.bfloat16):
        self.model = model
        self.gen = gen
        self.cache_dtype = cache_dtype
        self.llm_cfg = model.cfg.llm if hasattr(model.cfg, "llm") else model.cfg

    def _sample(self, logits: torch.Tensor, generator) -> torch.Tensor:
        g = self.gen
        return sample(logits, do_sample=g.do_sample,
                      temperature=g.temperature, top_p=g.top_p,
                      generator=generator)

    @torch.inference_mode()
    def prefill_stage(self, inputs_embeds: torch.Tensor,
                      prompt_len: torch.Tensor, generator=None):
        """Prompt prefill through the first token. Returns (cache, tok0,
        done0, hidden), ``hidden`` the (B, S, E) final hidden states."""
        b, s, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        prompt_len = prompt_len.to(device=dev, dtype=torch.int32)
        cache = KVCache.create(self.llm_cfg, b, s + self.gen.max_new_tokens,
                               self.cache_dtype, dev)
        att = torch.arange(s, device=dev)[None, :] < prompt_len[:, None]
        positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
        _, hidden, cache = self.model.forward_embeds(
            inputs_embeds, cache=cache, write_index=0, positions=positions,
            mask=causal_padding_mask(att), lens=prompt_len,
            compute_logits=False)
        idx = (prompt_len.long() - 1)[:, None, None].expand(-1, 1,
                                                            hidden.shape[-1])
        last = self.model.lm_logits(hidden.gather(1, idx))[:, 0]
        tok0 = self._sample(last, generator)
        return cache, tok0, tok0 == self.gen.eos_token_id, hidden

    @torch.inference_mode()
    def decode_steps(self, cache: KVCache, tok0, done0, prompt_len,
                     steps: range, generator=None):
        """Run decode steps ``steps`` (a contiguous range of step indices)
        from the given state; returns (tok, done, (B, len(steps)) tokens).
        Step i embeds the previous token, writes its KV at slot S+i and
        emits token i+1 at RoPE position prompt_len+i."""
        g = self.gen
        b = tok0.shape[0]
        dev = tok0.device
        total = cache.max_len
        s = total - g.max_new_tokens
        prompt_len = prompt_len.to(device=dev, dtype=torch.int32)
        kv_pos = torch.arange(total, dtype=torch.int32, device=dev)
        in_prompt = kv_pos[None, :] < prompt_len[:, None]
        tok, done, out = tok0, done0, []
        for i in steps:
            emb = self.model.embed_tokens(tok[:, None])
            pos = (prompt_len + i)[:, None]
            key_ok = in_prompt | ((kv_pos >= s) & (kv_pos <= s + i))[None, :]
            end = torch.full((b,), s + i + 1, dtype=torch.int32, device=dev)
            logits, _, cache = self.model.decode_step(
                emb, pos, key_ok[:, None, None, :], cache, s + i,
                decode_bounds=(prompt_len, end, s))
            nxt = self._sample(logits[:, 0], generator)
            nxt = torch.where(done, torch.full_like(nxt, g.pad_token_id), nxt)
            done = done | (nxt == g.eos_token_id)
            tok = nxt
            out.append(nxt)
        tokens = (torch.stack(out, dim=1) if out
                  else torch.empty(b, 0, dtype=torch.int64, device=dev))
        return tok, done, tokens

    def __call__(self, inputs_embeds: torch.Tensor, prompt_len: torch.Tensor,
                 generator=None) -> torch.Tensor:
        cache, tok0, done0, _ = self.prefill_stage(inputs_embeds, prompt_len,
                                                   generator)
        _, _, rest = self.decode_steps(cache, tok0, done0, prompt_len,
                                       range(self.gen.max_new_tokens - 1),
                                       generator)
        return torch.cat([tok0[:, None], rest], dim=1)


def make_generate_fn(model, gen: GenerationConfig,
                     cache_dtype=torch.bfloat16) -> Generate:
    """generate(inputs_embeds, prompt_len) -> (B, max_new) int64 tokens.
    ``cache_dtype`` is a float torch dtype (bf16 by default, as in the JAX
    package; the decode then attends through plain PyTorch), or "int8" or
    "int4" (the quantized serving caches, each decoded by its form of
    kernel K3 on the GPU; ``bench.py`` of the JAX package serves int4)."""
    return Generate(model, gen, cache_dtype)


@torch.inference_mode()
def _microbatched_embeds(model: U2CausalLM, input_ids, images, question_ids,
                         vision_microbatch: int) -> torch.Tensor:
    """prepare_inputs_embeds with the per-chunk ViT encode run over groups
    of ``vision_microbatch`` chunks, bounding the tower's transient memory;
    the μ²tokenizer fuse and the splice run on the whole batch. As in the
    JAX package, a batch that is no larger than one group, or that the
    group size does not divide, is encoded in one call."""
    if images is None:
        return model.prepare_inputs_embeds(input_ids, None, question_ids)
    b, t = images.shape[:2]
    chunks = images.reshape(b * t, 1, *images.shape[2:])
    n = chunks.shape[0]
    if n <= vision_microbatch or n % vision_microbatch != 0:
        return model.prepare_inputs_embeds(input_ids, images, question_ids)
    feats = torch.cat([model.encode_images(group)
                       for group in chunks.split(vision_microbatch)])
    img = model.fuse_vision(feats.reshape(b, t, *feats.shape[-2:]),
                            question_ids)
    return model.splice_embeds(input_ids, img)


class MultimodalGenerate:
    """generate(input_ids (B, S), images (B, T, D, H, W), question_ids
    (B, Sq), prompt_len (B,), generator=None) -> (B, max_new) int64
    tokens: vision encode, μ²tokenizer fuse, splice, prefill, decode
    (sampled decoding draws from ``generator``). ``embeds``,
    ``prefill_stage`` and ``decode_steps`` are the stages, for timing."""

    def __init__(self, model: U2CausalLM, gen: GenerationConfig,
                 cache_dtype=torch.bfloat16, vision_microbatch: int = 128):
        self.model = model
        self.gen_fn = make_generate_fn(model, gen, cache_dtype)
        self.vision_microbatch = vision_microbatch
        self.prefill_stage = self.gen_fn.prefill_stage
        self.decode_steps = self.gen_fn.decode_steps

    def embeds(self, input_ids, images, question_ids) -> torch.Tensor:
        return _microbatched_embeds(self.model, input_ids, images,
                                    question_ids, self.vision_microbatch)

    def __call__(self, input_ids, images, question_ids, prompt_len,
                 generator=None) -> torch.Tensor:
        return self.gen_fn(self.embeds(input_ids, images, question_ids),
                           prompt_len, generator)


def make_multimodal_generate_fn(model: U2CausalLM, gen: GenerationConfig,
                                cache_dtype=torch.bfloat16,
                                vision_microbatch: int = 128,
                                ) -> MultimodalGenerate:
    """generate(input_ids, images, question_ids, prompt_len,
    generator=None) -> (B, max_new) int64 tokens, on the model's device;
    ``cache_dtype`` as for ``make_generate_fn``."""
    return MultimodalGenerate(model, gen, cache_dtype, vision_microbatch)
