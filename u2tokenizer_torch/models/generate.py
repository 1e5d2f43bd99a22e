"""Autoregressive generation (counterpart of
``u2tokenizer_tpu/models/generate.py``): prefill of the right-padded
prompt, then a decode loop over the KV cache, greedy or, with
``GenerationConfig.do_sample``, top-p sampling from a ``torch.Generator``
(``ops.sampling``).

Per-row prompt lengths are handled with masks: decode token i lives at
cache slot S+i for every row, its RoPE position is the row's true
``prompt_len + i``, and attention sees keys j < prompt_len or
S <= j <= S+i (the two-interval mask). Rows that emitted EOS keep emitting
``pad_token_id``.

The prefill runs in one shot (kernel K2 on the GPU), in chunks
(``prefill_chunk``: each chunk written per row and attending the cache
under a causal mask, plain attention as in the JAX package), or in two
phases for rows that share a prompt prefix (``shared_prefix``: the prefix
once a group through K2, then each row's continuation as one per-row
block). ``make_fanout_generate_fn`` prefills once a case and decodes n
sample rows against the case's shared prompt cache
(``ops.attention.gqa_sdpa_fanout``). ``make_seg_generate_fn`` adds the
segmentation path: the hidden state of the first generated '[SEG]' token,
from one teacher-forced re-run, prompts the SegVol head. Speculative
decoding is in ``models.speculative``.

The model may hold float or weight-only quantized decoder weights
(``models.quantize.quantize_llm_weights``); the cache is float (bf16 by
default, as in the JAX package), int8 or packed int4 (``cache_dtype``), and
with int8 or int4 every decode step's attention runs through kernel K3 on
the GPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import GenerationConfig
from ..ops.sampling import sample
from .llm.decoder import KVCache
from .u2_model import U2CausalLM, causal_padding_mask


def llm_config(model):
    """The decoder's ``LLMConfig`` of a ``U2CausalLM`` or a bare
    ``CausalLM``."""
    return model.cfg.llm if hasattr(model.cfg, "llm") else model.cfg


def _at(hidden: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, S, E) hidden states -> (B, 1, E) at position idx[b] of row b."""
    return hidden.gather(1, idx.long()[:, None, None].expand(
        -1, 1, hidden.shape[-1]))


def sample_tokens(gen: GenerationConfig, logits: torch.Tensor,
                  generator=None) -> torch.Tensor:
    """(B, V) logits -> (B,) tokens as ``gen`` decodes: the argmax, or a
    top-p draw at its temperature from ``generator``."""
    return sample(logits, do_sample=gen.do_sample,
                  temperature=gen.temperature, top_p=gen.top_p,
                  generator=generator)


def prefill_group_prefix(model, inputs_embeds: torch.Tensor, n: int,
                         split: int, cache: KVCache) -> KVCache:
    """The first ``split`` tokens of one row a group of n (rows 0, n,
    2n, ...; all valid, a causal mask) into ``cache`` (B/n rows) through
    K2 with ``lens``."""
    c = inputs_embeds.shape[0] // n
    dev = inputs_embeds.device
    model.forward_embeds(
        inputs_embeds[::n, :split], cache=cache, write_index=0,
        positions=torch.arange(split, dtype=torch.int32,
                               device=dev).expand(c, split),
        mask=torch.ones(split, split, dtype=torch.bool,
                        device=dev).tril()[None, None],
        lens=torch.full((c,), split, dtype=torch.int32, device=dev),
        compute_logits=False)
    return cache


def prefill_chunks(model, embeds: torch.Tensor, cache: KVCache, chunk: int,
                   pos0: int = 0, prefix_cache: Optional[KVCache] = None,
                   prefix_mask=None):
    """``embeds`` (B, S2, E) through the decoder in chunks of ``chunk``
    tokens, chunk [t, t + chunk) written per row at cache slots
    [t, t + chunk) with RoPE positions pos0 + slot, each query attending
    the cache's slots up to its own (and, with ``prefix_cache``, the
    case-shared prefix under ``prefix_mask``). Causal masking alone is
    exact because prompts are right-padded: a real query lies below every
    pad slot, and pad keys are masked at decode time. Returns the (B, S2,
    E) hidden states and the cache."""
    b, s2, _ = embeds.shape
    dev = embeds.device
    kvp = torch.arange(cache.max_len, device=dev)
    hidden = []
    for base in range(0, s2, chunk):
        q_idx = base + torch.arange(chunk, device=dev)
        mask = (kvp[None, :] <= q_idx[:, None])[None, None]
        pos = (pos0 + q_idx).to(torch.int32).expand(b, chunk)
        widx = torch.full((b,), base, dtype=torch.int32, device=dev)
        _, h, cache = model.decode_step(
            embeds[:, base:base + chunk], pos, mask, cache, widx,
            prefix_cache=prefix_cache, prefix_mask=prefix_mask,
            compute_logits=False)
        hidden.append(h)
    return torch.cat(hidden, dim=1), cache


def shared_prefix_prefill(model, inputs_embeds: torch.Tensor,
                          prompt_len: torch.Tensor, cache: KVCache, n: int,
                          split: int):
    """Two-phase prefill for rows grouped n a case whose first ``split``
    prompt tokens are the same within each group (row c*n + j shares
    [0, split) with its group): phase 1 prefills one prefix row a group
    (batch B/n, through K2 with ``lens``), the prefix KV is tiled to every
    row, and phase 2 writes each row's continuation [split, S) as one
    per-row block that attends the cache. The cache and the last
    position's hidden states are the one-shot prefill's for float caches;
    a quantized cache holds the same quantized prefix. Needs
    split < prompt_len for every row. Returns (last hidden (B, 1, E) at
    prompt_len - 1, cache)."""
    b, s, _ = inputs_embeds.shape
    c = b // n
    dev = inputs_embeds.device
    bufs = lambda xs: [x[:c, :, :split] for x in xs] if xs else None
    head = KVCache(*(None if x is None else [torch.zeros_like(t) for t in x]
                     for x in (bufs(cache.k), bufs(cache.v),
                               bufs(cache.k_scale), bufs(cache.v_scale))))
    prefill_group_prefix(model, inputs_embeds, n, split, head)
    for full, part in zip(cache.k + cache.v + (cache.k_scale or [])
                          + (cache.v_scale or []),
                          head.k + head.v + (head.k_scale or [])
                          + (head.v_scale or [])):
        full[:, :, :split] = part.repeat_interleave(n, dim=0)

    s2 = s - split
    kvp = torch.arange(cache.max_len, device=dev)
    q_idx = split + torch.arange(s2, device=dev)
    _, hidden, cache = model.forward_embeds(
        inputs_embeds[:, split:], cache=cache,
        write_index=torch.full((b,), split, dtype=torch.int32, device=dev),
        positions=q_idx.to(torch.int32).expand(b, s2),
        mask=(kvp[None, :] <= q_idx[:, None])[None, None],
        compute_logits=False)
    return _at(hidden, prompt_len - 1 - split), cache


def prefill(model, inputs_embeds: torch.Tensor, prompt_len: torch.Tensor,
            cache: KVCache, prefill_chunk: Optional[int] = None,
            shared_prefix: Optional[tuple] = None):
    """The prompt into ``cache`` at slots [0, S): two-phase with
    ``shared_prefix`` (n, split), in chunks when ``prefill_chunk`` is
    below S and divides it, else in one shot through K2. Returns (last
    hidden (B, 1, E) at prompt_len - 1, cache)."""
    b, s, _ = inputs_embeds.shape
    if shared_prefix is not None:
        return shared_prefix_prefill(model, inputs_embeds, prompt_len, cache,
                                     *shared_prefix)
    if prefill_chunk and prefill_chunk < s and s % prefill_chunk == 0:
        hidden, cache = prefill_chunks(model, inputs_embeds, cache,
                                       prefill_chunk)
    else:
        dev = inputs_embeds.device
        att = torch.arange(s, device=dev)[None, :] < prompt_len[:, None]
        positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
        _, hidden, cache = model.forward_embeds(
            inputs_embeds, cache=cache, write_index=0, positions=positions,
            mask=causal_padding_mask(att), lens=prompt_len,
            compute_logits=False)
    return _at(hidden, prompt_len - 1), cache


class Generate:
    """generate(inputs_embeds (B, S, E), prompt_len (B,), generator=None)
    -> (B, max_new) int64 tokens; sampled decoding draws from
    ``generator``, which it needs. The two stages are public so a caller
    can time them. ``prefill_chunk`` and ``shared_prefix`` choose the
    prefill (``prefill``); ``decode_chunk`` runs the decode as ranges of at
    most that many steps, with the same tokens: the JAX package splits its
    decode into several programs so that none outlasts a TPU host's limit,
    while the eager ``decode_steps`` takes any range."""

    def __init__(self, model, gen: GenerationConfig,
                 cache_dtype=torch.bfloat16, prefill_chunk: Optional[int] = None,
                 shared_prefix: Optional[tuple] = None,
                 decode_chunk: Optional[int] = None):
        self.model = model
        self.gen = gen
        self.cache_dtype = cache_dtype
        self.prefill_chunk = prefill_chunk
        self.shared_prefix = shared_prefix
        self.decode_chunk = decode_chunk
        self.llm_cfg = llm_config(model)

    @torch.inference_mode()
    def prefill_stage(self, inputs_embeds: torch.Tensor,
                      prompt_len: torch.Tensor, generator=None):
        """Prompt prefill through the first token. Returns (cache, tok0,
        done0, last), ``last`` the (B, 1, E) final hidden state at each
        row's last prompt position."""
        b, s, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        prompt_len = prompt_len.to(device=dev, dtype=torch.int32)
        cache = KVCache.create(self.llm_cfg, b, s + self.gen.max_new_tokens,
                               self.cache_dtype, dev)
        last_hidden, cache = prefill(self.model, inputs_embeds, prompt_len,
                                     cache, self.prefill_chunk,
                                     self.shared_prefix)
        tok0 = sample_tokens(self.gen, self.model.lm_logits(last_hidden)[:, 0],
                             generator)
        return cache, tok0, tok0 == self.gen.eos_token_id, last_hidden
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
            nxt = sample_tokens(g, logits[:, 0], generator)
            nxt = torch.where(done, torch.full_like(nxt, g.pad_token_id), nxt)
            done = done | (nxt == g.eos_token_id)
            tok = nxt
            out.append(nxt)
        tokens = (torch.stack(out, dim=1) if out
                  else torch.empty(b, 0, dtype=torch.int64, device=dev))
        return tok, done, tokens

    def __call__(self, inputs_embeds: torch.Tensor, prompt_len: torch.Tensor,
                 generator=None) -> torch.Tensor:
        cache, tok, done, _ = self.prefill_stage(inputs_embeds, prompt_len,
                                                 generator)
        parts = [tok[:, None]]
        steps = self.gen.max_new_tokens - 1
        chunk = self.decode_chunk or max(steps, 1)
        for i in range(0, steps, chunk):
            tok, done, rest = self.decode_steps(
                cache, tok, done, prompt_len, range(i, min(i + chunk, steps)),
                generator)
            parts.append(rest)
        return torch.cat(parts, dim=1)


def make_generate_fn(model, gen: GenerationConfig,
                     cache_dtype=torch.bfloat16,
                     prefill_chunk: Optional[int] = None,
                     shared_prefix: Optional[tuple] = None,
                     decode_chunk: Optional[int] = None) -> Generate:
    """generate(inputs_embeds, prompt_len) -> (B, max_new) int64 tokens.
    ``cache_dtype`` is a float torch dtype (bf16 by default, as in the JAX
    package; the decode then attends through plain PyTorch), or "int8" or
    "int4" (the quantized serving caches, each decoded by its form of
    kernel K3 on the GPU; ``bench.py`` of the JAX package serves int4).
    ``prefill_chunk`` (a divisor of S below it), ``shared_prefix``
    ((n, split), ahead of ``prefill_chunk``) and ``decode_chunk`` as for
    ``Generate``."""
    return Generate(model, gen, cache_dtype, prefill_chunk, shared_prefix,
                    decode_chunk)


class FanoutGenerate:
    """generate(inputs_embeds (C, S, E), prompt_len (C,), generator=None)
    -> (C * n_samples, max_new) int64 tokens, row c*n + j sample j of case
    c: the prompt prefilled once a case (K2 at batch C) into a prefix
    cache, then every sample row decoded against [the case's prefix ; its
    own suffix cache] with one softmax (``gqa_sdpa_fanout``), the same
    tokens as decoding the prompt tiled n times. The suffix cache holds
    generated token i at slot i."""

    def __init__(self, model, gen: GenerationConfig, n_samples: int,
                 cache_dtype=torch.bfloat16):
        self.model = model
        self.gen = gen
        self.n = n_samples
        self.cache_dtype = cache_dtype
        self.llm_cfg = llm_config(model)

    @torch.inference_mode()
    def __call__(self, inputs_embeds: torch.Tensor, prompt_len: torch.Tensor,
                 generator=None) -> torch.Tensor:
        g, n, model = self.gen, self.n, self.model
        c, s, _ = inputs_embeds.shape
        b = c * n
        dev = inputs_embeds.device
        prompt_len = prompt_len.to(device=dev, dtype=torch.int32)
        prefix = KVCache.create(self.llm_cfg, c, s, self.cache_dtype, dev)
        last, prefix = prefill(model, inputs_embeds, prompt_len, prefix)
        last = model.lm_logits(last)[:, 0].repeat_interleave(n, dim=0)
        plen = prompt_len.repeat_interleave(n, dim=0)
        att = torch.arange(s, device=dev)[None, :] < prompt_len[:, None]
        tok = sample_tokens(g, last, generator)
        done = tok == g.eos_token_id
        suffix = KVCache.create(self.llm_cfg, b, g.max_new_tokens,
                                self.cache_dtype, dev)
        suf_pos = torch.arange(g.max_new_tokens, device=dev)
        out = [tok]
        for i in range(g.max_new_tokens - 1):
            emb = model.embed_tokens(tok[:, None])
            logits, _, suffix = model.decode_step(
                emb, (plen + i)[:, None], (suf_pos <= i)[None, None, None, :],
                suffix, i, prefix_cache=prefix, prefix_mask=att)
            nxt = sample_tokens(g, logits[:, 0], generator)
            nxt = torch.where(done, torch.full_like(nxt, g.pad_token_id), nxt)
            done = done | (nxt == g.eos_token_id)
            tok = nxt
            out.append(nxt)
        return torch.stack(out, dim=1)


def make_fanout_generate_fn(model, gen: GenerationConfig, n_samples: int,
                            cache_dtype=torch.bfloat16) -> FanoutGenerate:
    """generate(inputs_embeds (C, S, E), prompt_len (C,), generator=None)
    -> (C * n_samples, max_new) tokens (``FanoutGenerate``)."""
    return FanoutGenerate(model, gen, n_samples, cache_dtype)


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
                 cache_dtype=torch.bfloat16, vision_microbatch: int = 128,
                 prefill_chunk: Optional[int] = None,
                 decode_chunk: Optional[int] = None):
        self.model = model
        self.gen_fn = make_generate_fn(model, gen, cache_dtype, prefill_chunk,
                                       decode_chunk=decode_chunk)
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
                                prefill_chunk: Optional[int] = None,
                                decode_chunk: Optional[int] = None,
                                ) -> MultimodalGenerate:
    """generate(input_ids, images, question_ids, prompt_len,
    generator=None) -> (B, max_new) int64 tokens, on the model's device;
    ``cache_dtype``, ``prefill_chunk`` and ``decode_chunk`` as for
    ``make_generate_fn``."""
    return MultimodalGenerate(model, gen, cache_dtype, vision_microbatch,
                              prefill_chunk, decode_chunk)


def make_fanout_multimodal_generate_fn(model: U2CausalLM,
                                       gen: GenerationConfig, n_samples: int,
                                       cache_dtype=torch.bfloat16,
                                       vision_microbatch: int = 128):
    """generate(input_ids, images, question_ids, prompt_len,
    generator=None) on per-case inputs (batch C) -> (C * n_samples,
    max_new) tokens: the vision encode, fuse, splice and prefill run once
    a case, the decode fans out (``FanoutGenerate``)."""
    gen_fn = make_fanout_generate_fn(model, gen, n_samples, cache_dtype)

    def generate(input_ids, images, question_ids, prompt_len,
                 generator=None):
        embeds = _microbatched_embeds(model, input_ids, images, question_ids,
                                      vision_microbatch)
        return gen_fn(embeds, prompt_len, generator)

    return generate


def teacher_forced_layout(prompt_len: torch.Tensor, s: int, t: int):
    """The decode loop's layout over [prompt (S rows) ; t generated]: (mask
    (B, 1, S+t, S+t), positions (B, S+t)). Generated token i sits at row
    S+i with RoPE position prompt_len+i, and the pad gap [prompt_len, S) is
    masked out of the keys."""
    dev = prompt_len.device
    idx = torch.arange(s + t, device=dev)
    valid_key = (idx[None, :] < prompt_len[:, None]) | (idx[None, :] >= s)
    causal = torch.ones(s + t, s + t, dtype=torch.bool, device=dev).tril()
    mask = causal[None, None] & valid_key[:, None, None, :]
    positions = torch.where(idx[None, :] < s, idx[None, :],
                            prompt_len[:, None] + (idx[None, :] - s))
    return mask, positions.to(torch.int32)


def seg_hidden_state(hidden: torch.Tensor, tokens: torch.Tensor, s: int,
                     seg_token_id: int):
    """(B, S+t, E) re-run hidden states -> ((B, E) the state at each row's
    first generated '[SEG]', zero where a row has none; (B,) has_seg)."""
    is_seg = tokens == seg_token_id
    has_seg = is_seg.any(dim=1)
    first = is_seg.int().argmax(dim=1)  # 0 if none; gated by has_seg
    state = _at(hidden, s + first)[:, 0]
    return torch.where(has_seg[:, None], state, torch.zeros_like(state)), \
        has_seg


class SegGenerate:
    """generate(input_ids, images, question_ids, prompt_len, seg_image (B,
    1, D, H, W), generator=None) -> (tokens (B, max_new), seg_logits (B,
    1, D, H, W), has_seg (B,)), ``generate(..., seg_enable=True)``
    (src/demo/demo.py:64): the multimodal generate, then one
    teacher-forced forward over [prompt ; generated] in the decode loop's
    layout (``teacher_forced_layout``; plain attention under its explicit
    mask, as in the JAX package) for the hidden state at the first
    generated '[SEG]' (``seg_hidden_state``), then the seg projector and
    SegVol. A row with no '[SEG]' gets logits from a zeroed prompt, to be
    ignored."""

    def __init__(self, model: U2CausalLM, gen: GenerationConfig,
                 seg_token_id: int, cache_dtype=torch.bfloat16):
        self.model = model
        self.seg_token_id = seg_token_id
        self.gen_fn = make_generate_fn(model, gen, cache_dtype)

    @torch.inference_mode()
    def __call__(self, input_ids, images, question_ids, prompt_len,
                 seg_image, generator=None):
        model = self.model
        embeds = model.prepare_inputs_embeds(input_ids, images, question_ids)
        prompt_len = prompt_len.to(device=embeds.device, dtype=torch.int32)
        tokens = self.gen_fn(embeds, prompt_len, generator)
        s, t = embeds.shape[1], tokens.shape[1]
        tok_embeds = model.embed_tokens(tokens)
        full = torch.cat([embeds.to(tok_embeds.dtype), tok_embeds], dim=1)
        mask, positions = teacher_forced_layout(prompt_len, s, t)
        _, hidden, _ = model.forward_embeds(full, mask=mask,
                                            positions=positions,
                                            compute_logits=False)
        seg_hidden, has_seg = seg_hidden_state(hidden, tokens, s,
                                               self.seg_token_id)
        return tokens, model.segment(seg_image, seg_hidden), has_seg


def make_seg_generate_fn(model: U2CausalLM, gen: GenerationConfig,
                         seg_token_id: int, cache_dtype=torch.bfloat16
                         ) -> SegGenerate:
    """The '[SEG]' generate (``SegGenerate``); the cache is bf16 by
    default, as in the JAX package."""
    return SegGenerate(model, gen, seg_token_id, cache_dtype)
