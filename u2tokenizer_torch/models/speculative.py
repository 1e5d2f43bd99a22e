"""Speculative decoding with n-gram drafts (counterpart of
``u2tokenizer_tpu/models/speculative.py``).

Radiology reports repeat long spans of the prompt and of their own text,
so no draft model is needed: the token history proposes the continuation
that followed the same context last time (``ngram_draft``), and one
forward of a verify block of ``block_len`` tokens a row accepts the
longest prefix that the model agrees with. Greedy output equals step by
step decoding token for token (the block's logits are the steps' logits);
sampled output has the distribution of plain sampling (point-mass-draft
rejection sampling), not its trajectory, since the generator's draws are
taken in another order.

Per-row divergence (rows accept different counts a step) is handled with
per-row cache offsets: each verify block is written at the row's own slot
by the decoder's per-row write (``write_index`` a (B,) tensor) and attends
the whole cache under a mask. The cache has ``block_len`` slots of slack
past the last live one, so no block writes outside it. ``out`` and the
drafting history have one spare column each that takes the writes of
lanes a row does not emit, sliced off after, in place of the JAX
package's dropped scatters.

The JAX package runs the loop as one ``lax.while_loop`` on the device.
The port's loop is eager, and reads the host:

  * once a verify step (and once before the first), for the loop's
    condition, whether any row is still live;
  * sampled decoding with ``top_p`` < 1 adds, a step, one read for the
    draft positions whose uniform lands between the acceptance bounds
    (``nucleus_membership_bounds``), then, when any did, one or two in
    ``nucleus_p_draft`` over those positions, and one or two in the
    boundary residual's ``nucleus_accept_residual`` (one when every row's
    nucleus lies in its top 128 logits, ``ops.sampling``).

Greedy decoding therefore reads the host once a verify step.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import GenerationConfig
from ..ops.sampling import (categorical, nucleus_accept_residual,
                            nucleus_membership_bounds, nucleus_p_draft)
from .generate import (_at, _microbatched_embeds, llm_config, prefill,
                       prefill_chunks, prefill_group_prefix, sample_tokens)
from .llm.decoder import KVCache


def ngram_draft(hist: torch.Tensor, idx_last: torch.Tensor, c0: torch.Tensor,
                c1: torch.Tensor, n_drafts: int,
                c00: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``n_drafts`` continuation tokens a row by n-gram history match.

    hist (B, L) token history, -1 where unwritten; idx_last (B,) the
    history index of the newest token (matches at or after the bigram
    ending there are excluded); c0, c1 (B,) the two newest tokens (c1 the
    pending one); c00 (B,) the third newest: when given, the most recent
    trigram (c00, c0, c1) match wins over the most recent bigram match.
    Rows with no match, or whose continuation runs into unwritten history,
    repeat c1. Returns (B, n_drafts) in hist's dtype."""
    b, l = hist.shape
    pos = torch.arange(l - 1, device=hist.device)
    none = torch.full((), -1, dtype=pos.dtype, device=hist.device)
    m2 = (hist[:, :-1] == c0[:, None]) & (hist[:, 1:] == c1[:, None])
    m2 = m2 & (pos[None, :] + 1 < idx_last[:, None])
    j = torch.where(m2, pos[None, :], none).amax(dim=1)
    if c00 is not None:
        # trigram ending at p + 1: hist[p - 1] == c00 for bigram index p >= 1
        m3 = m2[:, 1:] & (hist[:, :-2] == c00[:, None]) & (c00[:, None] >= 0)
        j3 = torch.where(m3, pos[None, 1:], none).amax(dim=1)
        j = torch.where(j3 >= 0, j3, j)
    idxs = (j[:, None] + 2 + torch.arange(n_drafts, device=hist.device)
            ).clamp(0, l - 1)
    d = hist.gather(1, idxs)
    bad = (j[:, None] < 0) | (d < 0)
    return torch.where(bad, c1[:, None].to(hist.dtype), d)


class SpecGenerate:
    """generate(inputs_embeds (B, S, E), prompt_ids (B, S), prompt_len
    (B,), generator=None, script=None) -> (B, max_new) int64 tokens, pad
    after EOS, and with ``return_stats`` also the number of verify steps.
    ``prompt_ids`` seed the drafting history (columns past prompt_len are
    ignored); sampled decoding draws from ``generator``.

    ``forced_content``: ``script`` (B, >= max_new + block_len) gives the
    emitted tokens in place of the argmax or the draw, while every
    forward, cache write, the logits and the drafting over the scripted
    history run as in real serving (the content-controlled benchmark of
    the JAX package's ``bench.py``; random weights emit token cycles that
    flatter the drafter). Greedy: a draft is accepted when it equals the
    script; sampled: likewise, with the whole acceptance computation still
    run.

    ``prefill_chunk`` and ``shared_prefix`` (n, split) choose the prefill
    (``generate.prefill``). ``fanout=n``: per-case inputs (C, S, E),
    (C, S), (C,); the prompt is prefilled once a case into a prefix cache
    and n rows a case decode against it plus a per-row suffix cache
    (``gqa_sdpa_fanout``); returns (C*n, max_new), row c*n + j sample j of
    case c; ``script`` stays per row. ``fanout_split=(n, split)``: per-row
    inputs whose groups of n rows share their first ``split`` tokens; the
    shared split is prefilled once a group into the prefix cache and each
    row's tail [split, S) goes, in chunks of up to 256 tokens, into its
    suffix cache, which then holds [tail ; generated]. Needs split <
    prompt_len for every row. The modes are exclusive, in the order
    fanout, fanout_split, shared_prefix, prefill_chunk.

    ``prefill_stage`` and ``decode_loop`` are the two stages, for
    timing."""

    def __init__(self, model, gen: GenerationConfig,
                 cache_dtype=torch.bfloat16, block_len: int = 8,
                 return_stats: bool = False,
                 prefill_chunk: Optional[int] = None,
                 forced_content: bool = False,
                 shared_prefix: Optional[tuple] = None,
                 fanout: Optional[int] = None,
                 fanout_split: Optional[tuple] = None):
        self.model = model
        self.gen = gen
        self.cache_dtype = cache_dtype
        self.kb = block_len
        self.return_stats = return_stats
        self.prefill_chunk = prefill_chunk
        self.forced_content = forced_content
        self.shared_prefix = shared_prefix
        self.fanout = fanout
        self.fanout_split = fanout_split
        self.llm_cfg = llm_config(model)

    def _cache(self, batch: int, length: int, dev) -> KVCache:
        return KVCache.create(self.llm_cfg, batch, length, self.cache_dtype,
                              dev)

    @torch.inference_mode()
    def prefill_stage(self, inputs_embeds, prompt_ids, prompt_len,
                      generator=None) -> dict:
        """The prompt into the caches and the first token; returns the
        decode loop's inputs."""
        model, kb, max_new = self.model, self.kb, self.gen.max_new_tokens
        nrows, s, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        prompt_len = prompt_len.to(device=dev, dtype=torch.int32)
        prompt_ids = prompt_ids.to(dev)
        arange_s = torch.arange(s, device=dev)
        prefix = prefix_mask = None
        split = 0
        if self.fanout:
            n = self.fanout
            last_hidden, prefix = prefill(model, inputs_embeds, prompt_len,
                                          self._cache(nrows, s, dev))
            last_hidden = last_hidden.repeat_interleave(n, 0)
            prefix_mask = arange_s[None, :] < prompt_len[:, None]
            prompt_len = prompt_len.repeat_interleave(n, 0)
            prompt_ids = prompt_ids.repeat_interleave(n, 0)
            total = max_new + kb  # the suffix only: generated token e at e
            cache = self._cache(nrows * n, total, dev)
        elif self.fanout_split is not None:
            n, split = self.fanout_split
            c = nrows // n
            prefix = prefill_group_prefix(model, inputs_embeds, n, split,
                                          self._cache(c, split, dev))
            prefix_mask = torch.ones(c, split, dtype=torch.bool, device=dev)
            s2 = s - split
            total = s2 + max_new + kb
            cache = self._cache(nrows, total, dev)
            chunk = next((cand for cand in (256, 128, 64, 32)
                          if s2 > cand and s2 % cand == 0), s2)
            hidden, cache = prefill_chunks(
                model, inputs_embeds[:, split:], cache, chunk, pos0=split,
                prefix_cache=prefix, prefix_mask=prefix_mask)
            last_hidden = _at(hidden, prompt_len - 1 - split)
        else:
            # slack of one block past the last live slot: a block starting
            # there writes up to kb - 1 masked slots beyond it
            total = s + max_new + kb
            cache = self._cache(nrows, total, dev)
            last_hidden, cache = prefill(model, inputs_embeds, prompt_len,
                                         cache, self.prefill_chunk,
                                         self.shared_prefix)
        tok0 = sample_tokens(self.gen, model.lm_logits(last_hidden)[:, 0],
                             generator)
        att = arange_s[None, :] < prompt_len[:, None]
        return dict(cache=cache, prefix=prefix, prefix_mask=prefix_mask,
                    tok0=tok0, att=att, prompt_ids=prompt_ids,
                    prompt_len=prompt_len, s=s, split=split)

    @torch.inference_mode()
    def decode_loop(self, cache, prefix, prefix_mask, tok0, att, prompt_ids,
                    prompt_len, s: int, split: int, generator=None,
                    script=None):
        """The verify/accept loop from the prefill's state. Without a
        prefix cache the cache holds [prompt ; generated], emitted index e
        at slot s + e; with a fan-out prefix the cache holds the suffix
        only (e at slot e); with ``split`` (fanout_split) it holds
        [prompt tail ; generated], tail token t at slot t - split and e at
        slot s - split + e."""
        g, model, kb = self.gen, self.model, self.kb
        max_new = g.max_new_tokens
        b = tok0.shape[0]
        dev = tok0.device
        total = cache.max_len
        cache_base = 0 if (prefix is not None and split == 0) else s - split
        forced = self.forced_content
        if forced:
            if script is None:
                raise ValueError("forced_content needs a script")
            script = script.to(device=dev, dtype=torch.int64)
            tok0 = torch.where(script[:, 0] >= 0, script[:, 0], tok0)

        # history: prompt at [0, prompt_len), -1 gap, generated token j at
        # s + j; and the tokens; each with a spare last column
        hist = torch.full((b, s + max_new + 1), -1, dtype=torch.int64,
                          device=dev)
        hist[:, :s] = torch.where(att, prompt_ids.long(),
                                  torch.full_like(hist[:, :s], -1))
        hist[:, s] = tok0
        out = torch.full((b, max_new + 1), g.pad_token_id, dtype=torch.int64,
                         device=dev)
        out[:, 0] = tok0

        kv_pos = torch.arange(total, device=dev)
        koff = torch.arange(kb, device=dev)
        rows = torch.arange(b, device=dev)
        plen = prompt_len.long()
        pending = tok0
        n_emit = torch.ones(b, dtype=torch.int64, device=dev)
        done = tok0 == g.eos_token_id
        n_steps = 0
        while bool((~done & (n_emit < max_new)).any()):  # the host read
            n_w = n_emit - 1  # generated tokens whose KV is cached
            # -- draft: trigram-first (prev2, prev, pending) history match
            h = hist[:, :-1]
            idx_last = s + n_emit - 1
            prev = torch.where(
                n_emit >= 2,
                h.gather(1, (idx_last - 1).clamp_min(0)[:, None])[:, 0],
                h.gather(1, (plen - 1)[:, None])[:, 0])
            prev2_idx = torch.where(n_emit >= 3, idx_last - 2, torch.where(
                n_emit == 2, plen - 1, plen - 2))
            prev2 = h.gather(1, prev2_idx.clamp_min(0)[:, None])[:, 0]
            drafts = ngram_draft(h, idx_last, prev, pending, kb - 1, c00=prev2)

            # -- one verify forward over [pending, d_1 .. d_{kb-1}]
            f = torch.cat([pending[:, None], drafts], dim=1)  # (B, kb)
            emb = model.embed_tokens(f)
            pos = ((plen + n_w)[:, None] + koff[None, :]).to(torch.int32)
            last_key = n_w[:, None, None] + koff[None, :, None]
            if prefix is not None and split == 0:
                key_ok = kv_pos[None, None, :] <= last_key
            else:
                key_ok = (kv_pos[None, None, :]
                          < (plen - split)[:, None, None]) | (
                    (kv_pos[None, None, :] >= cache_base)
                    & (kv_pos[None, None, :] <= cache_base + last_key))
            logits, _, cache = model.decode_step(
                emb, pos, key_ok[:, None], cache,
                (cache_base + n_w).to(torch.int32), prefix_cache=prefix,
                prefix_mask=prefix_mask)
            s_tok = None
            if forced:  # position j emits the script at index n_emit + j
                s_tok = script.gather(1, (n_emit[:, None] + koff[None, :])
                                      .clamp(0, script.shape[1] - 1))
            if not g.do_sample:
                gt = logits.argmax(dim=-1)
                if forced:
                    gt = torch.where(s_tok >= 0, s_tok, gt)
                # longest accepted prefix: f[j] must equal g[j - 1]
                match = f[:, 1:] == gt[:, :-1]
                c = 1 + match.long().cumprod(dim=1).sum(dim=1)
            else:
                gt, c = self._sampled_accept(logits, f, s_tok, generator)
            # EOS inside the block truncates it (the EOS itself is emitted)
            eos = gt == g.eos_token_id
            emitted_eos = eos & (koff[None, :] < c[:, None])
            hit = emitted_eos.any(dim=1)
            first_eos = emitted_eos.long().argmax(dim=1)
            c = torch.where(hit, torch.minimum(c, first_eos + 1), c)
            c = torch.minimum(c, max_new - n_emit)  # budget
            hit = (eos & (koff[None, :] < c[:, None])).any(dim=1)
            c = torch.where(done, torch.zeros_like(c), c)
            hit = hit & ~done

            # -- writes of the emitted tokens; the rest go to spare columns
            emit = koff[None, :] < c[:, None]
            idx = n_emit[:, None] + koff[None, :]
            out.scatter_(1, torch.where(emit, idx, max_new), gt)
            hist.scatter_(1, torch.where(emit, s + idx, s + max_new), gt)
            pending = torch.where(
                c > 0, gt.gather(1, (c - 1).clamp_min(0)[:, None])[:, 0],
                pending)
            n_emit = n_emit + c
            done = done | hit
            n_steps += 1
        tokens = out[:, :max_new]
        return (tokens, n_steps) if self.return_stats else tokens

    def _sampled_accept(self, logits, f, s_tok, generator):
        """Rejection sampling of the block's drafts against the warped
        target distributions: draft f[:, j + 1] is accepted with
        probability p_j(draft) (bounds first, the exact probability only
        where a uniform lands between them), and the first rejected
        position (or, after kb - 1 accepts, the last) emits a draw from
        the residual. Returns (tokens (B, kb), emitted counts (B,))."""
        g, kb = self.gen, self.kb
        b, _, v = logits.shape
        dev = logits.device
        rows = torch.arange(b, device=dev)
        koff = torch.arange(kb, device=dev)
        w_all = logits if g.temperature == 1.0 else logits / g.temperature
        w_pos = w_all[:, :-1].reshape(b * (kb - 1), v)
        d_flat = f[:, 1:].reshape(-1)
        # the last position has no draft (-1): it draws from the whole warp
        d_per_pos = torch.cat([f[:, 1:], torch.full_like(f[:, :1], -1)], 1)
        u = torch.rand((b, kb - 1), generator=generator, device=dev)
        if g.top_p < 1.0:
            _, p_lo, p_hi = nucleus_membership_bounds(w_pos, d_flat, g.top_p)
            p_lo, p_hi = p_lo.reshape(b, kb - 1), p_hi.reshape(b, kb - 1)
            uncertain = (u >= p_lo) & (u < p_hi)
            sel = uncertain.reshape(-1).nonzero()[:, 0]  # a host read
            p_exact = torch.zeros(b * (kb - 1), device=dev)
            if sel.numel():
                p_exact[sel] = nucleus_p_draft(w_pos[sel], d_flat[sel],
                                               g.top_p)
            accept = torch.where(uncertain, u < p_exact.reshape(b, kb - 1),
                                 u < p_lo)
        else:  # temperature only: p is the full softmax
            wf = w_pos.float()
            l_d = wf.gather(1, d_flat.clamp_min(0)[:, None])[:, 0]
            p = torch.exp(l_d - torch.logsumexp(wf, dim=-1))
            accept = u < p.reshape(b, kb - 1)
        if s_tok is not None:  # the model's draw at n_emit + j is scripted
            accept = torch.where(s_tok[:, :-1] >= 0,
                                 f[:, 1:] == s_tok[:, :-1], accept)
        n_acc = accept.long().cumprod(dim=1).sum(dim=1)  # 0 .. kb - 1
        # boundary residual: position n_acc's draft was rejected (or, at
        # kb - 1, the sentinel draws from the whole warp)
        w_b = w_all[rows, n_acc]  # (B, V)
        d_b = d_per_pos[rows, n_acc]
        if g.top_p < 1.0:
            _, fresh = nucleus_accept_residual(w_b, d_b, g.top_p, generator)
        else:
            wbf = w_b.float()
            masked = wbf.scatter(1, d_b.clamp_min(0)[:, None], -torch.inf)
            fresh = categorical(torch.where((d_b >= 0)[:, None], masked, wbf),
                                generator)
        d_shift = torch.cat([f[:, 1:], f[:, -1:]], dim=1)
        gt = torch.where(koff[None, :] < n_acc[:, None], d_shift,
                         fresh[:, None])
        if s_tok is not None:
            gt = torch.where(s_tok >= 0, s_tok, gt)
        return gt, n_acc + 1

    def __call__(self, inputs_embeds, prompt_ids, prompt_len, generator=None,
                 script=None):
        state = self.prefill_stage(inputs_embeds, prompt_ids, prompt_len,
                                   generator)
        return self.decode_loop(**state, generator=generator, script=script)


def make_spec_generate_fn(model, gen: GenerationConfig,
                          cache_dtype=torch.bfloat16, block_len: int = 8,
                          return_stats: bool = False,
                          prefill_chunk: Optional[int] = None,
                          forced_content: bool = False,
                          shared_prefix: Optional[tuple] = None,
                          fanout: Optional[int] = None,
                          fanout_split: Optional[tuple] = None
                          ) -> SpecGenerate:
    """generate(inputs_embeds, prompt_ids, prompt_len, generator=None,
    script=None) (``SpecGenerate``), the speculative counterpart of
    ``generate.make_generate_fn``."""
    return SpecGenerate(model, gen, cache_dtype, block_len, return_stats,
                        prefill_chunk, forced_content, shared_prefix, fanout,
                        fanout_split)


class SpecMultimodalGenerate:
    """generate(input_ids, images, question_ids, prompt_len,
    generator=None, script=None): vision encode, fuse and splice
    (``embeds``), then ``gen_fn`` (a ``SpecGenerate``) with the input ids
    as the drafting history. With ``fanout`` the inputs are per case."""

    def __init__(self, model, gen: GenerationConfig, cache_dtype,
                 block_len: int, vision_microbatch: int, return_stats: bool,
                 prefill_chunk, forced_content: bool, fanout):
        self.model = model
        self.vision_microbatch = vision_microbatch
        self.gen_fn = make_spec_generate_fn(
            model, gen, cache_dtype, block_len, return_stats, prefill_chunk,
            forced_content, fanout=fanout)

    def embeds(self, input_ids, images, question_ids) -> torch.Tensor:
        return _microbatched_embeds(self.model, input_ids, images,
                                    question_ids, self.vision_microbatch)

    def __call__(self, input_ids, images, question_ids, prompt_len,
                 generator=None, script=None):
        return self.gen_fn(self.embeds(input_ids, images, question_ids),
                           input_ids, prompt_len, generator, script)


def make_spec_multimodal_generate_fn(model, gen: GenerationConfig,
                                     cache_dtype=torch.bfloat16,
                                     block_len: int = 8,
                                     vision_microbatch: int = 128,
                                     return_stats: bool = False,
                                     prefill_chunk: Optional[int] = None,
                                     forced_content: bool = False,
                                     fanout: Optional[int] = None
                                     ) -> SpecMultimodalGenerate:
    """The speculative counterpart of
    ``generate.make_multimodal_generate_fn`` (``SpecMultimodalGenerate``);
    ``forced_content`` takes a trailing ``script``, ``fanout=n`` per-case
    inputs and returns (C*n, max_new)."""
    return SpecMultimodalGenerate(model, gen, cache_dtype, block_len,
                                  vision_microbatch, return_stats,
                                  prefill_chunk, forced_content, fanout)
