"""Continuous-batching serving engine over a pool of decode slots
(counterpart of ``u2tokenizer_tpu/models/slot_serving.py``).

A fixed pool of ``num_slots`` decode slots shares one batched KV cache;
a new request prefills into a free slot while the other slots keep
decoding, so that per-request latency does not wait for a batch to form.
The prefill is a batch-1 forward (kernel K2 on the GPU) written into the
request's slot of the pooled cache; the decode step advances every slot
at once with per-row write positions (the decoder's per-row writer, a
(S,) ``write_index``) and per-row masks from (prompt_len, n_gen). Idle
slots compute masked values that nobody reads: a slot costs the same busy
or idle, the continuous-batching bargain. As in the JAX package the slot
decode passes no ``decode_bounds``, so it attends through the plain
attention of ``ops.attention`` (``gqa_sdpa_headmajor``, or
``gqa_sdpa_quantized`` over an int8 or int4 cache), not kernel K3.

The JAX package compiles each function once; here they run eagerly on
the model's device and update the slot state in place (they still return
it, so that the call sites read like their counterparts). Each prefill
writes into a view of its slot's row of the pooled cache after zeroing
the slots past the prompt buffer, so that the row holds what the JAX
package's fresh one-row cache would: the prompt's K/V, then zeros. The
speculative decode's every block size shares one state; its cache slack
is sized once for ``block_len``.

The host-side ``Engine`` is a plain scheduler: ``submit`` enqueues,
``step`` either admits a pending request (prefill) or advances every
slot by one decode call; finished rows (EOS or ``max_new_tokens``) free
their slot. It reads the device once a tick and nowhere else: the
prefill's first token (``int(tok0)``), the plain decode's (S,) tokens, or
the speculative decode's packed (S, kbx + 1) tokens and counts. A slot's
``active`` and ``done`` flags are mirrored on the host and cleared on the
device by writes that read nothing back.

Every function here runs under ``torch.inference_mode``. Grad mode is a
per-thread setting in PyTorch, so ``EngineInference``'s engine thread
enters it itself as well.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import GenerationConfig
from .generate import _at, llm_config, sample_tokens
from .llm.decoder import KVCache
from .speculative import ngram_draft
from .u2_model import causal_padding_mask, resolve_model_device


@dataclasses.dataclass
class SlotState:
    """The slot pool on the device: the pooled cache and, a slot each,
    the last emitted token, the prompt length, the tokens generated so
    far, whether the slot holds a live request and whether that request
    is done (it keeps its slot until the host collects it). ``hist`` is
    the speculative engine's token history (S, prompt_buf + max_new + 1),
    -1 where unwritten, its last column a spare that takes the writes of
    lanes a row does not emit (the JAX package drops them); None for the
    plain engine."""

    cache: KVCache
    tok: torch.Tensor         # (S,) int64
    prompt_len: torch.Tensor  # (S,) int64
    n_gen: torch.Tensor       # (S,) int64
    active: torch.Tensor      # (S,) bool
    done: torch.Tensor        # (S,) bool
    hist: Optional[torch.Tensor] = None


def _row_view(cache: KVCache, slot: int) -> KVCache:
    """Slot ``slot``'s row of the pooled cache as a batch-1 cache of views:
    what is written there lands in the pool."""
    row = lambda bufs: None if bufs is None else [b[slot:slot + 1]
                                                  for b in bufs]
    return KVCache(row(cache.k), row(cache.v), row(cache.k_scale),
                   row(cache.v_scale))


def _init_state(llm_cfg, num_slots: int, total: int, cache_dtype, dev,
                hist_len: Optional[int] = None) -> SlotState:
    z = lambda dt: torch.zeros(num_slots, dtype=dt, device=dev)
    hist = None
    if hist_len is not None:
        hist = torch.full((num_slots, hist_len + 1), -1, dtype=torch.int64,
                          device=dev)
    return SlotState(
        cache=KVCache.create(llm_cfg, num_slots, total, cache_dtype, dev),
        tok=z(torch.int64), prompt_len=z(torch.int64), n_gen=z(torch.int64),
        active=z(torch.bool), done=z(torch.bool), hist=hist)


def _prefill_row(model, state: SlotState, embeds: torch.Tensor,
                 prompt_len: int, slot: int, prompt_buf: int) -> torch.Tensor:
    """Batch-1 prefill of ``embeds`` (1, prompt_buf, E) into slot ``slot``
    of the pooled cache (K2 with ``lens`` = [prompt_len]); the row's slots
    from ``prompt_buf`` on are zeroed first. Returns the (1, V) logits of
    the last prompt position."""
    dev = embeds.device
    row = _row_view(state.cache, slot)
    for buf in row.k + row.v + (row.k_scale or []) + (row.v_scale or []):
        buf[:, :, prompt_buf:] = 0
    s = embeds.shape[1]
    att = (torch.arange(s, device=dev) < prompt_len)[None]
    plen = torch.full((1,), prompt_len, dtype=torch.int32, device=dev)
    _, hidden, _ = model.forward_embeds(
        embeds, cache=row, write_index=0,
        positions=torch.arange(s, dtype=torch.int32, device=dev)[None],
        mask=causal_padding_mask(att), lens=plen, compute_logits=False)
    return model.lm_logits(_at(hidden, plen - 1))[:, 0]


def _admit(state: SlotState, slot: int, tok0: torch.Tensor, prompt_len: int,
           eos: int) -> None:
    """The slot's flags after its prefill: written on the device, read
    nowhere."""
    state.tok[slot] = tok0
    state.prompt_len[slot] = prompt_len
    state.n_gen[slot] = 0
    state.active[slot] = True
    state.done[slot] = tok0 == eos


def make_slot_fns(model, gen: GenerationConfig, num_slots: int,
                  prompt_buf: int, cache_dtype=torch.bfloat16,
                  device="cuda"):
    """Build (init_state, prefill_fn, decode_fn) for a slot pool on
    ``device``, where the model must lie.

    prefill_fn(state, embeds, prompt_len, slot, generator=None) ->
      (state, tok0): batch-1 prefill of ``embeds`` (1, prompt_buf, E),
      right-padded, into slot ``slot`` (ints); tok0 a 0-d device tensor.
    decode_fn(state, generator=None) -> (state, tokens (S,)): one token
      for every slot (inactive or done rows emit ``pad_token_id``).
    Sampled decoding draws from ``generator``."""
    dev = resolve_model_device(model, device)
    llm_cfg = llm_config(model)
    total = prompt_buf + gen.max_new_tokens
    kv_pos = torch.arange(total, device=dev)

    @torch.inference_mode()
    def init_state() -> SlotState:
        return _init_state(llm_cfg, num_slots, total, cache_dtype, dev)

    @torch.inference_mode()
    def prefill_fn(state: SlotState, embeds, prompt_len: int, slot: int,
                   generator=None):
        last = _prefill_row(model, state, embeds, prompt_len, slot,
                            prompt_buf)
        tok0 = sample_tokens(gen, last, generator)[0]
        _admit(state, slot, tok0, prompt_len, gen.eos_token_id)
        return state, tok0

    @torch.inference_mode()
    def decode_fn(state: SlotState, generator=None):
        emb = model.embed_tokens(state.tok[:, None])
        pos = (state.prompt_len + state.n_gen)[:, None].to(torch.int32)
        # row visibility: its own prompt plus its own generated slots
        key_ok = (kv_pos[None, :] < state.prompt_len[:, None]) | (
            (kv_pos[None, :] >= prompt_buf)
            & (kv_pos[None, :] <= prompt_buf + state.n_gen[:, None]))
        write_index = (prompt_buf + state.n_gen).to(torch.int32)  # per row
        logits, _, _ = model.decode_step(emb, pos, key_ok[:, None, None, :],
                                         state.cache, write_index)
        nxt = sample_tokens(gen, logits[:, 0], generator)
        emit = state.active & ~state.done
        nxt = torch.where(emit, nxt, torch.full_like(nxt, gen.pad_token_id))
        newly_done = emit & ((nxt == gen.eos_token_id)
                             | (state.n_gen + 1 >= gen.max_new_tokens))
        state.tok = nxt
        state.n_gen = torch.where(emit, state.n_gen + 1, state.n_gen)
        state.done = state.done | newly_done
        return state, nxt

    return init_state, prefill_fn, decode_fn


def make_spec_slot_fns(model, gen: GenerationConfig, num_slots: int,
                       prompt_buf: int, cache_dtype=torch.bfloat16,
                       block_len: int = 8, device="cuda"):
    """Speculative (greedy-only) slot functions: each decode call runs one
    n-gram-drafted verify block a slot (``speculative.ngram_draft``,
    trigram first) and emits 1 to ``block_len`` tokens, the plain slot
    engine's tokens (the longest accepted prefix, cut at EOS and at the
    budget), in fewer device calls.

    Returns (init_state, prefill_fn, make_decode).
    prefill_fn(state, embeds, prompt_ids, prompt_len, slot,
      generator=None) -> (state, tok0); ``prompt_ids`` (1, prompt_buf)
      seed the drafting history.
    make_decode(kbx) builds a decode over the same state with a
    ``kbx``-position verify block (1 <= kbx <= block_len):
    decode_fn(state, generator=None) -> (state, packed (S, kbx + 1)), row
    j having emitted packed[j, :packed[j, -1]] (tokens and counts in one
    tensor, so that the host reads once a step). kbx=1 is a plain
    one-token step, so the adaptive engine walks block sizes without
    rebuilding the state."""
    if gen.do_sample:
        raise ValueError("speculative slot engine supports greedy only")
    dev = resolve_model_device(model, device)
    llm_cfg = llm_config(model)
    kb = block_len
    max_new = gen.max_new_tokens
    # +kb slack: a verify block near the last live slot writes past it
    total = prompt_buf + max_new + kb
    hist_len = prompt_buf + max_new
    kv_pos = torch.arange(total, device=dev)

    @torch.inference_mode()
    def init_state() -> SlotState:
        return _init_state(llm_cfg, num_slots, total, cache_dtype, dev,
                           hist_len)

    @torch.inference_mode()
    def prefill_fn(state: SlotState, embeds, prompt_ids, prompt_len: int,
                   slot: int, generator=None):
        last = _prefill_row(model, state, embeds, prompt_len, slot,
                            prompt_buf)
        tok0 = last.argmax(dim=-1)[0]
        row = state.hist[slot]
        row.fill_(-1)
        s = prompt_ids.shape[1]
        valid = torch.arange(s, device=dev) < prompt_len
        row[:s] = torch.where(valid, prompt_ids[0].long(),
                              torch.full_like(row[:s], -1))
        row[prompt_buf] = tok0
        _admit(state, slot, tok0, prompt_len, gen.eos_token_id)
        return state, tok0

    def make_decode(kbx: int):
        if not 1 <= kbx <= kb:
            raise ValueError(f"block size {kbx} outside [1, {kb}]: the "
                             "cache slack is sized for block_len")
        koff = torch.arange(kbx, device=dev)

        @torch.inference_mode()
        def decode_fn(state: SlotState, generator=None):
            hist = state.hist[:, :-1]
            n_w = state.n_gen                  # KV-written generated tokens
            pending = state.tok
            # n_gen counts decode-emitted tokens; +1 for the prefill token
            n_emit = state.n_gen + 1
            plen = state.prompt_len

            idx_last = prompt_buf + n_w
            at = lambda idx: hist.gather(1, idx.clamp_min(0)[:, None])[:, 0]
            prev = torch.where(n_w >= 1, at(idx_last - 1), at(plen - 1))
            prev2 = at(torch.where(n_w >= 2, idx_last - 2, torch.where(
                n_w == 1, plen - 1, plen - 2)))
            drafts = ngram_draft(hist, idx_last, prev, pending, kbx - 1,
                                 c00=prev2)

            f = torch.cat([pending[:, None], drafts], dim=1)
            emb = model.embed_tokens(f)
            pos = ((plen + n_w)[:, None] + koff[None, :]).to(torch.int32)
            key_ok = (kv_pos[None, None, :] < plen[:, None, None]) | (
                (kv_pos[None, None, :] >= prompt_buf)
                & (kv_pos[None, None, :] <= (prompt_buf + n_w)[:, None, None]
                   + koff[None, :, None]))
            logits, _, _ = model.decode_step(
                emb, pos, key_ok[:, None], state.cache,
                (prompt_buf + n_w).to(torch.int32))
            g = logits.argmax(dim=-1)

            match = f[:, 1:] == g[:, :-1]
            c = 1 + match.long().cumprod(dim=1).sum(dim=1)
            eos = g == gen.eos_token_id
            emitted_eos = eos & (koff[None, :] < c[:, None])
            first_eos = emitted_eos.long().argmax(dim=1)
            c = torch.where(emitted_eos.any(dim=1),
                            torch.minimum(c, first_eos + 1), c)
            c = torch.minimum(c, max_new - n_emit)   # budget
            emit_ok = state.active & ~state.done
            c = torch.where(emit_ok, c.clamp_min(0), torch.zeros_like(c))
            hit = (eos & (koff[None, :] < c[:, None])).any(dim=1)

            emit = koff[None, :] < c[:, None]
            toks = torch.where(emit, g, torch.full_like(g, gen.pad_token_id))
            hist_idx = torch.where(
                emit, prompt_buf + n_emit[:, None] + koff[None, :], hist_len)
            state.hist.scatter_(1, hist_idx, g)  # unemitted: spare column
            state.tok = torch.where(
                c > 0, g.gather(1, (c - 1).clamp_min(0)[:, None])[:, 0],
                pending)
            state.n_gen = state.n_gen + c
            state.done = state.done | (emit_ok & (
                hit | (state.n_gen + 1 >= max_new)))
            # tokens + counts in one tensor = one host read a step
            return state, torch.cat([toks, c[:, None]], dim=1)

        return decode_fn

    return init_state, prefill_fn, make_decode


@dataclasses.dataclass
class _Request:
    rid: int
    embeds: Any              # (1, prompt_buf, E)
    prompt_len: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    finished: bool = False
    prompt_ids: Any = None   # (1, prompt_buf) int64; speculative drafting seed


class Engine:
    """Host-side continuous-batching scheduler over the slot pool, on
    ``device`` (the GPU unless the caller names another), where the model
    must lie; the model carries its weights (the JAX package's ``params``
    argument is gone).

    ``speculative=True`` (greedy only): each device step runs an n-gram-
    drafted verify block a slot and can emit up to ``block_len`` tokens:
    the same tokens in fewer device calls.

    ``speculative="auto"``: adaptive speculation. Acceptance depends on
    the content and a verify block costs more the longer it is, so the
    engine walks a ladder of block sizes (1, 2, 4, ..., block_len, all on
    one state): a sliding window of measured acceptance below
    ``spec_threshold`` steps one rung down (down to one-token dispatches),
    a window accepting at least ``grow_frac`` of the current block steps
    one rung up, and after ``probe_every`` one-token dispatches the engine
    probes the next rung again. Tokens are the same at every rung; only
    the dispatch granularity adapts. The defaults are the JAX package's,
    which it calibrated from its per-rung dispatch costs on a TPU; the
    H100's are not measured yet.

    Sampled decoding draws from a ``torch.Generator`` on the device seeded
    with ``seed``; greedy engines draw nothing."""

    def __init__(self, model, gen: GenerationConfig,
                 num_slots: int = 8, prompt_buf: int = 1024,
                 cache_dtype=torch.bfloat16, seed: int = 0,
                 speculative=False, block_len: int = 8,
                 spec_threshold: float = 1.2, spec_window: int = 16,
                 probe_every: int = 64, grow_frac: float = 0.55,
                 device="cuda"):
        self.model = model
        self.gen = gen
        self.num_slots = num_slots
        self.prompt_buf = prompt_buf
        self.device = resolve_model_device(model, device)
        self.adaptive = speculative == "auto"
        self.speculative = bool(speculative)
        if self.speculative:
            (init_state, self._prefill,
             self._make_decode) = make_spec_slot_fns(
                model, gen, num_slots, prompt_buf, cache_dtype, block_len,
                self.device)
            # block-size ladder: powers of two up to block_len; every rung
            # reuses the same slot state (cache slack sized for block_len)
            ladder = [1]
            while ladder[-1] * 2 < block_len:
                ladder.append(ladder[-1] * 2)
            if block_len > 1:
                ladder.append(block_len)
            self._kb_ladder = ladder
            self._decode_fns: Dict[int, Any] = {}
            # non-adaptive engines stay pinned at the top rung
            self._rung = len(ladder) - 1
        else:
            init_state, self._prefill, self._decode = make_slot_fns(
                model, gen, num_slots, prompt_buf, cache_dtype, self.device)
        self.state = init_state()
        self._generator = (torch.Generator(self.device).manual_seed(seed)
                           if gen.do_sample else None)
        self._queue: deque = deque()
        self._by_slot: Dict[int, _Request] = {}
        self._results: Dict[int, List[int]] = {}
        self._next_rid = 0
        # acceptance telemetry (speculative only): verify_steps counts one
        # per (active slot, decode dispatch); mean acceptance =
        # emitted_tokens / verify_steps
        self.spec_stats = {"emitted_tokens": 0, "verify_steps": 0}
        # adaptive-policy state
        self.spec_threshold = spec_threshold
        self.spec_window = spec_window
        self.probe_every = probe_every
        self.grow_frac = grow_frac
        self._accept_window: deque = deque(maxlen=spec_window)
        self._plain_dispatches = 0
        # engine telemetry: cumulative counters + a sliding window of
        # (monotonic time, cumulative emitted tokens) samples, one per
        # scheduler tick, for the live tokens/s rate
        self._emitted_total = 0
        self._completed = 0
        self._rate_window: deque = deque(maxlen=256)

    @property
    def spec_block_len(self) -> int:
        """Current verify-block size (1 = plain one-token dispatches)."""
        if not self.speculative:
            return 1
        return self._kb_ladder[self._rung]

    @property
    def spec_mode(self) -> str:
        """'spec' when dispatches carry drafted verify blocks, else
        'plain' (kb=1 rung or a non-speculative engine)."""
        return "spec" if self.spec_block_len > 1 else "plain"

    def _decode_for(self, kbx: int):
        """The decode of one ladder rung, built on first use."""
        if kbx not in self._decode_fns:
            self._decode_fns[kbx] = self._make_decode(kbx)
        return self._decode_fns[kbx]

    def telemetry(self) -> Dict[str, Any]:
        """Live engine stats (served at GET /v1/config as ``engine``).
        ``tokens_per_s`` is measured over the last 10 s or less of
        scheduler ticks and reads 0 when the engine has been idle that
        long."""
        now = time.monotonic()
        # a copy first: the engine thread appends while a handler reads
        recent = [(t, n) for t, n in tuple(self._rate_window)
                  if now - t <= 10.0]
        rate = 0.0
        if len(recent) >= 2 and recent[-1][0] > recent[0][0]:
            rate = ((recent[-1][1] - recent[0][1])
                    / (recent[-1][0] - recent[0][0]))
        return {
            "queue_depth": len(self._queue),
            "active_slots": len(self._by_slot),
            "num_slots": self.num_slots,
            "completed_requests": self._completed,
            "emitted_tokens_total": self._emitted_total,
            "tokens_per_s": round(rate, 1),
            "spec_block_len": self.spec_block_len,
        }

    def _adapt(self, emitted: int, slot_steps: int) -> None:
        """Walk the block-size ladder on a full acceptance window: below
        ``spec_threshold`` step one rung down (toward one-token
        dispatches); accepting >= ``grow_frac`` of the current block step
        one rung up."""
        self._accept_window.append((emitted, slot_steps))
        if len(self._accept_window) < self.spec_window:
            return
        tok = sum(e for e, _ in self._accept_window)
        stp = max(sum(s for _, s in self._accept_window), 1)
        accept = tok / stp
        if accept < self.spec_threshold and self._rung > 0:
            self._rung -= 1
            self._plain_dispatches = 0
            self._accept_window.clear()
        elif (accept >= self.grow_frac * self._kb_ladder[self._rung]
              and self._rung < len(self._kb_ladder) - 1):
            self._rung += 1
            self._accept_window.clear()

    # -- submission ---------------------------------------------------------

    def submit_embeds(self, embeds, prompt_len: int, prompt_ids=None) -> int:
        """Queue a request given (1, prompt_buf, E) prompt embeddings.
        ``prompt_ids`` seed speculative drafting; without them the history
        match never fires on the prompt (still correct)."""
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_Request(rid, embeds, prompt_len,
                                    prompt_ids=prompt_ids))
        return rid

    @torch.inference_mode()
    def submit(self, input_ids, images=None, question_ids=None) -> int:
        """Queue a request from ids (and an optional (1, T, D, H, W)
        volume with its question ids): embeddings computed by the
        multimodal splice (the ViT, K1 on the GPU), right-padded to the
        prompt buffer."""
        ids = np.asarray(input_ids, np.int64).reshape(1, -1)
        prompt_len = ids.shape[1]
        padded = np.full((1, self.prompt_buf), self.gen.pad_token_id,
                         np.int64)
        padded[0, :prompt_len] = ids[0]
        padded = torch.from_numpy(padded).to(self.device)
        if images is None and not hasattr(type(self.model),
                                          "prepare_inputs_embeds"):
            # bare text decoder (a GREEN judge served on the slot pool)
            embeds = self.model.embed_tokens(padded)
        else:
            if images is not None:
                images = torch.as_tensor(images).to(self.device,
                                                    torch.float32)
            if question_ids is not None:
                question_ids = torch.as_tensor(question_ids).to(
                    self.device, torch.int64)
            embeds = self.model.prepare_inputs_embeds(padded, images,
                                                      question_ids)
        return self.submit_embeds(embeds, prompt_len, padded)

    # -- scheduling ---------------------------------------------------------
    #
    # done/active are mirrored on the host (a request finishes exactly
    # when an appended token is EOS or it reaches max_new_tokens, both
    # seen on the host), so the scheduler reads no device state: the one
    # device-to-host read a tick is the emitted tokens.

    def _free_slots(self) -> List[int]:
        return [i for i in range(self.num_slots) if i not in self._by_slot]

    def _append(self, req: _Request, tok: int) -> None:
        req.tokens.append(tok)
        self._emitted_total += 1
        if tok == self.gen.eos_token_id or \
                len(req.tokens) >= self.gen.max_new_tokens:
            req.finished = True

    def _release(self, slot: int) -> None:
        self.state.active[slot] = False
        self.state.done[slot] = False
        del self._by_slot[slot]

    def _collect_finished(self):
        for slot, req in list(self._by_slot.items()):
            if req.finished:
                self._completed += 1
                self._results[req.rid] = req.tokens
                self._release(slot)

    @torch.inference_mode()
    def step(self) -> bool:
        """One scheduler tick; returns False when fully idle."""
        self._rate_window.append((time.monotonic(), self._emitted_total))
        self._collect_finished()
        free = self._free_slots()
        if self._queue and free:
            slot = free[0]
            req = self._queue.popleft()
            if self.speculative:
                ids = req.prompt_ids
                if ids is None:  # no drafting seed: sentinel row
                    ids = torch.full((1, self.prompt_buf), -1,
                                     dtype=torch.int64, device=self.device)
                self.state, tok0 = self._prefill(
                    self.state, req.embeds, ids, req.prompt_len, slot,
                    self._generator)
            else:
                self.state, tok0 = self._prefill(
                    self.state, req.embeds, req.prompt_len, slot,
                    self._generator)
            req.slot = slot
            req.embeds = None  # the prompt now lives in the cache
            self._append(req, int(tok0))  # the tick's one host read
            self._by_slot[slot] = req
            self._collect_finished()
            return True
        if self._by_slot:
            if self.speculative:
                kb_cur = self.spec_block_len
                if self.adaptive and kb_cur == 1:
                    # plain rung: kb=1 verify block on the same state;
                    # periodically climb one rung to probe speculation
                    self._plain_dispatches += 1
                    if self._plain_dispatches >= self.probe_every:
                        self._rung = min(self._rung + 1,
                                         len(self._kb_ladder) - 1)
                        self._plain_dispatches = 0
                        self._accept_window.clear()
                fn = self._decode_for(kb_cur)
                self.state, packed = fn(self.state, self._generator)
                packed = packed.cpu().tolist()  # the tick's one host read
                emitted = slot_steps = 0
                for slot, req in self._by_slot.items():
                    room = self.gen.max_new_tokens - len(req.tokens)
                    slot_steps += 1
                    row = packed[slot]
                    for t in row[: min(row[-1], room)]:
                        if req.finished:
                            break
                        self._append(req, t)
                        emitted += 1
                self.spec_stats["verify_steps"] += slot_steps
                self.spec_stats["emitted_tokens"] += emitted
                if self.adaptive and kb_cur > 1:
                    self._adapt(emitted, slot_steps)
            else:
                self.state, toks = self._decode(self.state, self._generator)
                toks = toks.cpu().tolist()  # the tick's one host read
                # every tracked slot had done=False before this step
                # (finished rows are collected first), so all emitted
                # tokens are real
                for slot, req in self._by_slot.items():
                    self._append(req, toks[slot])
            self._collect_finished()
            return True
        return bool(self._queue)

    def run(self) -> Dict[int, List[int]]:
        """Drive until every submitted request completes; returns
        rid -> generated token list."""
        while self._queue or self._by_slot:
            self.step()
        return dict(self._results)

    @torch.inference_mode()
    def abort_all(self) -> List[int]:
        """Drop every queued and in-flight request and free their slots;
        returns the affected rids. Completed results in ``_results`` are
        kept. The serving thread recovers from a step failure with it,
        without restarting the engine."""
        rids = ([r.rid for r in self._queue]
                + [r.rid for r in self._by_slot.values()])
        self._queue.clear()
        for slot in list(self._by_slot):
            self._release(slot)
        return rids


class EngineInference:
    """Thread-safe, concurrent drop-in for ``eval.inference.
    U2InferenceModel``: many callers' ``inference()`` requests share the
    slot pool (a engine thread owns the ``Engine``; each caller blocks on
    its own request only). Pass it to ``serve.U2Server``: it advertises
    ``concurrent = True`` so that the server takes no global lock.

    The arguments are the JAX package's, except that the model carries
    its weights: there is no ``params`` argument. ``model`` is a
    ``U2CausalLM`` (a ``U2InferenceModel``'s ``.model``) or a bare
    decoder, on ``device`` (the GPU unless the caller names another).

    Volumes stay on the host until the engine thread moves them to the
    device, so that the engine's thread makes every launch of the model;
    the engine thread sets its device and enters ``torch.inference_mode``
    itself (grad mode is per thread)."""

    concurrent = True

    def __init__(self, model, tokenizer, cfg,
                 max_new_tokens: int = 768, do_sample: bool = False,
                 top_p: float = 0.9, num_slots: int = 8,
                 prompt_buf: int = 1024, cache_dtype=torch.bfloat16,
                 question_len: int = 64, speculative=None,
                 block_len: int = 8, device="cuda"):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.question_len = question_len
        self.gen_cfg = GenerationConfig(
            max_new_tokens=max_new_tokens, do_sample=do_sample, top_p=top_p,
            eos_token_id=tokenizer.eos_token_id,
            pad_token_id=tokenizer.pad_token_id or 0)
        if speculative is None:
            # opt-in, as in the JAX package: greedy tokens are the same
            # either way, and the adaptive ladder ("auto") pays only on
            # template-heavy content
            speculative = False
        if speculative and do_sample:
            speculative = False  # the slot verify block is greedy-only
        self.engine = Engine(model, self.gen_cfg,
                             num_slots=num_slots, prompt_buf=prompt_buf,
                             cache_dtype=cache_dtype,
                             speculative=speculative, block_len=block_len,
                             device=device)
        self.device = self.engine.device
        self._cuda_index = None
        if self.device.type == "cuda":  # the engine thread's device
            self._cuda_index = (torch.cuda.current_device()
                                if self.device.index is None
                                else self.device.index)
        self._submit_q: "queue.Queue" = queue.Queue()
        self._cv = threading.Condition()
        self._results: Dict[int, List[int]] = {}
        self._errors: Dict[int, str] = {}      # local -> failure message
        self._pending_map: Dict[int, int] = {}
        self._streams: Dict[int, "queue.Queue"] = {}  # local -> token queue
        self._sent: Dict[int, int] = {}               # rid -> tokens pushed
        self._next_local = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._drive, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the engine thread (after its current tick), so that the
        engine's device memory can be freed. Callers still waiting get a
        RuntimeError."""
        self._stop.set()
        self._thread.join()

    def _check_engine_thread(self) -> None:
        if not self._thread.is_alive():
            raise RuntimeError("the engine's engine thread has stopped")

    @property
    def speculative(self) -> bool:
        return self.engine.speculative

    @property
    def spec_stats(self) -> Dict[str, int]:
        return self.engine.spec_stats

    @property
    def spec_mode(self) -> str:
        return self.engine.spec_mode

    @property
    def spec_block_len(self) -> int:
        return self.engine.spec_block_len

    @property
    def telemetry(self) -> Dict[str, Any]:
        t = self.engine.telemetry()
        t["pending_submits"] = self._submit_q.qsize()
        return t

    def _push_stream(self, local: int, tokens: List[int], start: int,
                     done: bool):
        q = self._streams.get(local)
        if q is None:
            return
        for t in tokens[start:]:
            q.put(int(t))
        if done:
            q.put(None)
            self._streams.pop(local, None)

    def _fail_local(self, local: int, msg: str) -> None:
        """Deliver a failure to one caller: wakes a blocked inference()
        (which raises) and ends its stream if it was streaming."""
        with self._cv:
            self._errors[local] = msg
            self._cv.notify_all()
        q = self._streams.pop(local, None)
        if q is not None:
            q.put(None)

    def _drive(self):
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        with torch.inference_mode():
            while not self._stop.is_set():
                if not self._tick():
                    time.sleep(0.002)

    def _tick(self) -> bool:
        """Take the submissions, then one engine step with its deliveries;
        False when nothing moved."""
        moved = False
        try:
            while True:
                local, ids, images, qids = self._submit_q.get_nowait()
                moved = True
                try:
                    rid = self.engine.submit(ids, images, qids)
                except Exception as e:  # noqa: BLE001 — one bad request
                    # must not kill the engine thread; fail that caller
                    self._fail_local(local, f"{type(e).__name__}: {e}")
                else:
                    self._pending_map[rid] = local
        except queue.Empty:
            pass
        if self.engine._queue or self.engine._by_slot:
            moved = True
            try:
                self.engine.step()
                # incremental token delivery for streaming callers
                for req in list(self.engine._by_slot.values()):
                    local = self._pending_map.get(req.rid)
                    if local is not None and local in self._streams:
                        sent = self._sent.get(req.rid, 0)
                        self._push_stream(local, req.tokens, sent, False)
                        self._sent[req.rid] = len(req.tokens)
                if self.engine._results:
                    with self._cv:
                        for rid in list(self.engine._results):
                            local = self._pending_map.pop(rid)
                            toks = self.engine._results.pop(rid)
                            if local in self._streams:
                                self._push_stream(
                                    local, toks, self._sent.pop(rid, 0),
                                    True)
                            else:
                                self._results[local] = toks
                        self._cv.notify_all()
            except Exception as e:  # noqa: BLE001
                # a step failure poisons every in-flight request but must
                # not kill the engine thread: abort them with the error, free the
                # slots, keep serving new submissions
                traceback.print_exc()
                for rid in self.engine.abort_all():
                    lcl = self._pending_map.pop(rid, None)
                    self._sent.pop(rid, None)
                    if lcl is not None:
                        self._fail_local(lcl, f"{type(e).__name__}: {e}")
        return moved

    def _encode_prompt(self, question: str, with_image: bool):
        prompt = question
        if with_image:
            prompt = "<im_patch>" * self.cfg.proj_out_num + question
        ids = self.tokenizer(prompt, add_special_tokens=False)["input_ids"]
        ids = ids[: self.engine.prompt_buf]
        q = self.tokenizer(question,
                           add_special_tokens=False)["input_ids"]
        qids = np.full((1, self.question_len), self.gen_cfg.pad_token_id,
                       np.int64)
        qids[0, : len(q[: self.question_len])] = q[: self.question_len]
        return np.asarray(ids, np.int64)[None], qids

    def _submit_local(self, image, question: str, stream: bool) -> int:
        with_image = image is not None
        images = None
        if with_image:
            arr = torch.as_tensor(image)
            expected = (self.cfg.num_chunks, *self.cfg.vision.input_spatial)
            if tuple(arr.shape) != expected:
                # reject in the caller's thread with an actionable message
                # (a bad shape must never reach the engine thread)
                raise ValueError(
                    f"volume shape {tuple(arr.shape)} does not match the "
                    f"model's chunk geometry {expected}; preprocess with "
                    "U2VolumeTransform (serve handles .nii/.nii.gz "
                    "automatically; .npy must already be chunked)")
            # a host copy: the engine thread moves it to the device
            images = arr.detach().to("cpu", torch.float32)[None]
        ids, qids = self._encode_prompt(question, with_image)
        with self._lock:
            local = self._next_local
            self._next_local += 1
            if stream:
                self._streams[local] = queue.Queue()
        self._submit_q.put((local, ids, images,
                            qids if with_image else None))
        return local

    def inference(self, image, question: str) -> str:
        """Blocking for each caller; concurrent across callers."""
        local = self._submit_local(image, question, stream=False)
        with self._cv:
            while local not in self._results and local not in self._errors:
                self._cv.wait(timeout=1.0)
                self._check_engine_thread()
            if local in self._errors:
                raise RuntimeError(self._errors.pop(local))
            toks = self._results.pop(local)
        keep = [t for t in toks if t not in (self.gen_cfg.pad_token_id,
                                             self.gen_cfg.eos_token_id)]
        return self.tokenizer.decode(keep, skip_special_tokens=True).strip()

    def inference_stream(self, image, question: str):
        """Generator of text deltas as the slot pool decodes this request
        (serve.py's SSE endpoints). Deltas concatenate to inference()'s
        output up to leading and trailing whitespace."""
        local = self._submit_local(image, question, stream=True)
        q = self._streams[local]
        toks: List[int] = []
        prev = ""
        skip = (self.gen_cfg.pad_token_id, self.gen_cfg.eos_token_id)
        while True:
            try:
                t = q.get(timeout=1.0)
            except queue.Empty:
                self._check_engine_thread()
                continue
            if t is None:
                with self._cv:
                    err = self._errors.pop(local, None)
                if err is not None:
                    raise RuntimeError(err)
                break
            if t in skip:
                continue
            toks.append(t)
            # re-decode the full prefix each time: merged tokens may change
            # earlier text, so only stable extensions of what was sent are
            # emitted
            text = self.tokenizer.decode(toks, skip_special_tokens=True)
            if text.startswith(prev) and len(text) > len(prev):
                yield text[len(prev):]
                prev = text
        text = self.tokenizer.decode(toks, skip_special_tokens=True)
        if text.startswith(prev) and len(text) > len(prev):
            yield text[len(prev):]
