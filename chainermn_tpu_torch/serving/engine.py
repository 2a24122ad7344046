"""Continuous-batching serving engine: prefill/decode split over paged KV.

Two programs share one paged KV cache:

* **prefill** (one request at a time): the prompt runs through the
  transformer's causal forward with attention on the flash kernel
  (``ops.attention``; the CUDA kernel on a card, the plain version on the
  CPU), each layer's K/V written into the request's pages; the last valid
  position's logits give the first generated token.  Prompts are padded
  to power-of-two buckets, as in the JAX engine.
* **decode** (the whole running batch, one token per sequence): per
  layer, write the token's K/V into its page, then
  :func:`~chainermn_tpu_torch.ops.paged_attention.paged_decode_attention`
  gathers each sequence's context through its block table.  The batch is
  padded to a power-of-two bucket with idle lanes (``pos = -1``).

**Copy-on-write prefix sharing** (``prefix_cache=True``): admission
matches the prompt against the allocator's prefix trie; matched pages
are shared (refcount++) and only the unmatched suffix prefills, through
:func:`prefix_prefill_program`, which reads the shared prefix through the
block table and runs no flash kernel over it.  A match ending mid-page
forks that page first (``copy_page``), so the borrower never writes into
the provider's bytes.

Scheduling (``serving.scheduler``): admission at decode-step granularity
with per-tenant round-robin fairness; when the pool runs dry the youngest
running sequence owning a unique page is evicted (pages freed, request
re-queued front-of-line with its tokens folded into the prompt).

The port is eager PyTorch: there are no jit programs, trace counters or
warm-up, and the pools are updated in place (the JAX engine's donation).
The JAX engine's disaggregated prefill, tensor-parallel decode,
speculative decoding and chunked prefill are not ported yet (ROADMAP
A13) and raise ``NotImplementedError``; its observability spans wait for
the observability item (ROADMAP A12).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .._device import resolve_device
from ..nn import functions as F
from ..ops import attention as flash_attention_op
from ..ops.paged_attention import (paged_attn_mode, paged_decode_attention,
                                   paged_prefill_attention)
from .errors import PagePoolExhaustedError
from .kv_cache import (PagedKVCache, copy_page, write_prompt_kv,
                       write_prompt_kv_at, write_token_kv)
from .page_allocator import BlockAllocator
from .scheduler import RequestScheduler

__all__ = ["ServingEngine", "prefill_program", "prefix_prefill_program",
           "decode_program"]


def _mlp(block, h):
    B, T, D = h.shape
    m = block.fc2(F.gelu(block.fc1(block.ln2(h).reshape(B * T, D))))
    return h + m.reshape(B, T, D)


def _qkv(block, h):
    """``[B, T, 3, H, Dh]`` projections of the block's normed input."""
    B, T, D = h.shape
    attn = block.attn
    return attn.qkv(block.ln1(h).reshape(B * T, D)).reshape(
        B, T, 3, attn.n_heads, attn.d_head)


def _last_logits(model, h, true_len):
    h_last = h[0, max(true_len - 1, 0)]
    return model.head(model.ln_f(h_last)[None])[0].float()


@torch.inference_mode()
def prefill_program(model, kv, tokens, true_len, bt_row):
    """Full causal forward over the (padded) prompt.

    ``tokens``: ``[1, Tb]`` int (positions ``>= true_len`` are padding:
    their K/V writes go to the trash page, and causality keeps them out of
    every valid position's attention).  Writes every layer's K/V into
    ``kv`` through ``bt_row`` and returns the fp32 ``[V]`` logits at
    position ``true_len - 1``."""
    B, T = tokens.shape
    pos = torch.arange(T, device=tokens.device).expand(B, T)
    h = model.embed_tokens(tokens, pos)
    for li, block in enumerate(model.blocks):
        qkv = _qkv(block, h)
        q, k, v = [qkv[:, :, j].transpose(1, 2) for j in range(3)]
        att = flash_attention_op(q, k, v, causal=True)
        att = att.transpose(1, 2).reshape(B * T, -1)
        h = h + block.attn.proj(att).reshape(B, T, -1)
        h = _mlp(block, h)
        write_prompt_kv(kv.k_store[li], qkv[0, :, 1], bt_row, true_len)
        write_prompt_kv(kv.v_store[li], qkv[0, :, 2], bt_row, true_len)
    return _last_logits(model, h, true_len)


@torch.inference_mode()
def prefix_prefill_program(model, kv, tokens, true_len, start, bt_row):
    """Suffix prefill for a prefix-shared request.

    ``tokens``: ``[1, Tb]`` suffix tokens (positions ``>= true_len``
    padding); suffix index ``t`` sits at absolute position ``start + t``.
    ``bt_row`` covers the whole context (shared prefix pages and the
    request's own suffix pages).  Per layer the suffix's K/V are written
    first, then :func:`paged_prefill_attention` reads the whole context
    back -- no flash kernel touches the shared pages.  Returns the fp32
    logits at suffix position ``true_len - 1``."""
    B, T = tokens.shape
    # padding past the last position embedding reads the last one (where
    # the JAX gather clamps); causality keeps it out of every valid query
    pos = (start + torch.arange(T, device=tokens.device)).clamp_max(
        model.pos_embed.W.shape[0] - 1).expand(B, T)
    h = model.embed_tokens(tokens, pos)
    scale = 1.0 / (model.blocks[0].attn.d_head ** 0.5)
    for li, block in enumerate(model.blocks):
        qkv = _qkv(block, h)
        write_prompt_kv_at(kv.k_store[li], qkv[0, :, 1], bt_row, start,
                           true_len)
        write_prompt_kv_at(kv.v_store[li], qkv[0, :, 2], bt_row, start,
                           true_len)
        att = paged_prefill_attention(qkv[0, :, 0], kv.k_pool[li],
                                      kv.v_pool[li], bt_row, start,
                                      true_len, scale=scale)
        h = h + block.attn.proj(att.reshape(B * T, -1)).reshape(B, T, -1)
        h = _mlp(block, h)
    return _last_logits(model, h, true_len)


@torch.inference_mode()
def decode_program(model, kv, toks, pos, bts, *, mode):
    """One decode step, one token per batch lane.

    ``toks``/``pos``: ``[Bb]`` int (``pos < 0`` marks an idle lane: its
    K/V write goes to the trash page and its context is empty).  ``bts``:
    ``[Bb, N]`` block tables.  Writes each lane's K/V at ``pos``, then
    attends over ``[0, pos]``.  Returns ``(logits [Bb, V] fp32, next_tok
    [Bb] int32)``."""
    Bb = toks.shape[0]
    h = model.embed_tokens(toks, pos.clamp_min(0))[:, None]   # [Bb, 1, D]
    ctx_len = torch.where(pos >= 0, pos + 1, torch.zeros_like(pos))
    scale = 1.0 / (model.blocks[0].attn.d_head ** 0.5)
    for li, block in enumerate(model.blocks):
        qkv = _qkv(block, h)[:, 0]                           # [Bb, 3, H, Dh]
        write_token_kv(kv.k_store[li], qkv[:, 1], bts, pos)
        write_token_kv(kv.v_store[li], qkv[:, 2], bts, pos)
        att = paged_decode_attention(qkv[:, 0], kv.k_pool[li],
                                     kv.v_pool[li], bts, ctx_len,
                                     scale=scale, mode=mode)
        h = h + block.attn.proj(att.reshape(Bb, -1))[:, None]
        h = _mlp(block, h)
    logits = model.head(model.ln_f(h[:, 0])).float()
    return logits, torch.argmax(logits, dim=-1).to(torch.int32)


def _bucket(n, buckets, what):
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{what} {n} exceeds the largest bucket "
                     f"{buckets[-1]}")


def _pow2_buckets(lo, hi):
    out = []
    b = lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(out)


def _not_ported(name, value):
    raise NotImplementedError(
        f"ServingEngine({name}={value!r}) is not ported to "
        f"chainermn_tpu_torch yet (ROADMAP A13: disaggregated prefill, "
        f"tensor-parallel decode, speculative decoding and chunked "
        f"prefill)")


class ServingEngine:
    """Continuous-batching engine over a ``TransformerLM``.

    Greedy sampling.  ``prefix_cache``: copy-on-write prefix sharing
    (default on).  ``mode``: the decode attention lowering (``paged`` or
    ``dense``, see :func:`paged_attn_mode`).  ``device``: where the pools
    live; the model must already be there.  ``disagg``, ``tp``,
    ``spec_k``, ``draft_model`` and ``chunk_tokens`` keep the JAX
    engine's signature and raise ``NotImplementedError`` unless left at
    their defaults.

    Counters: ``full_prefills`` (prefills through the flash kernel),
    ``prefix_hits``/``prefix_tokens_matched``, ``forks``, ``evictions``,
    ``admissions``, ``decode_steps``; ``prefill_s``/``decode_s`` are the
    host-clock seconds spent in prefills (first token fetched) and in
    decode steps (tokens fetched), each ending in a device sync.
    """

    def __init__(self, model, num_pages=256, page_size=16, max_batch=8,
                 max_context=256, page_dtype=None, max_queue=256,
                 scheduler=None, mode=None, eos_id=None,
                 prefix_cache=True, disagg=None, tp=1, spec_k=0,
                 draft_model=None, chunk_tokens=None, device=None):
        for name, value, default in (
                ("disagg", disagg, None), ("tp", tp, 1),
                ("spec_k", spec_k, 0), ("draft_model", draft_model, None),
                ("chunk_tokens", chunk_tokens, None)):
            if value != default and not (name == "disagg"
                                         and value is False):
                _not_ported(name, value)
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lies on {model.device}, the engine "
                             f"on {self.device}: move one of them")
        blk = model.blocks[0].attn
        max_len = model.pos_embed.W.shape[0]
        if max_context > max_len:
            raise ValueError(f"max_context={max_context} exceeds the "
                             f"model's max_len={max_len}")
        if page_dtype is None:
            page_dtype = model.compute_dtype or torch.float32
        self.model = model
        self.kv = PagedKVCache(len(model.blocks), num_pages, page_size,
                               blk.n_heads, blk.d_head, dtype=page_dtype,
                               device=self.device)
        self.allocator = BlockAllocator(num_pages, page_size)
        self.scheduler = scheduler or RequestScheduler(max_queue=max_queue)
        self.max_batch = int(max_batch)
        self.max_context = int(max_context)
        self.n_block_entries = -(-self.max_context // page_size)
        self.mode = paged_attn_mode(mode)
        self.eos_id = eos_id
        self.prefix_cache = bool(prefix_cache)
        self.prefill_buckets = _pow2_buckets(min(16, self.max_context),
                                             self.max_context)
        self.batch_buckets = _pow2_buckets(1, self.max_batch)
        self.running = []       # admission order, oldest first
        self.completed = []
        self.evictions = 0
        self.decode_steps = 0
        self.admissions = 0
        self.full_prefills = 0
        self.prefix_hits = 0
        self.prefix_tokens_matched = 0
        self.forks = 0
        self.prefill_s = 0.0
        self.decode_s = 0.0

    # -- ingress -------------------------------------------------------------

    def submit(self, request):
        """Queue a request.  A request whose full eventual context
        (prompt + max_new_tokens) could never fit is rejected here, typed,
        instead of livelocking admission later (eviction frees only other
        sequences' pages)."""
        total = request.prompt.size + request.max_new_tokens
        if total > self.max_context:
            raise ValueError(
                f"request needs {total} positions, engine "
                f"max_context={self.max_context}")
        if self.allocator.pages_for(total) > self.allocator.num_pages:
            raise PagePoolExhaustedError(
                self.allocator.pages_for(total),
                self.allocator.num_pages, self.allocator.num_pages)
        self.scheduler.submit(request)

    # -- internals -----------------------------------------------------------

    def _tensor(self, array):
        return torch.from_numpy(array).to(self.device)

    def _bt_row(self, seq_id):
        row = np.zeros(self.n_block_entries, dtype=np.int64)
        table = self.allocator.block_table(seq_id)
        row[:len(table)] = table
        return row

    def _padded_tokens(self, toks):
        Tb = _bucket(len(toks), self.prefill_buckets, "prompt length")
        tokens = np.zeros((1, Tb), dtype=np.int64)
        tokens[0, :len(toks)] = toks
        return self._tensor(tokens)

    def _record_token(self, req, tok, now):
        req.tokens.append(int(tok))
        req.token_times.append(now)
        if req.first_token_time is None:
            req.first_token_time = now

    def _finished(self, req):
        if len(req.tokens) >= req.max_new_tokens:
            return True
        return self.eos_id is not None and req.tokens \
            and req.tokens[-1] == self.eos_id

    def _retire(self, req, now):
        self.allocator.free(req.request_id)
        self.running.remove(req)
        req.finish_time = now
        self.completed.append(req)

    def _evict(self, req):
        """Preemption: free pages (shared pages stay alive through their
        other holders), fold generated tokens into the prompt, re-queue
        front-of-line (recompute on re-admit)."""
        self.allocator.free(req.request_id)
        self.running.remove(req)
        self.scheduler.requeue_front(req)
        self.evictions += 1

    def _run_fork(self, src, dst):
        copy_page(self.kv.k_store, self.kv.v_store, src, dst)
        self.forks += 1

    def _run_prefix_prefill(self, req, L, matched):
        """Prefix hit: prefill only the unmatched suffix."""
        return prefix_prefill_program(
            self.model, self.kv, self._padded_tokens(req.prompt[matched:]),
            L - matched, matched, self._tensor(self._bt_row(req.request_id)))

    def _admit(self, req, clock):
        """Pages + prefill + first token.  Raises PagePoolExhaustedError
        (allocator untouched: a partial share is rolled back) when the pool
        cannot hold the prompt.

        The prefix match is capped at ``L - 1`` so prefill always has a
        suffix token to produce the first logits; a match ending mid-page
        forks that page before the suffix's first write."""
        L = int(req.prompt.size)
        sid = req.request_id
        matched = 0
        prompt_t = tuple(int(t) for t in req.prompt) \
            if self.prefix_cache else ()
        if self.prefix_cache and L > 1:
            pages, matched, n_full, partial = \
                self.allocator.match_prefix(prompt_t, L - 1)
            if matched:
                # host-side allocation first (rolled back on failure), the
                # device page copy only once admission cannot fail
                self.allocator.share(sid, pages)
                old = new = None
                try:
                    if partial:
                        old, new = self.allocator.fork(sid, n_full)
                    self.allocator.ensure(sid, L + 1)   # +1: first decode
                except PagePoolExhaustedError:
                    self.allocator.free(sid)
                    raise
                if new is not None and old != new:
                    self._run_fork(old, new)
        if not matched:
            self.allocator.ensure(sid, L + 1)
        t0 = time.perf_counter()
        if matched:
            logits = self._run_prefix_prefill(req, L, matched)
            self.prefix_hits += 1
            self.prefix_tokens_matched += matched
        else:
            logits = prefill_program(self.model, self.kv,
                                     self._padded_tokens(req.prompt), L,
                                     self._tensor(self._bt_row(sid)))
            self.full_prefills += 1
        self.admissions += 1
        if self.prefix_cache:
            self.allocator.register_prefix(sid, prompt_t)
        tok = int(torch.argmax(logits))   # device -> host sync
        self.prefill_s += time.perf_counter() - t0
        req._ctx = L            # positions whose KV is written
        t = clock()
        self._record_token(req, tok, t)
        self.running.append(req)
        if self._finished(req):
            self._retire(req, t)

    # -- the step loop -------------------------------------------------------

    def step(self, now=None):
        """One continuous-batching step: secure every running sequence's
        next page (evicting when the pool is dry), an admission pass, then
        one decode step over the running batch.  Returns step stats.

        ``now=None`` stamps tokens with ``time.monotonic()``; a pinned
        ``now`` (tests, simulated clocks) stamps the whole step with it."""
        clock = time.monotonic if now is None else (lambda: now)
        stats = {"admitted": 0, "evicted_before": self.evictions}
        # capacity first: admitting into pages the running batch is about
        # to need would get the newcomer evicted in the same step
        i = 0
        while i < len(self.running):
            req = self.running[i]
            try:
                self.allocator.ensure(req.request_id, req._ctx + 1)
                i += 1
            except PagePoolExhaustedError:
                victim = self.scheduler.pick_victim(self.running,
                                                    self.allocator)
                self._evict(victim)
                # the victim may be req: re-check the same index
        while len(self.running) < self.max_batch:
            req = self.scheduler.next_admission(arrived_by=clock())
            if req is None:
                break
            try:
                self._admit(req, clock)
                stats["admitted"] += 1
            except PagePoolExhaustedError:
                # pool full: wait (admission never preempts running work)
                self.scheduler.requeue_front(req, preempted=False)
                break
        n = len(self.running)
        stats["evicted"] = self.evictions - stats.pop("evicted_before")
        stats["running"] = n
        stats["occupancy"] = (self.allocator.used_pages
                              / self.allocator.num_pages)
        if n == 0:
            stats["decoded"] = 0
            return stats
        Bb = _bucket(n, self.batch_buckets, "batch")
        toks = np.zeros(Bb, dtype=np.int64)
        pos = np.full(Bb, -1, dtype=np.int64)
        bts = np.zeros((Bb, self.n_block_entries), dtype=np.int64)
        for j, req in enumerate(self.running):
            toks[j] = req.tokens[-1]
            pos[j] = req._ctx
            bts[j] = self._bt_row(req.request_id)
        t0 = time.perf_counter()
        _, nxt = decode_program(self.model, self.kv, self._tensor(toks),
                                self._tensor(pos), self._tensor(bts),
                                mode=self.mode)
        nxt = nxt.cpu().numpy()      # device -> host sync
        self.decode_s += time.perf_counter() - t0
        self.decode_steps += 1
        t_tok = clock()
        for j, req in enumerate(list(self.running)):
            req._ctx += 1
            self._record_token(req, nxt[j], t_tok)
            if self._finished(req):
                self._retire(req, t_tok)
        stats["decoded"] = n
        return stats

    def drain(self, max_steps=10000, now=None):
        """Run steps until the queues and the running batch are empty.
        Returns the number of steps taken."""
        steps = 0
        while (self.running or self.scheduler.pending()) \
                and steps < max_steps:
            self.step(now=now)
            steps += 1
        return steps
