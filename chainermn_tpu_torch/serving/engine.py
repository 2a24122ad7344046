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

Observability (``CHAINERMN_TPU_TRACE``, the JAX engine's spans and
metrics): each request's lifecycle rides a track of its own
(``serve/queue_wait``, measured on the engine's clock from arrival, or
from the eviction that re-queued it, and tagged ``readmit``;
``serve/prefill`` or ``serve/suffix_prefill``; the ``serve/finish`` and
``serve/evict`` instants), decode steps run in ``serve/decode_window``
spans, forks leave ``serve/fork`` instants and ships
``serve/page_transfer`` instants on the request's track; the registry
keeps the queue-wait histogram, the per-tenant queue depth and the
eviction, fork and shipped-byte counters.

**Speculative decoding** (``spec_k=K``): a draft proposes K tokens per
sequence per step, the n-gram self-draft (:func:`ngram_propose`, pure
host work) by default or a small ``draft_model=`` whose pages are indexed
by the same block tables; the target scores all ``K + 1`` positions in
one :func:`spec_verify_program` and the host accepts the longest prefix
that agrees with its greedy argmax, so the emitted tokens are vanilla
greedy decode's (in bf16 the verify's products, of another shape than a
decode step's, can flip a near-tie of the top two logits).  A rejected
proposal is rolled back by rewinding the lane's position.  ``CHAINERMN_TPU_SERVE_SPEC=off`` turns it off.

**Chunked prefill** (``chunk_tokens=C``, a page multiple): a prompt whose
unmatched remainder exceeds ``C`` admits in chunks of ``C`` tokens, run
between the admission pass and the decode step under a per-step budget
(``chunk_budget``), so a long prompt does not hold whole steps while
short requests wait.  Chunks run :func:`prefix_prefill_program` at the
chunk cursor (chunk 0 at ``start=0``), so they launch no flash kernel;
prefill buckets stop at ``C``; a mid-chunk request is an eviction victim
before any decoding one (pages freed, cursor reset, chunk 0 again on
re-admission).

**Disaggregated prefill** (``disagg=True``, or
``CHAINERMN_TPU_SERVE_DISAGG``, see :func:`serve_disagg_mode`): a prefix
miss prefills on the prefill device against a scratch pool (identity
block table), and its finished pages ship into the decode pool
(:func:`~.kv_cache.extract_pages`, ``.to`` the decode device: a device
copy on one card, a peer copy across cards, then
:func:`~.kv_cache.insert_pages`), metered by ``transfers`` and
``transferred_page_bytes``.  A prefix-miss chunk stream runs its chunks
against the scratch pool too and ships once, after its last chunk; the
one scratch pool holds one such stream at a time, so a second one waits
at admission (``deferred_admissions``), and so does a one-shot miss once
the stream has written a chunk (the JAX engine lets it overwrite them).  Prefix hits, suffix prefills
and the draft model's prefill stay on the decode pool.

**Tensor-parallel decode** (``tp=K`` over ``tp_comm``, a communicator of
``K`` ranks): the JAX engine shards its pools over the heads of a ``tp``
mesh and leaves the rest to GSPMD; the port is MPMD, one process a rank.
Rank ``r`` holds heads ``[r H / K, (r + 1) H / K)`` in its pools
(:func:`~chainermn_tpu_torch.ops.paged_attention.head_slice`); each
program computes the whole ``qkv`` with the replicated weights, writes
and attends over this rank's heads (the flash kernel at ``H / K`` heads
in a prefill) and all-gathers the attention output along the heads
before ``proj``; layer norms, the MLP and the head run whole on every
rank.  The ranks run the same host loop in lockstep, fed the same
requests in the same order (and the same ``now``, or requests that have
all arrived), and the tokens of each dispatch (an admission's first
token, the decode argmax, the verify's argmax row, a draft model's
proposals) come from rank 0 through one broadcast, so a near-tie cannot
split the ranks' schedulers.

The port is eager PyTorch: there are no jit programs or trace counters,
and the pools are updated in place (the JAX engine's donation).
:meth:`ServingEngine.warmup` runs one idle dispatch of each padded shape
instead of the JAX engine's compiles, so that a replica's first request
pays no first-use cost.
"""

from __future__ import annotations

import copy
import os
import time
import zlib

import numpy as np
import torch

from .. import observability
from .._device import resolve_device
from ..nn import functions as F
from ..ops import attention as flash_attention_op
from ..ops.paged_attention import (head_slice, paged_attn_mode,
                                   paged_decode_attention,
                                   paged_prefill_attention,
                                   paged_verify_attention)
from .errors import PagePoolExhaustedError
from .kv_cache import (PagedKVCache, copy_page, extract_pages, insert_pages,
                       write_prompt_kv, write_prompt_kv_at, write_span_kv,
                       write_token_kv)
from .page_allocator import BlockAllocator
from .scheduler import RequestScheduler

__all__ = ["ServingEngine", "prefill_program", "prefix_prefill_program",
           "decode_program", "spec_verify_program", "ngram_propose",
           "serve_disagg_mode", "serve_spec_k"]


def serve_disagg_mode(disagg=None):
    """Resolve the disaggregation knob: ``CHAINERMN_TPU_SERVE_DISAGG=off``
    is the single-mesh escape hatch and wins over everything (the
    disagg-on trajectory is pinned identical to it, so the hatch is
    always safe); ``on``/``1`` enables when the constructor left the
    argument ``None``; default off.  Resolved ONCE at engine
    construction, like the paged-attention mode."""
    env = os.environ.get("CHAINERMN_TPU_SERVE_DISAGG", "").lower()
    if env == "off":
        return False
    if disagg is not None:
        return bool(disagg)
    return env in ("on", "1")


def serve_spec_k(spec_k=0):
    """Resolve the speculative-decoding knob:
    ``CHAINERMN_TPU_SERVE_SPEC=off`` forces one-token decode whatever the
    constructor says (always safe: the speculative output is vanilla
    greedy decode's).  Resolved once, at engine construction."""
    if os.environ.get("CHAINERMN_TPU_SERVE_SPEC", "").lower() == "off":
        return 0
    return int(spec_k or 0)


def ngram_propose(history, k, n=3):
    """The built-in self-speculative draft: prompt-lookup n-gram match.

    Deterministic and pure host work: find the most recent EARLIER
    occurrence of the trailing ``n``-gram of ``history`` (falling back
    to shorter grams down to 1) and propose the ``k`` tokens that
    followed it; pad by repeating the last token when the match runs
    off the end (or nothing matches).  Draft quality only moves the
    accept rate — greedy accept/reject makes the emitted trajectory
    independent of WHAT is proposed, so this needs no model at all.
    """
    h = np.asarray(history, dtype=np.int64)
    L = h.size
    if k <= 0:
        return np.zeros(0, dtype=np.int32)
    out = None
    for g in range(min(n, L - 1), 0, -1):
        tail = h[L - g:]
        # candidate gram ends at i + g (exclusive), strictly before L
        for i in range(L - g - 1, -1, -1):
            if np.array_equal(h[i:i + g], tail):
                out = h[i + g:i + g + k]
                break
        if out is not None:
            break
    if out is None:
        out = h[L - 1:]          # no match: repeat the last token
    prop = np.empty(k, dtype=np.int32)
    m = min(k, out.size)
    prop[:m] = out[:m]
    prop[m:] = int(out[m - 1]) if m else int(h[-1])
    return prop


def _mlp(block, h):
    B, T, D = h.shape
    m = block.fc2(F.gelu(block.fc1(block.ln2(h).reshape(B * T, D))))
    return h + m.reshape(B, T, D)


def _qkv(block, h, tp_comm=None):
    """``[B, T, 3, H_local, Dh]``: the block's normed input projected whole
    (the weights are replicated), then this rank's heads
    (:func:`~chainermn_tpu_torch.ops.paged_attention.head_slice`; every
    head without ``tp_comm``)."""
    B, T, D = h.shape
    attn = block.attn
    qkv = attn.qkv(block.ln1(h).reshape(B * T, D)).reshape(
        B, T, 3, attn.n_heads, attn.d_head)
    if tp_comm is None:
        return qkv
    return qkv[:, :, :, head_slice(attn.n_heads, tp_comm)]


def _gather_heads(att, tp_comm):
    """``[..., H_local, Dh]`` attention outputs to ``[..., H, Dh]``: every
    rank's heads in rank order, through one all-gather (a failed gather
    raises)."""
    if tp_comm is None:
        return att
    return torch.cat(tp_comm.allgather(att), dim=-2).to(att.device)


def _last_logits(model, h, true_len):
    h_last = h[0, max(true_len - 1, 0)]
    return model.head(model.ln_f(h_last)[None])[0].float()


@torch.inference_mode()
def prefill_program(model, kv, tokens, true_len, bt_row, tp_comm=None):
    """Full causal forward over the (padded) prompt.

    ``tokens``: ``[1, Tb]`` int (positions ``>= true_len`` are padding:
    their K/V writes go to the trash page, and causality keeps them out of
    every valid position's attention).  Writes every layer's K/V into
    ``kv`` through ``bt_row`` and returns the fp32 ``[V]`` logits at
    position ``true_len - 1``.  ``tp_comm``: tensor parallelism, ``kv``
    holds this rank's heads and the flash kernel runs over them."""
    B, T = tokens.shape
    pos = torch.arange(T, device=tokens.device).expand(B, T)
    h = model.embed_tokens(tokens, pos)
    for li, block in enumerate(model.blocks):
        qkv = _qkv(block, h, tp_comm)
        q, k, v = [qkv[:, :, j].transpose(1, 2) for j in range(3)]
        att = _gather_heads(
            flash_attention_op(q, k, v, causal=True).transpose(1, 2),
            tp_comm)
        h = h + block.attn.proj(att.reshape(B * T, -1)).reshape(B, T, -1)
        h = _mlp(block, h)
        write_prompt_kv(kv.k_store[li], qkv[0, :, 1], bt_row, true_len)
        write_prompt_kv(kv.v_store[li], qkv[0, :, 2], bt_row, true_len)
    return _last_logits(model, h, true_len)


@torch.inference_mode()
def prefix_prefill_program(model, kv, tokens, true_len, start, bt_row,
                           tp_comm=None):
    """Suffix prefill for a prefix-shared request.

    ``tokens``: ``[1, Tb]`` suffix tokens (positions ``>= true_len``
    padding); suffix index ``t`` sits at absolute position ``start + t``.
    ``bt_row`` covers the whole context (shared prefix pages and the
    request's own suffix pages).  Per layer the suffix's K/V are written
    first, then :func:`paged_prefill_attention` reads the whole context
    back -- no flash kernel touches the shared pages.  Returns the fp32
    logits at suffix position ``true_len - 1``.  ``tp_comm`` as in
    :func:`prefill_program`."""
    B, T = tokens.shape
    # padding past the last position embedding reads the last one (where
    # the JAX gather clamps); causality keeps it out of every valid query
    pos = (start + torch.arange(T, device=tokens.device)).clamp_max(
        model.pos_embed.W.shape[0] - 1).expand(B, T)
    h = model.embed_tokens(tokens, pos)
    scale = 1.0 / (model.blocks[0].attn.d_head ** 0.5)
    for li, block in enumerate(model.blocks):
        qkv = _qkv(block, h, tp_comm)
        write_prompt_kv_at(kv.k_store[li], qkv[0, :, 1], bt_row, start,
                           true_len)
        write_prompt_kv_at(kv.v_store[li], qkv[0, :, 2], bt_row, start,
                           true_len)
        att = _gather_heads(
            paged_prefill_attention(qkv[0, :, 0], kv.k_pool[li],
                                    kv.v_pool[li], bt_row, start, true_len,
                                    scale=scale), tp_comm)
        h = h + block.attn.proj(att.reshape(B * T, -1)).reshape(B, T, -1)
        h = _mlp(block, h)
    return _last_logits(model, h, true_len)


@torch.inference_mode()
def decode_program(model, kv, toks, pos, bts, *, mode, tp_comm=None):
    """One decode step, one token per batch lane.

    ``toks``/``pos``: ``[Bb]`` int (``pos < 0`` marks an idle lane: its
    K/V write goes to the trash page and its context is empty).  ``bts``:
    ``[Bb, N]`` block tables.  Writes each lane's K/V at ``pos``, then
    attends over ``[0, pos]``.  ``tp_comm`` as in :func:`prefill_program`
    (the pools hold this rank's heads).  Returns ``(logits [Bb, V] fp32,
    next_tok [Bb] int32)``."""
    Bb = toks.shape[0]
    h = model.embed_tokens(toks, pos.clamp_min(0))[:, None]   # [Bb, 1, D]
    ctx_len = torch.where(pos >= 0, pos + 1, torch.zeros_like(pos))
    scale = 1.0 / (model.blocks[0].attn.d_head ** 0.5)
    for li, block in enumerate(model.blocks):
        qkv = _qkv(block, h, tp_comm)[:, 0]        # [Bb, 3, H_local, Dh]
        write_token_kv(kv.k_store[li], qkv[:, 1], bts, pos)
        write_token_kv(kv.v_store[li], qkv[:, 2], bts, pos)
        att = _gather_heads(
            paged_decode_attention(qkv[:, 0], kv.k_pool[li], kv.v_pool[li],
                                   bts, ctx_len, scale=scale, mode=mode),
            tp_comm)
        h = h + block.attn.proj(att.reshape(Bb, -1))[:, None]
        h = _mlp(block, h)
    logits = model.head(model.ln_f(h[:, 0])).float()
    return logits, torch.argmax(logits, dim=-1).to(torch.int32)


@torch.inference_mode()
def spec_verify_program(model, kv, toks, start, n_valid, bts, tp_comm=None):
    """The speculative verify step: score ``K + 1`` tokens per lane at once.

    ``toks``: ``[Bb, K1]`` int, lane ``b``'s pending token then its K
    proposals; token ``j`` sits at position ``start[b] + j``.  ``start``:
    ``[Bb]`` (``< 0`` marks an idle lane).  ``n_valid``: ``[Bb]``, only the
    first ``n_valid[b]`` slots write K/V (a lane near its budget
    speculates short).  Per layer the span's K/V are written first
    (:func:`~.kv_cache.write_span_kv`), then
    :func:`~chainermn_tpu_torch.ops.paged_attention.paged_verify_attention`
    lets query ``j`` see positions ``<= start + j``, the context a
    one-token decode step there would see, so ``g[b, j]`` is the token
    vanilla decode would emit after tokens ``0..j``.  ``tp_comm`` as in
    :func:`prefill_program`.  Returns ``(logits [Bb, K1, V] fp32, g [Bb,
    K1] int32)``."""
    Bb, K1 = toks.shape
    # slots past a lane's n_valid may run past the position table, where
    # the JAX gather clamps; their outputs are never read
    pos = (start.clamp_min(0)[:, None]
           + torch.arange(K1, device=toks.device)[None]).clamp_max(
        model.pos_embed.W.shape[0] - 1)
    h = model.embed_tokens(toks, pos)                      # [Bb, K1, D]
    scale = 1.0 / (model.blocks[0].attn.d_head ** 0.5)
    for li, block in enumerate(model.blocks):
        qkv = _qkv(block, h, tp_comm)        # [Bb, K1, 3, H_local, Dh]
        write_span_kv(kv.k_store[li], qkv[:, :, 1], bts, start, n_valid)
        write_span_kv(kv.v_store[li], qkv[:, :, 2], bts, start, n_valid)
        att = _gather_heads(
            paged_verify_attention(qkv[:, :, 0], kv.k_pool[li],
                                   kv.v_pool[li], bts, start, scale=scale),
            tp_comm)
        h = h + block.attn.proj(att.reshape(Bb * K1, -1)).reshape(
            Bb, K1, -1)
        h = _mlp(block, h)
    logits = model.head(model.ln_f(h.reshape(Bb * K1, -1))).reshape(
        Bb, K1, -1).float()
    return logits, torch.argmax(logits, dim=-1).to(torch.int32)


class _AdmitDeferred(Exception):
    """This request cannot admit this step (the one disaggregated scratch
    pool is mid-chunk for another prompt): requeued front-of-line, it
    retries next step.  Never leaves the engine."""


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


class ServingEngine:
    """Continuous-batching engine over a ``TransformerLM``.

    Greedy sampling.  ``prefix_cache``: copy-on-write prefix sharing
    (default on).  ``mode``: the decode attention lowering (``paged`` or
    ``dense``, see :func:`paged_attn_mode`).  ``device``: where the pools
    live; the model must already be there.  ``spec_k``: speculative
    decoding, K proposals verified per sequence per decode dispatch (0:
    one-token decode; ``CHAINERMN_TPU_SERVE_SPEC=off`` forces 0).
    ``draft_model``: a small ``TransformerLM`` with the same vocabulary,
    on the engine's device, whose pages the same block tables index
    (``None``: the n-gram self-draft).  ``chunk_tokens``: chunked prefill,
    prompts whose unmatched remainder exceeds it admit in chunks of that
    many tokens (a page multiple; ``None``: one-shot prefill).
    ``chunk_budget``: prefill tokens advanced per step (default one
    chunk).  ``disagg``: disaggregated prefill (``None``: the
    ``CHAINERMN_TPU_SERVE_DISAGG`` knob, :func:`serve_disagg_mode`) on
    ``prefill_device`` (default the engine's device, what the JAX
    default gives on a one-card host; another device prefills with a copy
    of the model); ``decode_device`` is the engine's ``device`` under the
    JAX name.  ``tp``: tensor-parallel decode over ``tp_comm``, a
    communicator of exactly ``tp`` ranks on the engine's device type,
    every rank constructing the engine with the same model and feeding it
    the same requests (``tp=1`` with a communicator of one runs the same
    path at a group of one).

    Counters: ``full_prefills`` (target prefills through the flash
    kernel, disaggregated ones included; a draft model's prefill, one per
    admission, runs it too), ``prefix_hits``/``prefix_tokens_matched``,
    ``forks``, ``evictions``, ``admissions``, ``decode_steps`` (decode or
    verify dispatches); speculation's ``spec_steps``, ``spec_lane_steps``
    (lanes summed over verify steps), ``spec_proposed``,
    ``spec_accepted``, ``spec_emitted`` and ``draft_dispatches``;
    chunking's ``chunk_prefills`` and ``chunked_admissions``;
    disaggregation's ``transfers``, ``transferred_page_bytes`` (this
    rank's: bucket padding included, summed over a tp group the JAX
    engine's count) and ``deferred_admissions`` (a prefix miss waiting
    for the scratch pool).
    ``prefill_s``/``decode_s``/``draft_s`` are
    host-clock seconds: prefills up to the first token's fetch (a chunk
    that is not the last returns without a sync, its device time landing
    in the next sync), decode or verify steps up to the tokens' fetch, and
    the drafts' proposals (the n-gram scan, or the draft model's
    dispatches up to their fetch).
    """

    def __init__(self, model, num_pages=256, page_size=16, max_batch=8,
                 max_context=256, page_dtype=None, max_queue=256,
                 scheduler=None, mode=None, eos_id=None,
                 prefix_cache=True, disagg=None, tp=1,
                 prefill_device=None, decode_device=None, spec_k=0,
                 draft_model=None, chunk_tokens=None, chunk_budget=None,
                 device=None, tp_comm=None):
        if decode_device is not None:
            if device is not None and resolve_device(device) \
                    != resolve_device(decode_device):
                raise ValueError(
                    f"decode_device={decode_device!r} and device="
                    f"{device!r} name two devices: the decode device is "
                    f"the engine's")
            device = decode_device
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lies on {model.device}, the engine "
                             f"on {self.device}: move one of them")
        blk = model.blocks[0].attn
        max_len = model.pos_embed.W.shape[0]
        if max_context > max_len:
            raise ValueError(f"max_context={max_context} exceeds the "
                             f"model's max_len={max_len}")
        self.tp = int(tp)
        if self.tp < 1 or blk.n_heads % self.tp:
            raise ValueError(f"tp={tp} must divide n_heads={blk.n_heads}")
        if tp_comm is None and self.tp > 1:
            raise ValueError(f"tp={tp} needs tp_comm, a communicator of "
                             f"{tp} ranks")
        if tp_comm is not None:
            if tp_comm.size != self.tp:
                raise ValueError(f"tp={tp} needs a communicator of {tp} "
                                 f"ranks, tp_comm has {tp_comm.size}")
            if tp_comm.device.type != self.device.type:
                raise ValueError(f"tp_comm serves {tp_comm.device}, the "
                                 f"engine runs on {self.device}")
        self.tp_comm = tp_comm
        if page_dtype is None:
            page_dtype = model.compute_dtype or torch.float32
        self.model = model
        n_layers = len(model.blocks)
        # this rank's heads (all of them without tp)
        n_heads = blk.n_heads // self.tp
        self.kv = PagedKVCache(n_layers, num_pages, page_size, n_heads,
                               blk.d_head, dtype=page_dtype,
                               device=self.device)
        self.allocator = BlockAllocator(num_pages, page_size)
        self.scheduler = scheduler or RequestScheduler(max_queue=max_queue)
        self.max_batch = int(max_batch)
        self.max_context = int(max_context)
        self.n_block_entries = -(-self.max_context // page_size)
        self.mode = paged_attn_mode(mode)
        self.eos_id = eos_id
        self.prefix_cache = bool(prefix_cache)
        self.spec_k = serve_spec_k(spec_k)
        if self.spec_k < 0:
            raise ValueError(f"spec_k={spec_k} must be >= 0")
        self.draft_model = draft_model if self.spec_k else None
        self.chunk_tokens = int(chunk_tokens) if chunk_tokens else None
        if self.chunk_tokens is not None:
            if self.chunk_tokens % page_size:
                raise ValueError(
                    f"chunk_tokens={chunk_tokens} must be a multiple of "
                    f"page_size={page_size} (chunks end on page "
                    f"boundaries)")
            if self.chunk_tokens > self.max_context:
                raise ValueError(
                    f"chunk_tokens={chunk_tokens} exceeds "
                    f"max_context={max_context}")
        self.chunk_budget = int(chunk_budget) if chunk_budget \
            else (self.chunk_tokens or 0)
        # with chunking the prefill buckets stop at the chunk size: a
        # prompt (or unmatched suffix) above it takes the chunk path
        prefill_cap = self.chunk_tokens or self.max_context
        self.prefill_buckets = _pow2_buckets(min(16, prefill_cap),
                                             prefill_cap)
        self.batch_buckets = _pow2_buckets(1, self.max_batch)
        self.transfer_buckets = _pow2_buckets(1, self.n_block_entries)
        self.running = []       # admission order, oldest first
        self.prefilling = []    # mid-chunk admissions, oldest first
        self.completed = []
        self.evictions = 0
        self.decode_steps = 0
        self.admissions = 0
        self.full_prefills = 0
        self.prefix_hits = 0
        self.prefix_tokens_matched = 0
        self.forks = 0
        self.spec_steps = 0
        self.spec_lane_steps = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        self.draft_dispatches = 0
        self.chunk_prefills = 0
        self.chunked_admissions = 0
        self.transfers = 0
        self.transferred_page_bytes = 0
        self.deferred_admissions = 0
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.draft_s = 0.0
        if self.draft_model is not None:
            # the draft's pools are indexed by the target's block tables
            # (same page geometry): one allocator, one eviction story
            if self.draft_model.device != self.device:
                raise ValueError(
                    f"the draft model lies on {self.draft_model.device}, "
                    f"the engine on {self.device}: move one of them")
            dblk = self.draft_model.blocks[0].attn
            d_max_len = self.draft_model.pos_embed.W.shape[0]
            if d_max_len < self.max_context:
                raise ValueError(
                    f"draft_model max_len={d_max_len} below "
                    f"max_context={max_context}")
            self._kv_draft = PagedKVCache(
                len(self.draft_model.blocks), num_pages, page_size,
                dblk.n_heads, dblk.d_head, dtype=page_dtype,
                device=self.device)
            # the draft prefills whole prompts: its buckets are not capped
            # by chunking
            self._draft_prefill_buckets = _pow2_buckets(
                min(16, self.max_context), self.max_context)
        self.disagg = serve_disagg_mode(disagg)
        if self.disagg:
            # a scratch pool of this rank's heads on the prefill device,
            # whose identity block table puts a prompt's pages first
            self._prefill_device = self.device if prefill_device is None \
                else resolve_device(prefill_device)
            self._kv_prefill = PagedKVCache(
                n_layers, self.n_block_entries, page_size, n_heads,
                blk.d_head, dtype=page_dtype, device=self._prefill_device)
            self._model_prefill = model \
                if self._prefill_device == self.device \
                else copy.deepcopy(model).to(self._prefill_device)
            self._scratch_bt = torch.arange(self.n_block_entries,
                                            device=self._prefill_device)

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

    def _tensor(self, array, device=None):
        return torch.from_numpy(array).to(device or self.device)

    def _agree(self, toks):
        """Tensor parallelism: tp rank 0's tokens on every rank of the
        group, one broadcast of the small int tensor (so a near-tie of the
        logits cannot split the ranks' schedulers).  Without tp the
        tokens themselves."""
        if self.tp_comm is None:
            return toks
        return self.tp_comm.bcast(toks, root=0, shaped=True)

    def _bt_row(self, seq_id):
        row = np.zeros(self.n_block_entries, dtype=np.int64)
        table = self.allocator.block_table(seq_id)
        row[:len(table)] = table
        return row

    def _padded_tokens(self, toks, buckets=None, what="prompt length",
                       device=None):
        Tb = _bucket(len(toks), buckets or self.prefill_buckets, what)
        tokens = np.zeros((1, Tb), dtype=np.int64)
        tokens[0, :len(toks)] = toks
        return self._tensor(tokens, device)

    # -- observability -------------------------------------------------------

    @staticmethod
    def _req_tid(req):
        """The request's own trace track: lifecycle spans of concurrent
        requests overlap, so each takes a Chrome ``tid`` lane.  A request
        id that is not an int maps onto a crc32 lane (independent of
        ``PYTHONHASHSEED``)."""
        rid = req.request_id
        if isinstance(rid, int):
            return 1 + rid
        return 1 + (zlib.crc32(str(rid).encode()) & 0x7FFFFFFF)

    def _obs_admitted(self, req, wait_s, readmit):
        """The admission's queue wait: a retroactive span on the
        request's lane (its exact duration on the engine's clock in the
        tags) and the per-tenant histogram."""
        tags = {"tenant": req.tenant, "request": req.request_id,
                "prompt": int(req.prompt.size)}
        if readmit:
            tags["readmit"] = True
        observability.tracer().complete("serve/queue_wait", wait_s,
                                        tags=tags, tid=self._req_tid(req))
        observability.registry().histogram(
            "chainermn_tpu_serving_queue_wait_ms",
            help="admission queue wait per request (ms)").observe(
            wait_s * 1e3, tenant=req.tenant)

    def _obs_queue_depths(self):
        queues = getattr(self.scheduler, "_queues", None)
        if queues is None:   # a scheduler without tenant queues
            return
        gauge = observability.registry().gauge(
            "chainermn_tpu_serving_queue_depth",
            help="pending requests per tenant at the last decode step")
        for tenant in list(queues):
            gauge.set(self.scheduler.pending(tenant), tenant=tenant)

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
        if observability.enabled():
            observability.instant("serve/finish",
                                  tags={"tenant": req.tenant,
                                        "request": req.request_id,
                                        "tokens": len(req.tokens)},
                                  tid=self._req_tid(req))

    def _evict(self, req, now=None):
        """Preemption: free pages (shared pages stay alive through their
        other holders), fold generated tokens into the prompt, re-queue
        front-of-line (recompute on re-admit).  ``now`` stamps the
        re-queue, from which the re-admission's queue wait counts.  A
        mid-chunk victim leaves ``prefilling``; the requeue resets its
        chunk cursor."""
        self.allocator.free(req.request_id)
        if req in self.running:
            self.running.remove(req)
        else:
            self.prefilling.remove(req)
        req.requeue_time = now
        self.scheduler.requeue_front(req)
        self.evictions += 1
        if observability.enabled():
            observability.instant("serve/evict",
                                  tags={"tenant": req.tenant,
                                        "request": req.request_id},
                                  tid=self._req_tid(req))
            observability.registry().counter(
                "chainermn_tpu_serving_evictions_total",
                help="running sequences preempted for pool pages").inc(
                1, tenant=req.tenant)

    def _run_fork(self, src, dst):
        copy_page(self.kv.k_store, self.kv.v_store, src, dst)
        self.forks += 1
        if observability.enabled():
            observability.instant("serve/fork",
                                  tags={"src": int(src), "dst": int(dst)})
            observability.registry().counter(
                "chainermn_tpu_serving_forks_total",
                help="copy-on-write page forks").inc(1)

    def _run_prefix_prefill(self, req, L, matched):
        """Prefix hit: prefill only the unmatched suffix."""
        return prefix_prefill_program(
            self.model, self.kv, self._padded_tokens(req.prompt[matched:]),
            L - matched, matched, self._tensor(self._bt_row(req.request_id)),
            tp_comm=self.tp_comm)

    def _run_disagg_prefill(self, req, L):
        """Prefix miss on the disaggregated split: the full flash prefill
        on the prefill device against the scratch pool, then the pages
        ship into the decode pool."""
        logits = prefill_program(
            self._model_prefill, self._kv_prefill,
            self._padded_tokens(req.prompt, device=self._prefill_device),
            L, self._scratch_bt, tp_comm=self.tp_comm)
        self._ship_pages(req, L)
        return logits

    def _ship_pages(self, req, L):
        """Ship the first ``pages_for(L)`` scratch pages into the decode
        pool at the request's page ids: a block of the bucketed page count
        (``transfer_buckets``), moved to the decode device and scattered
        there, its padding rows onto the trash page.  Shared by one-shot
        and chunked prefills (a chunked prompt ships once, after its last
        chunk).  A failed copy raises."""
        n_pages = self.allocator.pages_for(L)
        nb = _bucket(n_pages, self.transfer_buckets, "transfer pages")
        rows = np.full(nb, self.kv.num_pages, dtype=np.int64)
        rows[:n_pages] = self.allocator.block_table(
            req.request_id)[:n_pages]
        rows = self._tensor(rows)
        for scratch, store in ((self._kv_prefill.k_store, self.kv.k_store),
                               (self._kv_prefill.v_store, self.kv.v_store)):
            insert_pages(store, extract_pages(scratch, nb).to(self.device),
                         rows)
        shipped = nb * self.kv.n_layers * self.kv.page_bytes
        self.transferred_page_bytes += shipped
        self.transfers += 1
        if observability.enabled():
            observability.instant("serve/page_transfer",
                                  tags={"request": req.request_id,
                                        "pages": int(nb),
                                        "bytes": int(shipped)},
                                  tid=self._req_tid(req))
            observability.registry().counter(
                "chainermn_tpu_serving_transferred_page_bytes_total",
                help="KV page bytes shipped prefill slice -> decode "
                     "pool").inc(shipped)

    def _admit(self, req, clock):
        """Pages + prefill + first token, or the first chunk's pages for a
        chunked admission.  Raises PagePoolExhaustedError (allocator
        untouched: a partial share is rolled back) when the pool cannot
        hold the prompt (its first chunk, when chunked).

        The prefix match is capped at ``L - 1`` so prefill always has a
        suffix token to produce the first logits; a match ending mid-page
        forks that page before the suffix's first write."""
        t_admit = clock()
        L = int(req.prompt.size)
        sid = req.request_id
        matched = 0
        chunked = False
        prompt_t = tuple(int(t) for t in req.prompt) \
            if self.prefix_cache else ()
        if self.prefix_cache and L > 1:
            pages, matched, n_full, partial = \
                self.allocator.match_prefix(prompt_t, L - 1)
            if matched:
                chunked = self.chunk_tokens is not None \
                    and (L - matched) > self.chunk_tokens
                # host-side allocation first (rolled back on failure), the
                # device page copy only once admission cannot fail; a
                # chunked admission reserves its first chunk's pages only
                self.allocator.share(sid, pages)
                old = new = None
                try:
                    if partial:
                        old, new = self.allocator.fork(sid, n_full)
                    self.allocator.ensure(
                        sid, (matched + self.chunk_tokens) if chunked
                        else L + 1)             # +1: first decode
                except PagePoolExhaustedError:
                    self.allocator.free(sid)
                    raise
                if new is not None and old != new:
                    self._run_fork(old, new)
        if not matched:
            chunked = self.chunk_tokens is not None \
                and L > self.chunk_tokens
            if self.disagg and any(
                    r._chunk_scratch and (chunked or r._chunk_pos)
                    for r in self.prefilling):
                # one scratch pool: a second prefix-miss chunk stream
                # would interleave into it, and a one-shot miss would
                # overwrite the pages of a stream's written chunks (a
                # hit's chunks run against the decode pool and admit
                # freely)
                raise _AdmitDeferred()
            self.allocator.ensure(sid, self.chunk_tokens if chunked
                                  else L + 1)
        # this admission's queue wait: from arrival, or from the eviction
        # that re-queued the request (its running time is not a wait)
        readmit = req.requeue_time is not None
        wait_s = max(0.0, t_admit - (req.requeue_time if readmit
                                     else req.arrival_time))
        req.queue_wait_s += wait_s
        obs_on = observability.enabled()
        rtid = self._req_tid(req) if obs_on else None
        if obs_on:
            self._obs_admitted(req, wait_s, readmit)
        req.admit_time = t_admit
        req.requeue_time = None   # the next eviction stamps it again
        if chunked:
            # into the chunk state machine, the cursor at the matched
            # prefix: no logits, first token or prefix registration until
            # the last chunk; a hit books now (its pages are held)
            req._chunk_pos = matched
            req._chunk_scratch = self.disagg and not matched
            if matched:
                self.prefix_hits += 1
                self.prefix_tokens_matched += matched
            self.chunked_admissions += 1
            self.prefilling.append(req)
            if obs_on:
                observability.instant(
                    "serve/chunk_admit",
                    tags={"request": sid, "prompt": L, "matched": matched},
                    tid=rtid)
            return
        t0 = time.perf_counter()
        if matched:
            with observability.span(
                    "serve/suffix_prefill",
                    tags={"request": sid, "matched": matched,
                          "suffix": L - matched} if obs_on else None,
                    tid=rtid):
                logits = self._run_prefix_prefill(req, L, matched)
            self.prefix_hits += 1
            self.prefix_tokens_matched += matched
        elif self.disagg:
            with observability.span(
                    "serve/prefill",
                    tags={"request": sid, "prompt": L, "disagg": True}
                    if obs_on else None, tid=rtid):
                logits = self._run_disagg_prefill(req, L)
            self.full_prefills += 1
        else:
            with observability.span(
                    "serve/prefill",
                    tags={"request": sid, "prompt": L} if obs_on else None,
                    tid=rtid):
                logits = prefill_program(self.model, self.kv,
                                         self._padded_tokens(req.prompt),
                                         L, self._tensor(self._bt_row(sid)),
                                         tp_comm=self.tp_comm)
            self.full_prefills += 1
        self._complete_admission(req, logits, clock, prompt_t, t0)

    def _complete_admission(self, req, logits, clock, prompt_t, t0):
        """What one-shot and last-chunk admissions share: register the
        prefix, prefill the draft model's pools, take the first token from
        the prefill's logits and join the running batch.  ``t0`` starts
        the prefill's host-clock time."""
        self.admissions += 1
        if self.prefix_cache:
            self.allocator.register_prefix(req.request_id, prompt_t)
        if self.draft_model is not None:
            self._run_draft_prefill(req)
        tok = int(self._agree(torch.argmax(logits)))   # device -> host
        self.prefill_s += time.perf_counter() - t0
        req._ctx = int(req.prompt.size)   # positions whose KV is written
        t = clock()
        self._record_token(req, tok, t)
        self.running.append(req)
        if self._finished(req):
            self._retire(req, t)

    def _run_draft_prefill(self, req):
        """The draft model's K/V for the whole prompt through the request's
        block table: one flash prefill of the draft, never chunked, logits
        unused (the first token is the target's).  Positions inside shared
        prefix pages are written again with the bytes the provider's draft
        prefill wrote (same model, tokens and positions)."""
        L = int(req.prompt.size)
        prefill_program(
            self.draft_model, self._kv_draft,
            self._padded_tokens(req.prompt, self._draft_prefill_buckets,
                                "draft prompt"),
            L, self._tensor(self._bt_row(req.request_id)))
        req._draft_ctx = L

    def _run_chunk(self, req, startp, size, final, clock):
        """One chunk of a chunked prefill: ``size`` prompt tokens at cursor
        ``startp`` through :func:`prefix_prefill_program` (chunk 0 at
        ``start=0``); the last chunk completes the admission.  A
        prefix-miss chunk on the disaggregated split runs on the prefill
        device against the scratch pool, and its last chunk ships the
        pages."""
        t0 = time.perf_counter()
        chunk = req.prompt[startp:startp + size]
        if req._chunk_scratch:
            logits = prefix_prefill_program(
                self._model_prefill, self._kv_prefill,
                self._padded_tokens(chunk, what="chunk length",
                                    device=self._prefill_device),
                size, startp, self._scratch_bt, tp_comm=self.tp_comm)
        else:
            logits = prefix_prefill_program(
                self.model, self.kv,
                self._padded_tokens(chunk, what="chunk length"), size,
                startp, self._tensor(self._bt_row(req.request_id)),
                tp_comm=self.tp_comm)
        self.chunk_prefills += 1
        req._chunk_pos = startp + size
        if final:
            if req._chunk_scratch:
                self._ship_pages(req, int(req.prompt.size))
            self.prefilling.remove(req)
            prompt_t = tuple(int(t) for t in req.prompt) \
                if self.prefix_cache else ()
            self._complete_admission(req, logits, clock, prompt_t, t0)
        else:
            self.prefill_s += time.perf_counter() - t0

    def _advance_chunks(self, clock):
        """The chunk pass of one step: advance mid-chunk prompts, oldest
        first, under the per-step token budget.  A request whose next
        chunk cannot get pages stalls (keeps its pages, retries next
        step): admission work never preempts running sequences.  The
        exception is the all-prefilling deadlock (nothing running, two or
        more mid-chunk prompts splitting a full pool): the youngest other
        mid-chunk prompt is evicted so that the oldest can finish.
        Returns the prefill tokens advanced."""
        budget = self.chunk_budget
        progressed = 0
        obs_on = observability.enabled()
        for req in list(self.prefilling):
            if budget <= 0:
                break
            L = int(req.prompt.size)
            while budget > 0 and req in self.prefilling:
                startp = req._chunk_pos
                remaining = L - startp
                size = min(self.chunk_tokens, remaining)
                final = size == remaining
                try:
                    self.allocator.ensure(
                        req.request_id,
                        startp + size + (1 if final else 0))
                except PagePoolExhaustedError:
                    break   # stall: keep the pages, retry next step
                with observability.span(
                        "serve/chunk_prefill",
                        tags={"request": req.request_id, "start": startp,
                              "chunk": size, "final": final}
                        if obs_on else None,
                        tid=self._req_tid(req) if obs_on else None):
                    self._run_chunk(req, startp, size, final, clock)
                budget -= size
                progressed += size
        if not progressed and not self.running \
                and len(self.prefilling) > 1:
            # deadlock guard: the youngest other mid-chunk prompt goes
            # (pages held, no token produced: least work lost)
            victim = self.scheduler.pick_victim(
                [], self.allocator, prefilling=self.prefilling[1:])
            self._evict(victim, clock())
        return progressed

    def capacity_multiplier(self):
        """The effective capacity prefix sharing buys: logical pages (what
        an unshared pool would hold for the same residency) over distinct
        physical pages; 1.0 when nothing is shared."""
        used = self.allocator.used_pages
        return self.allocator.logical_pages() / used if used else 1.0

    def _spec_nv(self, req):
        """The lane's verify span: the pending token and at most K
        proposals, cut so that the lane never emits past
        ``max_new_tokens`` (which, by the submit-time fit, keeps every
        speculative write inside ``max_context`` and the pages the
        capacity pass secured)."""
        r = req.max_new_tokens - len(req.tokens)   # >= 1 while running
        return 1 + min(self.spec_k, r - 1)

    def _propose_drafts(self, nv):
        """K proposals per running lane: the n-gram self-draft (host
        work), or the draft model: one catch-up dispatch where a lane's
        draft K/V trails by one position (its whole window was accepted),
        then up to K one-token draft decode dispatches through the same
        block tables.  Rejected draft K/V is rewound by position, as the
        target's is."""
        K = self.spec_k
        n = len(self.running)
        if self.draft_model is None:
            drafts = np.zeros((n, K), dtype=np.int32)
            for j, req in enumerate(self.running):
                hist = np.concatenate(
                    [np.asarray(req.prompt, np.int64),
                     np.asarray(req.tokens, np.int64)])
                drafts[j] = ngram_propose(hist, K)
            return drafts
        Bb = _bucket(n, self.batch_buckets, "batch")
        bts = np.zeros((Bb, self.n_block_entries), dtype=np.int64)
        for j, req in enumerate(self.running):
            bts[j] = self._bt_row(req.request_id)
        bts_t = self._tensor(bts)
        # catch-up: a lane one behind writes the token the target accepted
        # past it (the others idle at pos -1, their writes to the trash)
        cu_tok = np.zeros(Bb, dtype=np.int64)
        cu_pos = np.full(Bb, -1, dtype=np.int64)
        any_gap = False
        for j, req in enumerate(self.running):
            if req._draft_ctx == req._ctx - 1:
                any_gap = True
                cu_pos[j] = req._ctx - 1
                cu_tok[j] = req.tokens[-2] if len(req.tokens) >= 2 \
                    else int(req.prompt[-1])
                req._draft_ctx = req._ctx
        if any_gap:
            decode_program(self.draft_model, self._kv_draft,
                           self._tensor(cu_tok), self._tensor(cu_pos),
                           bts_t, mode=self.mode)
            self.draft_dispatches += 1
        drafts = np.zeros((n, K), dtype=np.int32)
        cur = np.zeros(Bb, dtype=np.int64)
        for j, req in enumerate(self.running):
            cur[j] = req.tokens[-1]
        for i in range(K):
            pos = np.full(Bb, -1, dtype=np.int64)
            for j, req in enumerate(self.running):
                if i < nv[j] - 1:
                    pos[j] = req._ctx + i
            if not (pos >= 0).any():
                break
            _, nxt = decode_program(self.draft_model, self._kv_draft,
                                    self._tensor(cur), self._tensor(pos),
                                    bts_t, mode=self.mode)
            self.draft_dispatches += 1
            nxt = nxt.cpu().numpy()       # device -> host sync
            keep = pos >= 0
            drafts[:, i][keep[:n]] = nxt[:n][keep[:n]]
            cur = np.where(keep, nxt, cur)
        for j, req in enumerate(self.running):
            # positions ctx .. ctx + nv - 2 now hold draft K/V; acceptance
            # rewinds this to the new ctx
            req._draft_ctx = req._ctx + max(0, int(nv[j]) - 1)
        if self.tp_comm is not None:
            # the ranks' whole-head draft models agree on rank 0's
            drafts = self._agree(torch.from_numpy(drafts)).cpu().numpy()
        return drafts

    @torch.inference_mode()
    def warmup(self):
        """One idle dispatch of every program the engine pads to, so that
        the first real request pays no first-use cost (library loads,
        cuBLAS handles, the allocator's growth; the JAX engine compiles
        each bucket here): a prefill a prompt bucket (on the prefill
        device and its scratch pool under ``disagg``), a suffix prefill a
        bucket where prefix sharing or chunking runs it (on the scratch
        pool too for disaggregated chunks), the fork copy, an extract and
        insert a transfer bucket under ``disagg``, a decode and, under
        speculation, a verify a batch bucket with every lane idle, and the
        draft model's prefill and decode buckets.  Every write lands on a
        trash page: the live pages, the allocator and every counter are
        unchanged.  Under tensor parallelism every rank of the group calls
        it (its programs gather)."""
        n = self.n_block_entries
        bt = self._tensor(np.zeros(n, dtype=np.int64))
        tokens = {Tb: self._tensor(np.zeros((1, Tb), dtype=np.int64))
                  for Tb in self.prefill_buckets}
        for Tb, toks in tokens.items():
            if self.disagg:
                prefill_program(self._model_prefill, self._kv_prefill,
                                toks.to(self._prefill_device), 0,
                                self._scratch_bt, tp_comm=self.tp_comm)
            else:
                prefill_program(self.model, self.kv, toks, 0, bt,
                                tp_comm=self.tp_comm)
            if self.prefix_cache or self.chunk_tokens is not None:
                prefix_prefill_program(self.model, self.kv, toks, 0, 0, bt,
                                       tp_comm=self.tp_comm)
            if self.disagg and self.chunk_tokens is not None:
                prefix_prefill_program(
                    self._model_prefill, self._kv_prefill,
                    toks.to(self._prefill_device), 0, 0, self._scratch_bt,
                    tp_comm=self.tp_comm)
        trash = self.kv.num_pages
        if self.prefix_cache:
            copy_page(self.kv.k_store, self.kv.v_store, trash, trash)
        if self.disagg:
            for nb in self.transfer_buckets:
                rows = self._tensor(np.full(nb, trash, dtype=np.int64))
                for scratch, store in (
                        (self._kv_prefill.k_store, self.kv.k_store),
                        (self._kv_prefill.v_store, self.kv.v_store)):
                    insert_pages(store, extract_pages(scratch, nb).to(
                        self.device), rows)
        for Bb in self.batch_buckets:
            idle = self._tensor(np.full(Bb, -1, dtype=np.int64))
            toks = self._tensor(np.zeros(Bb, dtype=np.int64))
            bts = self._tensor(np.zeros((Bb, n), dtype=np.int64))
            decode_program(self.model, self.kv, toks, idle, bts,
                           mode=self.mode, tp_comm=self.tp_comm)
            if self.spec_k:
                spec_verify_program(
                    self.model, self.kv,
                    self._tensor(np.zeros((Bb, self.spec_k + 1),
                                          dtype=np.int64)),
                    idle, self._tensor(np.zeros(Bb, dtype=np.int64)), bts,
                    tp_comm=self.tp_comm)
            if self.draft_model is not None:
                decode_program(self.draft_model, self._kv_draft, toks, idle,
                               bts, mode=self.mode)
        if self.draft_model is not None:
            for Tb in self._draft_prefill_buckets:
                prefill_program(
                    self.draft_model, self._kv_draft,
                    self._tensor(np.zeros((1, Tb), dtype=np.int64)), 0, bt)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the step loop -------------------------------------------------------

    def step(self, now=None):
        """One continuous-batching step: secure every running sequence's
        next page (its verify span under speculation), evicting when the
        pool is dry (mid-chunk prompts first); an admission pass; the
        chunk pass; then one decode (or verify) step over the running
        batch.  Returns step stats.

        ``now=None`` stamps tokens with ``time.monotonic()``; a pinned
        ``now`` (tests, simulated clocks) stamps the whole step with it."""
        clock = time.monotonic if now is None else (lambda: now)
        stats = {"admitted": 0, "evicted_before": self.evictions}
        # capacity first: admitting into pages the running batch is about
        # to need would get the newcomer evicted in the same step
        i = 0
        while i < len(self.running):
            req = self.running[i]
            need = self._spec_nv(req) if self.spec_k else 1
            try:
                self.allocator.ensure(req.request_id, req._ctx + need)
                i += 1
            except PagePoolExhaustedError:
                victim = self.scheduler.pick_victim(
                    self.running, self.allocator,
                    prefilling=self.prefilling)
                self._evict(victim, clock())
                # the victim may be req: re-check the same index
        # a chunk-admitted prompt counts against max_batch from its first
        # chunk: the bound covers work in flight
        while len(self.running) + len(self.prefilling) < self.max_batch:
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
            except _AdmitDeferred:
                # the scratch pool is another prompt's until it ships
                self.deferred_admissions += 1
                self.scheduler.requeue_front(req, preempted=False)
                break
        # long prompts stream in between admission and the decode step,
        # which runs every step all the same
        if self.prefilling:
            stats["chunk_tokens"] = self._advance_chunks(clock)
        n = len(self.running)
        stats["evicted"] = self.evictions - stats.pop("evicted_before")
        stats["running"] = n
        stats["occupancy"] = (self.allocator.used_pages
                              / self.allocator.num_pages)
        stats["capacity_x"] = self.capacity_multiplier()
        if observability.enabled():
            self._obs_queue_depths()
        if n == 0:
            stats["decoded"] = 0
            return stats
        if self.spec_k:
            return self._spec_step(n, clock, stats)
        with observability.span(
                "serve/decode_window",
                tags={"batch": n, "step": self.decode_steps}
                if observability.enabled() else None):
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
                                    mode=self.mode, tp_comm=self.tp_comm)
            nxt = self._agree(nxt).cpu().numpy()   # device -> host sync
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

    def _spec_step(self, n, clock, stats):
        """The speculative decode step: K proposals per lane, all ``K + 1``
        positions verified in one target dispatch, the longest agreeing
        prefix accepted.  ``g[j]`` is the token vanilla decode would emit
        at ``start + j`` after the accepted ones, so emitting ``g[0..a]``
        (``a`` proposals accepted) equals ``a + 1`` vanilla steps.  Span
        positions past the new ``_ctx`` hold stale K/V that no read sees
        and the next step overwrites: the rewind is the rollback."""
        K1 = self.spec_k + 1
        nv = np.zeros(n, dtype=np.int64)
        for j, req in enumerate(self.running):
            nv[j] = self._spec_nv(req)
            # lanes admitted this step missed the capacity pass: secure
            # their span now, speculating less rather than evicting when
            # the pool is dry (admission's L + 1 keeps nv >= 1)
            try:
                self.allocator.ensure(req.request_id, req._ctx + int(nv[j]))
            except PagePoolExhaustedError:
                nv[j] = min(int(nv[j]),
                            self.allocator.capacity(req.request_id)
                            - req._ctx)
        t0 = time.perf_counter()
        drafts = self._propose_drafts(nv)
        self.draft_s += time.perf_counter() - t0
        with observability.span(
                "serve/spec_window",
                tags={"batch": n, "step": self.decode_steps}
                if observability.enabled() else None):
            Bb = _bucket(n, self.batch_buckets, "batch")
            toks = np.zeros((Bb, K1), dtype=np.int64)
            start = np.full(Bb, -1, dtype=np.int64)
            nvb = np.zeros(Bb, dtype=np.int64)
            bts = np.zeros((Bb, self.n_block_entries), dtype=np.int64)
            for j, req in enumerate(self.running):
                toks[j, 0] = req.tokens[-1]
                toks[j, 1:] = drafts[j]
                start[j] = req._ctx
                nvb[j] = nv[j]
                bts[j] = self._bt_row(req.request_id)
            t0 = time.perf_counter()
            _, g = spec_verify_program(
                self.model, self.kv, self._tensor(toks),
                self._tensor(start), self._tensor(nvb), self._tensor(bts),
                tp_comm=self.tp_comm)
            g = self._agree(g).cpu().numpy()   # device -> host sync
            self.decode_s += time.perf_counter() - t0
        self.decode_steps += 1             # one dispatch, up to K1 tokens
        self.spec_steps += 1
        self.spec_lane_steps += n
        t_tok = clock()
        emitted_total = 0
        for j, req in enumerate(list(self.running)):
            nvj = int(nv[j])
            a = 0
            while a < nvj - 1 and int(toks[j, a + 1]) == int(g[j, a]):
                a += 1
            self.spec_proposed += nvj - 1
            self.spec_accepted += a
            for i in range(a + 1):
                req._ctx += 1
                self._record_token(req, int(g[j, i]), t_tok)
                emitted_total += 1
                self.spec_emitted += 1
                if self._finished(req):
                    break   # eos inside the accepted run: stop here
            if self.draft_model is not None:
                # draft K/V above the accepted frontier is stale; a whole
                # accepted window leaves a gap of one (the bonus token's
                # position), closed by the next step's catch-up
                req._draft_ctx = min(req._draft_ctx, req._ctx)
            if self._finished(req):
                self._retire(req, t_tok)
        stats["decoded"] = n
        stats["spec_emitted"] = emitted_total
        return stats

    def drain(self, max_steps=10000, now=None):
        """Run steps until the queues, the mid-chunk prompts and the
        running batch are empty.  Returns the number of steps taken."""
        steps = 0
        while (self.running or self.prefilling
               or self.scheduler.pending()) and steps < max_steps:
            self.step(now=now)
            steps += 1
        return steps
