"""Request scheduler: open-loop admission, per-tenant fairness, eviction.

A copy of the JAX package's module (pure host code).

Admission happens at decode-step granularity (continuous batching): the
engine asks for joinable requests between decode steps, so a new request
waits at most one step to enter the running batch.

* **Per-tenant fair queueing**: one FIFO per tenant, served round-robin
  in tenant first-seen order with a persistent cursor.
* **Bounded queues** (backpressure): ``submit`` raises
  :class:`~.errors.QueueSaturatedError` at ``max_queue``.
* **Preemption by eviction**: when the page pool runs dry mid-decode the
  engine evicts the youngest running sequence, frees its pages and
  re-queues it at the front of its tenant's queue with the tokens
  generated so far folded into its prompt (recompute on re-admit).
* **Chunked-prefill state**: a request admitted in chunks carries its
  chunk cursor (``_chunk_pos``); a mid-chunk eviction resets it, and
  mid-chunk prompts are the preferred eviction victims.

Every decision is deterministic in the call sequence.
"""

from __future__ import annotations

from collections import OrderedDict, deque
import itertools

import numpy as np

from .errors import EvictionStalledError, QueueSaturatedError

__all__ = ["Request", "RequestScheduler"]


class Request:
    """One generation request.

    ``prompt``: int32 token ids (any 1-D sequence).  ``max_new_tokens``:
    decode budget.  ``tenant``: fairness bucket.  The engine fills in
    ``tokens`` and the timestamps as it runs; after an eviction ``prompt``
    grows by the generated tokens and ``max_new_tokens`` shrinks
    accordingly.
    """

    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens, tenant="default",
                 arrival_time=0.0, request_id=None):
        self.prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            # prefill always produces one token (its logits ARE the first
            # generation), and the pool-fit check sizes by prompt + max_new
            raise ValueError("max_new_tokens must be >= 1")
        self.tenant = tenant
        self.arrival_time = float(arrival_time)
        self.request_id = (next(Request._ids) if request_id is None
                           else request_id)
        self.tokens = []          # generated token ids (host ints)
        self.token_times = []     # engine clock at each token production
        self.preemptions = 0
        self.first_token_time = None
        self.finish_time = None
        # the engine's clock at the last admission, at the last eviction
        # (cleared by the admission after it), and the queue waits summed
        # over the admissions
        self.admit_time = None
        self.requeue_time = None
        self.queue_wait_s = 0.0
        # the chunk cursor: prompt positions whose KV completed chunks
        # wrote; a mid-chunk eviction resets it (requeue_front), so the
        # re-admission restarts from chunk 0 on fresh pages
        self._chunk_pos = 0
        # whether the chunks run against the engine's disaggregated
        # scratch pool (a prefix miss on the split), set at admission
        self._chunk_scratch = False

    @property
    def total_len(self):
        return int(self.prompt.size) + len(self.tokens)

    def __repr__(self):
        return (f"Request(id={self.request_id}, tenant={self.tenant!r}, "
                f"prompt={self.prompt.size}, new={len(self.tokens)}/"
                f"{self.max_new_tokens})")


class RequestScheduler:
    def __init__(self, max_queue=256):
        self.max_queue = int(max_queue)
        self._queues = OrderedDict()   # tenant -> deque[Request]
        self._rr = 0                   # round-robin cursor (tenant index)
        self.submitted = 0
        self.rejected = 0

    def submit(self, request):
        """Enqueue; raises :class:`QueueSaturatedError` at the bound."""
        q = self._queues.setdefault(request.tenant, deque())
        if len(q) >= self.max_queue:
            self.rejected += 1
            raise QueueSaturatedError(request.tenant, len(q),
                                      self.max_queue)
        q.append(request)
        self.submitted += 1

    def requeue_front(self, request, preempted=True):
        """Re-admission path for an evicted request: generated tokens fold
        into the prompt (their KV is recomputed by the re-admit prefill)
        and the request jumps the line within its tenant.
        ``preempted=False`` is the admission back-off path (pool
        momentarily full, nothing was evicted).  A mid-chunk victim's
        chunk cursor resets: its pages were freed, so chunk 0 runs again
        on re-admission."""
        if request.tokens:
            request.prompt = np.concatenate(
                [request.prompt,
                 np.asarray(request.tokens, dtype=np.int32)])
            request.max_new_tokens -= len(request.tokens)
            request.tokens = []
        if preempted:
            request.preemptions += 1
        request._chunk_pos = 0
        self._queues.setdefault(request.tenant, deque()) \
            .appendleft(request)

    def pending(self, tenant=None):
        if tenant is not None:
            return len(self._queues.get(tenant, ()))
        return sum(len(q) for q in self._queues.values())

    def tenant_depths(self):
        """``{tenant: queue depth}`` for every tenant seen: the per-tenant
        surface the fleet's gauges, the router's ``pressure()`` and a
        fleet worker's report read."""
        return {t: len(q) for t, q in self._queues.items()}

    def next_admission(self, arrived_by=None):
        """Pop the next request in fair rotation, or None.  Only requests
        with ``arrival_time <= arrived_by`` are eligible (open loop)."""
        tenants = list(self._queues)
        n = len(tenants)
        for i in range(n):
            idx = (self._rr + i) % n
            q = self._queues[tenants[idx]]
            if q and (arrived_by is None
                      or q[0].arrival_time <= arrived_by):
                self._rr = (idx + 1) % n
                return q.popleft()
        return None

    @staticmethod
    def pick_victim(running, allocator=None, prefilling=None):
        """Eviction policy: the youngest running request (least service
        consumed, least recompute wasted); ``running`` is oldest-first.
        Mid-chunk prompts (``prefilling``, oldest-first) come before any
        running request, youngest first: they hold pages and have produced
        no token.

        With prefix sharing pass the ``allocator``: a victim is useful
        only if evicting it returns pages, so candidates are scanned
        youngest to oldest past those owning no unique page, and
        :class:`~.errors.EvictionStalledError` is raised when none would
        free anything (the livelock guard)."""
        if not running and not prefilling:
            return None
        if allocator is None:
            if prefilling:
                return prefilling[-1]
            return running[-1]
        for pool in (prefilling or (), running):
            for req in reversed(pool):
                if allocator.unique_pages(req.request_id) > 0:
                    return req
        raise EvictionStalledError(len(running) + len(prefilling or ()))
