"""Typed serving errors (a copy of the JAX package's, pure host code).

Two boundaries push back instead of corrupting state:

* admission (``submit``): a saturated tenant queue raises
  :class:`QueueSaturatedError` with the depths, so an ingress tier can
  shed load instead of growing an unbounded host-side backlog;
* the page pool (``BlockAllocator``): exhaustion raises
  :class:`PagePoolExhaustedError` with the shortfall.  Inside the engine
  this is a scheduling event (preempt by eviction, recompute on
  re-admit); it reaches the caller only at ``submit``, for a request whose
  full eventual context could never fit the pool.

Both derive from :class:`ServingError`, the one catch-point.
"""

from __future__ import annotations

__all__ = ["ServingError", "PagePoolExhaustedError", "QueueSaturatedError",
           "EvictionStalledError"]


class ServingError(RuntimeError):
    """Base of the serving subsystem's typed errors."""


class PagePoolExhaustedError(ServingError):
    """The page pool cannot cover a requested allocation.

    Raised with the allocator state unchanged (allocation is atomic), so
    the scheduler can evict and retry without repair work."""

    def __init__(self, requested, free, total):
        self.requested = int(requested)
        self.free = int(free)
        self.total = int(total)
        super().__init__(
            f"page pool exhausted: need {self.requested} page(s), "
            f"{self.free}/{self.total} free")


class QueueSaturatedError(ServingError):
    """Admission backpressure: the tenant's wait queue is at its bound."""

    def __init__(self, tenant, depth, bound):
        self.tenant = tenant
        self.depth = int(depth)
        self.bound = int(bound)
        super().__init__(
            f"tenant {tenant!r} queue saturated ({self.depth}/{self.bound})"
            " — shed load or retry later")


class EvictionStalledError(ServingError):
    """Eviction cannot free a single page: every running sequence's pages
    are all shared (refcount > 1), so no victim would return anything to
    the pool and the pool-dry loop would spin forever (the prefix-sharing
    livelock)."""

    def __init__(self, n_running):
        self.n_running = int(n_running)
        super().__init__(
            f"eviction stalled: none of the {self.n_running} running "
            "sequence(s) owns a uniquely-held page — evicting any of "
            "them would free nothing (all pages shared)")
