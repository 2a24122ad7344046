"""Refcounted block allocator + prefix-hash trie for the paged KV cache.

A copy of the JAX package's module (pure host code).

Host-side bookkeeping ONLY: pages are integer ids into the preallocated
device pools (``serving.kv_cache``); no tensor ever passes through this
module, so the decode hot path never copies KV bytes host-side — the
allocator hands out page ids and the device programs scatter/gather
through them.

It is a copy-on-write prefix-sharing allocator: chat-shaped traffic
re-sends the same system prompt / few-shot header thousands of times, and
the block table already indirects every token, so identical prompt
prefixes can point at the SAME physical pages.  Three pieces:

* **refcounts** — a page may be owned by several sequences at once;
  ``free()`` decrements and only returns pages that hit zero (in table
  order, preserving the FIFO recycle contract at the moment of release);
* **a prefix-hash trie** — live sequences register their prompt's
  page-granular chunks (full ``page_size``-token chunks hash to trie
  nodes bound to the holder's pages; a trailing partial chunk registers
  its token tuple); ``match_prefix`` walks a new prompt down the trie
  and returns the longest shareable page chain.  The match is CONTENT-
  addressed: two prompts reach the same node only via identical token
  prefixes at identical absolute positions, so any holder's page carries
  bit-identical K/V for that span (causal attention + absolute position
  embeddings make K/V at position ``p`` a pure function of tokens
  ``[0..p]``);
* **fork-on-write** — a borrower that must write into a still-shared
  page (its suffix starts mid-page) calls ``fork``: the table entry is
  swapped for a fresh page (refcount moves), and the ENGINE copies the
  page in-graph through the existing scatter path.  The original
  provider never forks: its writes land at slots at or past its own
  frontier, which every borrower's valid region (its matched token
  count) stops strictly short of.

Discipline: every decision is
a pure function of the call sequence — the free list is FIFO over page
ids seeded ``0..P-1``, frees return zero-refcount pages in block-table
order, trie holders are consulted in registration order — so a seeded
request trace produces bit-identical block tables on every run and every
host (the property suite pins this).  Invariants the suite churn-tests:

* ownership: every allocated page is owned by >= 1 sequence and its
  refcount equals the number of tables containing it;
* conservation: ``len(free) + len(distinct owned)`` equals the pool
  size after any alloc/share/fork/free interleaving;
* atomicity: a failed ``ensure``/``fork`` (``PagePoolExhaustedError``)
  leaves the allocator state untouched — OOM is a typed scheduling
  event, never corruption.
"""

from __future__ import annotations

from collections import OrderedDict, deque

from .errors import PagePoolExhaustedError

__all__ = ["BlockAllocator"]


def _common_prefix_len(a, b):
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class _TrieNode:
    """One page-granular chunk of registered prompt content.

    ``holders`` maps live seq_id -> the page carrying this chunk's K/V
    (insertion order == registration order; matching reads the FIRST
    holder, so the choice is deterministic).  ``partials`` maps live
    seq_id -> (token tuple, page) for a trailing partial chunk hanging
    off this node.
    """

    __slots__ = ("children", "holders", "partials")

    def __init__(self):
        self.children = {}
        self.holders = OrderedDict()
        self.partials = OrderedDict()

    @property
    def dead(self):
        return not (self.children or self.holders or self.partials)


class BlockAllocator:
    """Fixed pool of ``num_pages`` pages, ``page_size`` token slots each.

    ``ensure(seq_id, n_tokens)`` grows sequence ``seq_id``'s block table
    to cover ``n_tokens`` positions (idempotent; allocation only ever
    appends — positions are immutable once written).  ``share`` seeds a
    NEW sequence's table with another sequence's pages (refcount++),
    ``fork`` swaps a still-shared table entry for a fresh page
    (copy-on-write), and ``free(seq_id)`` decrements every owned page's
    refcount, returning only zero-refcount pages to the free list in
    table order.
    """

    def __init__(self, num_pages, page_size):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free = deque(range(self.num_pages))
        # OrderedDict: iteration order == admission order (the scheduler's
        # eviction policy reads it newest-first)
        self._tables = OrderedDict()
        self._refs = {}          # page id -> number of tables holding it
        self._trie = _TrieNode()
        self._trie_refs = {}     # seq_id -> [(parent, key, node), ...]

    # -- queries -------------------------------------------------------------

    @property
    def free_pages(self):
        return len(self._free)

    @property
    def used_pages(self):
        """DISTINCT pages owned by at least one sequence."""
        return self.num_pages - len(self._free)

    def pages_for(self, n_tokens):
        """Pages needed to hold ``n_tokens`` positions."""
        return -(-max(0, int(n_tokens)) // self.page_size)

    def sequences(self):
        """Sequence ids in admission order (oldest first)."""
        return list(self._tables)

    def block_table(self, seq_id):
        """The sequence's page ids, position-major (a copy)."""
        return list(self._tables[seq_id])

    def capacity(self, seq_id):
        """Token positions the sequence's current pages can hold."""
        return len(self._tables[seq_id]) * self.page_size

    def refcount(self, page):
        """How many tables hold ``page`` (0 = free)."""
        return self._refs.get(page, 0)

    def unique_pages(self, seq_id):
        """Pages ONLY this sequence owns — what evicting it would
        actually return to the pool (the eviction-livelock guard's
        accounting; shared pages stay alive through their other
        holders)."""
        return sum(1 for p in self._tables[seq_id]
                   if self._refs[p] == 1)

    def logical_pages(self):
        """Sum of table lengths, counting shared pages once PER HOLDER —
        the pages an unshared pool would need for the same residency.
        ``logical_pages() / used_pages`` is the effective-capacity
        multiplier prefix sharing buys (the bench row reports it)."""
        return sum(len(t) for t in self._tables.values())

    # -- mutation ------------------------------------------------------------

    def ensure(self, seq_id, n_tokens):
        """Grow ``seq_id``'s table to cover ``n_tokens`` positions.

        Registers the sequence on first call.  Atomic: raises
        :class:`PagePoolExhaustedError` (state unchanged) when the free
        list cannot cover the growth.  Returns the block table (copy).
        """
        table = self._tables.get(seq_id)
        if table is None:
            table = []
        need = self.pages_for(n_tokens) - len(table)
        if need > len(self._free):
            raise PagePoolExhaustedError(need, len(self._free),
                                         self.num_pages)
        if seq_id not in self._tables:
            self._tables[seq_id] = table
        for _ in range(max(0, need)):
            p = self._free.popleft()
            self._refs[p] = 1
            table.append(p)
        return list(table)

    def share(self, seq_id, pages):
        """Seed a NEW sequence's table with shared pages (refcount++ on
        each; the pages must be live).  Must precede any ``ensure`` for
        ``seq_id`` — sharing seeds a prefix, it never splices."""
        if seq_id in self._tables:
            raise ValueError(f"share() must seed a new sequence; "
                             f"{seq_id!r} already has a table")
        for p in pages:
            if self._refs.get(p, 0) < 1:
                raise ValueError(f"cannot share non-live page {p}")
        for p in pages:
            self._refs[p] += 1
        self._tables[seq_id] = list(pages)

    def fork(self, seq_id, index):
        """Copy-on-write: swap the (shared) page at ``index`` of
        ``seq_id``'s table for a fresh page.  Returns ``(old, new)`` —
        the CALLER copies the device bytes ``old -> new`` in-graph.
        No-op ``(old, old)`` when the page is no longer shared (the
        other holders freed between share and write).  Atomic: raises
        :class:`PagePoolExhaustedError` (state unchanged) when the pool
        is dry."""
        table = self._tables[seq_id]
        old = table[index]
        if self._refs[old] <= 1:
            return old, old
        if not self._free:
            raise PagePoolExhaustedError(1, 0, self.num_pages)
        new = self._free.popleft()
        self._refs[old] -= 1
        self._refs[new] = 1
        table[index] = new
        return old, new

    def free(self, seq_id):
        """Release every page of ``seq_id`` (eviction and completion
        share this path): refcount-- each; pages hitting ZERO rejoin the
        free list in table order (shared pages stay alive through their
        other holders).  Unregisters the sequence's trie entries.
        Returns the number of pages actually returned to the pool."""
        table = self._tables.pop(seq_id)
        self.unregister_prefix(seq_id)
        freed = 0
        for p in table:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)
                freed += 1
        return freed

    # -- the prefix-hash trie ------------------------------------------------

    def register_prefix(self, seq_id, tokens):
        """Publish ``seq_id``'s prompt as shareable: each full
        ``page_size``-token chunk binds a trie node to the sequence's
        page at that index; a trailing partial chunk registers its token
        tuple (borrowers of a partial page fork before writing).  The
        table must already cover the prompt.  Idempotent per sequence
        (re-registration replaces)."""
        if seq_id in self._trie_refs:
            self.unregister_prefix(seq_id)
        tokens = tuple(tokens)
        table = self._tables[seq_id]
        S = self.page_size
        n_full = len(tokens) // S
        refs = []
        node = self._trie
        for i in range(n_full):
            chunk = tokens[i * S:(i + 1) * S]
            child = node.children.get(chunk)
            if child is None:
                child = node.children[chunk] = _TrieNode()
            child.holders[seq_id] = table[i]
            refs.append((node, chunk, child))
            node = child
        rem = tokens[n_full * S:]
        if rem:
            node.partials[seq_id] = (rem, table[n_full])
            refs.append((None, None, node))   # partial ref marker
        self._trie_refs[seq_id] = refs

    def unregister_prefix(self, seq_id):
        """Remove ``seq_id``'s trie entries, pruning nodes that die
        (deepest first, so a long-running server's trie stays bounded by
        LIVE prompt content)."""
        refs = self._trie_refs.pop(seq_id, None)
        if not refs:
            return
        for parent, key, node in reversed(refs):
            if parent is None:               # partial ref marker
                node.partials.pop(seq_id, None)
            else:
                node.holders.pop(seq_id, None)
                if node.dead:
                    parent.children.pop(key, None)

    def match_prefix(self, tokens, cap):
        """Longest shareable prefix of ``tokens`` against live
        registrations, capped at ``cap`` tokens (the engine passes
        ``len(prompt) - 1`` so prefill always keeps >= 1 suffix token to
        produce the first-generation logits).

        Returns ``(pages, matched, n_full, partial)``: the shareable
        page chain, total matched token count, how many of those pages
        are FULL (immutable — safe to share forever), and how many
        tokens of a trailing PARTIAL page matched (> 0 means the caller
        must fork that last page before its first write into it).
        Deterministic: full chunks take the first-registered holder's
        page; the partial winner is the first registration achieving the
        longest common prefix.
        """
        tokens = tuple(tokens)
        cap = min(int(cap), len(tokens))
        S = self.page_size
        pages = []
        node = self._trie
        n_full = 0
        while (n_full + 1) * S <= cap:
            chunk = tokens[n_full * S:(n_full + 1) * S]
            child = node.children.get(chunk)
            if child is None or not child.holders:
                break
            pages.append(next(iter(child.holders.values())))
            node = child
            n_full += 1
        matched = n_full * S
        best_c, best_page = 0, None
        for ptoks, ppage in node.partials.values():
            c = min(_common_prefix_len(ptoks, tokens[matched:]),
                    cap - matched)
            if c > best_c:
                best_c, best_page = c, ppage
        if best_c:
            pages.append(best_page)
            matched += best_c
        return pages, matched, n_full, best_c

    # -- invariant check (the property suite's oracle) -----------------------

    def check(self):
        """Assert the ownership/conservation invariants; returns True so
        tests can ``assert alloc.check()`` after every churn step."""
        counts = {}
        for t in self._tables.values():
            for p in t:
                counts[p] = counts.get(p, 0) + 1
        if len(self._free) + len(counts) != self.num_pages:
            raise AssertionError(
                f"page conservation violated: {len(self._free)} free + "
                f"{len(counts)} distinct owned != {self.num_pages}")
        if counts != self._refs:
            raise AssertionError(
                f"refcount drift: tables say {counts}, refs say "
                f"{self._refs}")
        if set(self._free) & set(counts):
            raise AssertionError("page both free and owned")
        all_pages = list(self._free) + list(counts)
        if not all(0 <= p < self.num_pages for p in all_pages):
            raise AssertionError("page id out of range")
        for seq_id, refs in self._trie_refs.items():
            if seq_id not in self._tables:
                raise AssertionError(
                    f"trie registration for dead sequence {seq_id!r}")
        return True
