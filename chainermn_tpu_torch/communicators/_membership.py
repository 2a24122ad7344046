"""Elastic membership: who is in the job, decided over the key-value store.

The port of ``chainermn_tpu.communicators._membership``, a host-only
module copied over.  :class:`~._host_channel.HostChannel` recovers faults
at a fixed world size; on preemptible capacity processes leave and join
mid-run.  This is the control-plane half of elasticity: an epoch-keyed
membership protocol over the same store client the channel rides
(:class:`~._host_channel.StoreKV` over the job's ``torch.distributed``
store, or the tests' in-memory fakes), so survivors agree on the new rank
set without any participation from a dead peer.

Protocol:

* Membership is a monotonically increasing **epoch** plus, per epoch, a
  decided **view** (the sorted tuple of live ranks).  Keys live under
  ``<ns>/<role>`` (``<ns>/elastic`` for the training group), outside the
  host channel's per-generation prefix, so a ``bump_generation`` never
  strands a decision.  Groups of different roles are key-disjoint, and
  every view carries its ``role``.
* Each decision also publishes a **multicast tree plan**
  (:func:`multicast_tree_plan`, a pure function of the member set): the
  O(log N)-round binomial broadcast schedule for bulk state transfers.
* ``announce_leave()`` / ``announce_join()`` are non-blocking intents a
  rank posts before it departs / when it wants back in.
* :meth:`ElasticMembership.resolve` is the consensus: every candidate
  posts (and keeps refreshing) a presence beat under the next epoch, the
  lowest-ranked live candidate leads, and it publishes the view once the
  candidate set is **complete** (every rank in ``expect`` present) or
  **settled** (unchanged for ``settle_s``: the typed per-peer timeout).
  Everyone else adopts the published view.  A candidate whose beat
  freezes for ``stall_s`` mid-resolve is excluded.
* A resolve that exhausts its deadline raises
  :class:`~._host_channel.ChannelTimeoutError` (op
  ``"membership.resolve"``), never a hang.
* The capacity-conversion journal (``<ns>/capacity``) records a rank's
  role change step by step, for the serving fleet's broker.

Split-brain note: a candidate so slow that the leader settles without it
finds itself excluded from the published view; :meth:`resolve` returns
that view, and :class:`~..extensions.ElasticRecovery` treats "view
without me" like a preemption (announce join, wait for re-admission).
"""

from __future__ import annotations

import time

from ._host_channel import ChannelTimeoutError

__all__ = ["MembershipView", "ElasticMembership", "multicast_tree_plan"]


def multicast_tree_plan(members, root=None):
    """Binomial broadcast-tree schedule over ``members`` — the O(log N)
    replacement for the lowest-survivor O(N) sequential bcast.

    Returns a tuple of ROUNDS; round ``k`` is a tuple of ``(src, dst)``
    member pairs whose transfers can all run concurrently (every ``src``
    already holds the payload: the root before round 0, plus every
    ``dst`` of an earlier round).  Pure function of ``(members, root)``
    — every member computes the identical plan, so no coordination
    beyond the decided view is needed.  Properties (pinned by test):

    * every non-root member appears EXACTLY once as a ``dst``;
    * every ``src`` of round ``k`` is the root or a ``dst`` of a round
      ``< k`` (no transfer from an empty holder);
    * depth ``== ceil(log2 N)`` (``0`` rounds for a single member).

    ``root`` defaults to the lowest member (the serving fleet's lowest
    survivor; the elastic snapshot root).
    """
    members = tuple(sorted(int(m) for m in members))
    if not members:
        raise ValueError("multicast_tree_plan needs at least one member")
    if len(set(members)) != len(members):
        raise ValueError(f"duplicate members: {members!r}")
    root = members[0] if root is None else int(root)
    if root not in members:
        raise ValueError(f"root {root} is not a member of {members!r}")
    order = (root,) + tuple(m for m in members if m != root)
    n = len(order)
    rounds = []
    have = 1  # holders so far: order[:have]
    while have < n:
        rounds.append(tuple((order[i], order[i + have])
                            for i in range(have) if i + have < n))
        have *= 2
    return tuple(rounds)


def _serialize_tree_plan(plan):
    return ";".join(",".join(f"{s}>{d}" for s, d in rnd) for rnd in plan)


def _parse_tree_plan(raw):
    plan = []
    for rnd in str(raw).split(";"):
        if not rnd:
            continue
        plan.append(tuple(tuple(int(x) for x in pair.split(">"))
                          for pair in rnd.split(",") if pair))
    return tuple(plan)


class MembershipView:
    """One decided membership generation: ``epoch`` + sorted ``members``
    (global controller ranks) + the ``role`` of the group that decided
    it (``"elastic"`` for the training group, ``"fleet"`` for the
    serving fleet — views from different role groups never compare
    equal).  Immutable value object."""

    def __init__(self, epoch, members, role="elastic"):
        self.epoch = int(epoch)
        self.role = str(role)
        self.members = tuple(sorted(int(m) for m in members))
        if len(set(self.members)) != len(self.members):
            raise ValueError(f"duplicate members in view: {members!r}")

    @property
    def size(self):
        return len(self.members)

    def slot(self, rank):
        """This member's dense 0-based slot in the view (collective
        addressing), or None for a non-member."""
        return self.members.index(rank) if rank in self.members else None

    def __contains__(self, rank):
        return rank in self.members

    def __eq__(self, other):
        return (isinstance(other, MembershipView)
                and (self.epoch, self.members, self.role)
                == (other.epoch, other.members, other.role))

    def __hash__(self):
        return hash((self.epoch, self.members, self.role))

    def tree_plan(self, root=None):
        """The view's multicast tree plan (pure; see
        :func:`multicast_tree_plan`)."""
        return multicast_tree_plan(self.members, root=root)

    def __repr__(self):
        return (f"<MembershipView role={self.role!r} epoch={self.epoch} "
                f"members={self.members}>")


class ElasticMembership:
    """The membership protocol bound to one process (see module doc).

    ``client``: the coordination-service KV client (or the test fake).
    ``rank``/``world``: this process's GLOBAL controller rank and the
    boot-time process count — membership ranks are stable process
    identities; a resized communicator maps them to dense slots.
    ``role``: the group namespace suffix — ``"elastic"`` (default, the
    training group) or ``"fleet"`` (the serving fleet); groups of
    different roles in the same KV store are fully key-disjoint.
    ``settle_s``: how long the candidate set must be unchanged before
    the leader decides without the full ``expect`` set (the per-peer
    timeout).  ``stall_s``: a candidate whose presence beat freezes
    this long mid-resolve is presumed dead and excluded.  ``clock``/
    ``sleep`` are injectable for deterministic tests.
    """

    def __init__(self, client, rank, world, namespace="cmn",
                 role="elastic", settle_s=1.0, stall_s=10.0, poll_s=0.05,
                 timeout_ms=60_000, clock=time.monotonic,
                 sleep=time.sleep):
        self._client = client
        self.rank = int(rank)
        self.world = int(world)
        self.role = str(role)
        if not self.role or "/" in self.role:
            raise ValueError(f"membership role must be a single path "
                             f"segment, got {role!r}")
        self._ns = str(namespace)
        self._base = f"{namespace}/{self.role}"
        self.settle_s = float(settle_s)
        self.stall_s = float(stall_s)
        self.poll_s = float(poll_s)
        self.timeout_ms = int(timeout_ms)
        self._clock = clock
        self._sleep = sleep
        self._epoch_cache = 0  # monotone last-known decided epoch
        self.stats = {"resolves": 0, "led": 0, "adopted": 0}

    # -- KV primitives -------------------------------------------------------
    # Clients differ: the JAX coordination client has no
    # ``key_value_try_get`` (non-blocking probes ride a short
    # ``blocking_key_value_get``) and refuses overwrites (ALREADY_EXISTS:
    # re-announcements, presence beats and the epoch pointer then need
    # delete-then-set), while a torch.distributed store (``StoreKV``)
    # has the probe and overwrites silently.  These wrappers absorb
    # both shapes, so the protocol runs identically against a store and
    # the in-memory fakes.

    #: probe window for the emulated non-blocking get (ms): long enough
    #: for the server round-trip, short enough that a full world scan
    #: stays well under one poll interval
    PROBE_MS = 5

    def _try_get(self, key):
        c = self._client
        fn = getattr(c, "key_value_try_get", None)
        try:
            if fn is not None:
                return fn(key)
            return c.blocking_key_value_get(key, self.PROBE_MS)
        except Exception:
            return None

    def _set(self, key, value):
        c = self._client
        try:
            c.key_value_set(key, str(value))
            return
        except Exception:
            pass
        try:
            # ALREADY_EXISTS (the real client's overwrite refusal):
            # last-writer-wins via delete-then-set.  Every such key has
            # a single writer by protocol (own presence/announce keys;
            # the epoch pointer is leader-only), so the window is benign
            c.key_value_delete(key)
            c.key_value_set(key, str(value))
        except Exception:
            pass

    def _delete(self, key):
        try:
            self._client.key_value_delete(key)
        except Exception:
            pass

    def _scan(self, prefix, ranks):
        """``{rank: value}`` of ``<prefix>/<rank>`` keys.  One
        ``key_value_dir_get`` round-trip on the real client; per-rank
        probes on fakes that lack it."""
        c = self._client
        fn = getattr(c, "key_value_dir_get", None)
        if fn is not None:
            out = {}
            try:
                for key, value in fn(prefix):
                    tail = str(key).rsplit("/", 1)[-1]
                    if tail.isdigit():
                        out[int(tail)] = value
            except Exception:
                pass
            return {r: out[r] for r in ranks if r in out}
        return {r: v for r in ranks
                if (v := self._try_get(f"{prefix}/{r}")) is not None}

    # -- epochs and views ----------------------------------------------------
    def current_epoch(self):
        """The newest DECIDED epoch (0 = boot, nothing decided yet).

        Decided epochs are APPEND-ONLY keys (``epochs/<k>``, one per
        decision, never overwritten or deleted): a single mutable
        pointer would need the real client's delete-then-set overwrite
        emulation, whose missing-key window lets a concurrent reader
        observe epoch 0 and adopt a long-stale early view.  Discovery
        probes upward from the instance's cached last-known epoch —
        monotone, so it can never regress through any write gap."""
        e = self._epoch_cache
        while self._try_get(f"{self._base}/epochs/{e + 1}") is not None:
            e += 1
        self._epoch_cache = e
        return e

    def bootstrap_view(self):
        """Epoch-0 view: every boot-time controller rank (the world
        before any elasticity event)."""
        return MembershipView(0, range(self.world), role=self.role)

    def current_view(self):
        """The newest decided view, or the bootstrap view when no
        decision has been published yet."""
        epoch = self.current_epoch()
        if epoch == 0:
            return self.bootstrap_view()
        view = self._read_view(epoch)
        return view if view is not None else self.bootstrap_view()

    def _read_view(self, epoch):
        raw = self._try_get(f"{self._base}/e{epoch}/view")
        if raw is None:
            return None
        try:
            members = [int(tok) for tok in str(raw).split(",") if tok != ""]
        except ValueError:
            return None
        return MembershipView(epoch, members, role=self.role)

    # -- announcements (generation-keyed intents) ---------------------------
    def announce_leave(self, note="", rank=None):
        """Post a departure (non-blocking, best-effort): the next
        resolve excludes the rank without waiting out a timeout.  A
        standing join intent is retracted.  ``rank`` defaults to this
        process; a survivor passes a DEAD rank's id when aborting an
        orphaned capacity conversion (the journal proves the intent —
        posting it merely spares everyone the timeout)."""
        rank = self.rank if rank is None else int(rank)
        self._delete(f"{self._base}/join/{rank}")
        self._set(f"{self._base}/leave/{rank}",
                  f"{self.current_epoch()}:{note}")

    def announce_join(self, note="", rank=None):
        """Post a wish to (re-)enter: survivors' join polls see it and
        initiate a grow resolve.  Retracts any standing leave (the
        spot host came back).  ``rank`` defaults to this process."""
        rank = self.rank if rank is None else int(rank)
        self._delete(f"{self._base}/leave/{rank}")
        self._set(f"{self._base}/join/{rank}",
                  f"{self.current_epoch()}:{note}")

    def retract_join(self, rank=None):
        """Scrub a standing join intent without posting a leave — this
        rank's own retraction, or a survivor scrubbing a DEAD rank's
        intent while aborting an orphaned capacity conversion (a rank
        that died at ``REJOINING`` must never be admitted)."""
        rank = self.rank if rank is None else int(rank)
        self._delete(f"{self._base}/join/{rank}")

    def pending_joins(self, view=None):
        """Ranks with a standing join announcement that are NOT in the
        (given or current) view — the survivors' per-iteration poll."""
        view = view if view is not None else self.current_view()
        joins = self._scan(f"{self._base}/join", range(self.world))
        return tuple(r for r in sorted(joins) if r not in view)

    # -- capacity-conversion journal -----------------------------------------
    # A rank changing ROLE (training <-> fleet, the capacity-transfer
    # protocol of the serving fleet's broker) journals each
    # conversion step here BEFORE executing it, so a preempt landing
    # mid-conversion leaves a typed record survivors can roll forward
    # or abort.  The journal lives under ``<ns>/capacity`` — OUTSIDE
    # both role groups' key prefixes, because a conversion by
    # definition spans two groups: members of EITHER group must see
    # the same journal through their own membership object.  Values
    # are ``step:beat:note`` — the beat increments on every write by
    # the converting rank, so an observer can distinguish a LIVE
    # conversion (beat advancing) from an orphaned one (beat frozen,
    # the stall_s idiom measured on the observer's clock).

    def journal_conversion(self, step, note="", rank=None, beat=None):
        """Write (or advance) the conversion-journal entry for ``rank``
        (default: this rank).  ``beat`` defaults to previous+1."""
        rank = self.rank if rank is None else int(rank)
        if beat is None:
            prev = self.read_conversion(rank)
            beat = (prev[1] + 1) if prev is not None else 1
        self._set(f"{self._ns}/capacity/{rank}", f"{step}:{int(beat)}:{note}")

    def read_conversion(self, rank):
        """``(step, beat, note)`` of ``rank``'s journal entry, or None."""
        raw = self._try_get(f"{self._ns}/capacity/{int(rank)}")
        if raw is None:
            return None
        parts = str(raw).split(":", 2)
        if len(parts) != 3:
            return None
        try:
            return (parts[0], int(parts[1]), parts[2])
        except ValueError:
            return None

    def scan_conversions(self):
        """``{rank: (step, beat, note)}`` of every standing journal
        entry — the survivors' orphan-detection scan."""
        found = self._scan(f"{self._ns}/capacity", range(self.world))
        out = {}
        for r in sorted(found):
            entry = self.read_conversion(r)
            if entry is not None:
                out[r] = entry
        return out

    def clear_conversion(self, rank=None):
        """Scrub the journal entry (conversion completed or aborted)."""
        rank = self.rank if rank is None else int(rank)
        self._delete(f"{self._ns}/capacity/{rank}")

    # -- consensus -----------------------------------------------------------
    def resolve(self, expect=None, require=None, timeout_ms=None):
        """Agree on the next epoch's member set; returns the decided
        :class:`MembershipView` (which may EXCLUDE this rank — see the
        module docstring's split-brain note).

        ``expect``: ranks the caller believes alive; the leader decides
        as soon as all of them are present (fast path), or once the
        candidate set has settled for ``settle_s`` (the typed per-peer
        timeout path that drops unresponsive ranks).

        ``require``: ranks that MUST be present before this caller may
        publish ANY decision — the settle path cannot drop them.  A
        JOINER passes the current survivors here: without it, a joiner
        whose resolve never overlaps the survivors' would settle alone
        and decide a second, disjoint world.  Unsatisfiable ``require``
        ends in the typed timeout, never a wrong view.

        Raises :class:`ChannelTimeoutError` when no view lands within
        the deadline."""
        self.stats["resolves"] += 1
        timeout_ms = self.timeout_ms if timeout_ms is None else timeout_ms
        epoch = self.current_epoch() + 1
        prefix = f"{self._base}/e{epoch}"
        deadline = self._clock() + timeout_ms / 1000.0
        beat = 0
        seen = {}  # rank -> (token, observer-local last-change time)
        prev_candidates = None
        last_change = self._clock()
        while True:
            decided = self._read_view(epoch)
            if decided is not None:
                self.stats["adopted"] += 1
                return decided
            if self._clock() >= deadline:
                raise ChannelTimeoutError("membership.resolve",
                                          f"{prefix}/view", timeout_ms,
                                          beat)
            beat += 1
            self._set(f"{prefix}/present/{self.rank}", str(beat))
            present = self._scan(f"{prefix}/present", range(self.world))
            leaves = self._scan(f"{self._base}/leave", range(self.world))
            candidates = []
            for r, tok in sorted(present.items()):
                if r in leaves:
                    continue  # announced departure: never a candidate
                prev = seen.get(r)
                now = self._clock()
                if prev is None:
                    seen[r] = (tok, now, 0)
                elif prev[0] != tok:
                    seen[r] = (tok, now, prev[2] + 1)
                elif r != self.rank and now - prev[1] > self.stall_s:
                    continue  # beat frozen mid-resolve: presumed dead
                candidates.append(r)
            cand = tuple(sorted(candidates))
            if cand != prev_candidates:
                prev_candidates = cand
                last_change = self._clock()
            complete = expect is not None \
                and set(int(e) for e in expect) <= set(cand)
            settled = self._clock() - last_change >= self.settle_s
            required_ok = require is None \
                or set(int(r) for r in require) <= set(cand)
            if cand and cand[0] == self.rank and required_ok \
                    and (complete or settled):
                if not complete:
                    # settle-path zombie screen: a presence key whose
                    # token NEVER changed during this resolve is a
                    # leftover from a dead rank's earlier attempt (live
                    # candidates rebeat every poll loop) — deciding it
                    # into the view would seed the next failure
                    cand = tuple(r for r in cand
                                 if r == self.rank or seen[r][2] >= 1)
                if cand and cand[0] == self.rank:
                    view = MembershipView(epoch, cand, role=self.role)
                    self._publish(view)
                    self.stats["led"] += 1
                    return view
            self._sleep(self.poll_s)

    def read_tree_plan(self, epoch=None):
        """The leader-published multicast tree plan of the (given or
        newest) epoch, or the locally computed plan when the key is
        absent (the plan is a pure function of the view, so the two can
        never disagree — the published key exists for operators and
        cross-version readers)."""
        epoch = self.current_epoch() if epoch is None else int(epoch)
        raw = self._try_get(f"{self._base}/e{epoch}/tree")
        if raw is not None:
            return _parse_tree_plan(raw)
        view = self._read_view(epoch) if epoch else self.bootstrap_view()
        if view is None:
            return None
        return multicast_tree_plan(view.members)

    def _publish(self, view):
        """Leader-side decision write: the view key first, then the
        epoch's append-only marker (a reader that discovers the new
        epoch always finds its view), then the consumed join/leave
        intents are scrubbed (admitted ranks' joins, departed ranks'
        leaves).  The view's multicast tree plan (rooted at the lowest
        member) is published next to it — informational, every member
        recomputes the identical plan."""
        prefix = f"{self._base}/e{view.epoch}"
        self._set(f"{prefix}/view", ",".join(str(m) for m in view.members))
        self._set(f"{prefix}/tree",
                  _serialize_tree_plan(view.tree_plan()))
        self._set(f"{self._base}/epochs/{view.epoch}", "1")
        for r in view.members:
            self._delete(f"{self._base}/join/{r}")
        for r in range(self.world):
            if r not in view:
                self._delete(f"{self._base}/leave/{r}")
        # presence keys of PAST epochs are dead weight: scrub the
        # previous epoch's (best-effort; the current epoch's stay for
        # late adopters still polling them)
        for r in range(self.world):
            self._delete(f"{self._base}/e{view.epoch - 1}/present/{r}")

    def __repr__(self):
        return (f"<ElasticMembership rank={self.rank} world={self.world} "
                f"epoch={self.current_epoch()}>")
