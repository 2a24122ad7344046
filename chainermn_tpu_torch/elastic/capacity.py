"""Capacity transfer: one pool of ranks following the traffic.

The port of ``chainermn_tpu.elastic.capacity`` (host code).
:class:`~chainermn_tpu_torch.serving.fleet.QueueDepthScalePolicy` reads
the queue-depth gauges and emits +1/-1; :class:`CapacityBroker` executes
them: sustained queue pressure moves a training rank into the serving
fleet (a clean leave, the survivors' shrink keeping the global batch, an
admission under the ``fleet`` role, the serving weights adopted over the
multicast tree), and drained queues move it back (a retire, then a rejoin
of training through the snapshot-sync grow path).

The conversion is a state machine::

    LEAVE_ANNOUNCED -> CONVERTING -> SERVING -> RETIRING -> REJOINING

journaled in the KV store (``<ns>/capacity/<rank>``, outside both role
groups' keys, see
:meth:`~chainermn_tpu_torch.communicators.ElasticMembership.journal_conversion`)
before each step runs, so a preempt at any step leaves a record the
survivors act on: :meth:`CapacityBroker.recover_orphans` finds an entry
whose beat has been frozen for ``stale_s`` on the observer's clock and
rolls the world forward, completing the step where its effects landed and
aborting it (scrubbing a half-admitted replica, a standing join intent)
where they did not.

Rails: the policy's hysteresis and the broker's per-direction cooldowns
(``convert_cooldown_s``/``retire_cooldown_s``) keep oscillating load from
thrashing conversions; training never shrinks below ``min_world`` and the
fleet never below one replica (:class:`CapacityFloorError`, carrying both
role views); every step consults the fault schedule (op
``"capacity.convert"``, ``step=`` the state name), so a test can kill a
conversion at any step.

Observability: spans ``capacity/leave``, ``capacity/convert`` and
``capacity/retire``, the instant ``capacity/orphan``, and the gauge
``chainermn_tpu_role_world_size{role}``.
"""

from __future__ import annotations

import time

from .. import observability
from ..communicators._membership import MembershipView

__all__ = ["CONVERSION_STEPS", "CapacityFloorError", "CapacityProtocolError",
           "CapacityBroker", "LocalTrainGroup"]

#: the conversion state machine, in order: the first three steps are the
#: way into the fleet (``SERVING`` is where a converted rank parks), the
#: last two the way back
CONVERSION_STEPS = ("LEAVE_ANNOUNCED", "CONVERTING", "SERVING", "RETIRING",
                    "REJOINING")

#: legal journal transitions (``None``: no standing entry)
_NEXT = {None: ("LEAVE_ANNOUNCED",),
         "LEAVE_ANNOUNCED": ("CONVERTING",),
         "CONVERTING": ("SERVING",),
         "SERVING": ("RETIRING",),
         "RETIRING": ("REJOINING",),
         "REJOINING": ()}

#: the fault-schedule op every conversion step consults
FAULT_OP = "capacity.convert"


class CapacityFloorError(RuntimeError):
    """A transfer would breach a role's floor (training below
    ``min_world``, or the fleet below one live replica).  Refused, not
    clamped; carries both role views."""

    def __init__(self, message, training_view=None, fleet_view=None):
        self.training_view = training_view
        self.fleet_view = fleet_view
        detail = []
        if training_view is not None:
            detail.append(f"training={list(training_view.members)}")
        if fleet_view is not None:
            detail.append(f"fleet={list(fleet_view.members)}")
        super().__init__(message + (f" ({', '.join(detail)})"
                                    if detail else ""))


class CapacityProtocolError(RuntimeError):
    """An illegal conversion-state transition (a journal write that skips
    or rewinds the state machine): a caller's bug, never a runtime
    condition."""


class LocalTrainGroup:
    """Single-controller stand-in for the training side of a transfer (the
    counterpart of the fleet's ``_LocalConsensus``): leaves and joins apply
    at once, the epoch moves on every change, and the journal is a dict.
    Across processes an ``ElasticMembership`` over the shared store takes
    its place."""

    role = "elastic"

    def __init__(self, world=2, rank=0):
        self.rank = int(rank)
        self.world = int(world)
        self._epoch = 0
        self._members = tuple(range(self.world))
        self._journal = {}

    def current_epoch(self):
        return self._epoch

    def current_view(self):
        return MembershipView(self._epoch, self._members, role=self.role)

    def announce_leave(self, note="", rank=None):
        r = self.rank if rank is None else int(rank)
        if r in self._members:
            self._members = tuple(m for m in self._members if m != r)
            self._epoch += 1

    def announce_join(self, note="", rank=None):
        r = self.rank if rank is None else int(rank)
        if r not in self._members:
            self._members = tuple(sorted(self._members + (r,)))
            self._epoch += 1

    def retract_join(self, rank=None):
        pass

    def pending_joins(self, view=None):
        return ()

    # -- the conversion journal (the KV protocol's, in a dict) ---------------
    def journal_conversion(self, step, note="", rank=None, beat=None):
        r = self.rank if rank is None else int(rank)
        prev = self._journal.get(r)
        if beat is None:
            beat = (prev[1] + 1) if prev is not None else 1
        self._journal[r] = (str(step), int(beat), str(note))

    def read_conversion(self, rank):
        return self._journal.get(int(rank))

    def scan_conversions(self):
        return dict(self._journal)

    def clear_conversion(self, rank=None):
        self._journal.pop(self.rank if rank is None else int(rank), None)


class CapacityBroker:
    """The transfer executor over one training group and one serving fleet.

    ``train``: the training side's membership, an
    :class:`~chainermn_tpu_torch.communicators.ElasticMembership` (acting
    for its own rank, or another one through ``rank=``) or a
    :class:`LocalTrainGroup`; it carries the conversion journal.
    ``fleet``: the :class:`~chainermn_tpu_torch.serving.fleet.ReplicaFleet`
    (its public join/retire/preempt/discard surface only).
    ``engine_factory``: ``factory(rank) -> ServingEngine`` (or a replica
    handle) for a converting rank handed no engine; the tree sync
    overwrites its weights with the root's.  ``recovery``: an
    :class:`~chainermn_tpu_torch.extensions.ElasticRecovery`; when the
    broker runs on the converting rank, the leave and the rejoin go
    through its ``capacity_leave``/``capacity_rejoin``.  ``min_world``:
    the training floor (the fleet's is ``max(1, fleet.min_replicas)``).
    ``convert_cooldown_s``/``retire_cooldown_s``: per-direction cooldowns
    :meth:`apply` holds.  ``stale_s``: how long a journal beat must stay
    frozen, on this observer's clock, before :meth:`recover_orphans`
    treats the conversion as orphaned.  ``schedule``: a fault schedule
    consulted at every step.  ``auto_apply=False``: :meth:`apply` counts
    the decision and moves nothing.  ``donor(view)``: picks the rank to
    convert (default the highest)."""

    def __init__(self, train, fleet, engine_factory=None, recovery=None,
                 min_world=1, convert_cooldown_s=0.0, retire_cooldown_s=0.0,
                 stale_s=2.0, schedule=None, auto_apply=True, donor=None,
                 clock=time.monotonic, sleep=time.sleep):
        self.train = train
        self.fleet = fleet
        self.engine_factory = engine_factory
        self.recovery = recovery
        self.min_world = int(min_world)
        self.fleet_floor = max(1, getattr(fleet, "min_replicas", 1))
        self.convert_cooldown_s = float(convert_cooldown_s)
        self.retire_cooldown_s = float(retire_cooldown_s)
        self.stale_s = float(stale_s)
        self.schedule = schedule
        self.auto_apply = bool(auto_apply)
        self._donor = donor
        self._clock = clock
        self._sleep = sleep
        self.converted = {}          # training rank -> fleet rid
        self._last_convert = None
        self._last_retire = None
        self._orphan_seen = {}       # rank -> ((step, beat), first seen)
        self.stats = {"conversions": 0, "retires": 0, "role_transfers": 0,
                      "convert_s": 0.0, "floor_refusals": 0, "surfaced": 0,
                      "aborted": 0, "rolled_forward": 0}
        self._publish_gauges()

    # -- plumbing ------------------------------------------------------------

    @property
    def train_role(self):
        return getattr(self.train, "role", "elastic")

    def _fleet_view(self):
        view = getattr(self.fleet, "view", None)
        if view is not None:
            return view
        return MembershipView(0, [r.rid for r in self.fleet.live_replicas()],
                              role="fleet")

    def _hook(self, step):
        """One fault-schedule consult a step: a ``delay`` sleeps in place,
        any other fault raises here, after the step was journaled and
        before it ran (the mid-conversion crash the recovery handles)."""
        if self.schedule is None:
            return
        fault = self.schedule.on_call(FAULT_OP, step=step)
        if fault is None:
            return
        if fault.action == "delay":
            self._sleep(fault.spec.delay_s)
            return
        raise fault.make_exception()

    def _journal(self, rank, step, note=""):
        prev = self.train.read_conversion(rank)
        prev_step = prev[0] if prev is not None else None
        if step not in _NEXT.get(prev_step, ()):
            raise CapacityProtocolError(
                f"illegal conversion transition {prev_step!r} -> {step!r} "
                f"for rank {rank} (order: {' -> '.join(CONVERSION_STEPS)})")
        self.train.journal_conversion(step, note=note, rank=rank)

    def _train_leave(self, rank, note):
        if self.recovery is not None and rank == self.recovery.stable_rank:
            self.recovery.capacity_leave(note=note)
        elif getattr(self.train, "rank", None) == rank:
            self.train.announce_leave(note=note)
        else:
            self.train.announce_leave(note=note, rank=rank)

    def _train_join(self, rank, note):
        if self.recovery is not None and rank == self.recovery.stable_rank:
            self.recovery.capacity_rejoin(note=note)
        elif getattr(self.train, "rank", None) == rank:
            self.train.announce_join(note=note)
        else:
            self.train.announce_join(note=note, rank=rank)

    def _publish_gauges(self):
        gauge = observability.registry().gauge(
            "chainermn_tpu_role_world_size",
            help="controller ranks per role group (the capacity broker's "
                 "two-role world view)")
        gauge.set(self.train.current_view().size, role=self.train_role)
        gauge.set(len(self.fleet.live_replicas()), role="fleet")

    # -- the two legs --------------------------------------------------------

    def convert_to_serving(self, rank=None, engine=None, now=None):
        """Training to fleet: a clean leave, the fleet's admission, the
        tree weight sync.  Returns the converted rank.  Raises
        :class:`CapacityFloorError` when training would shrink below
        ``min_world``; a fault mid-way leaves the journal at the step it
        reached."""
        t0 = self._clock()
        train_view = self.train.current_view()
        if rank is None:
            rank = (self._donor(train_view) if self._donor is not None
                    else max(train_view.members))
        rank = int(rank)
        fleet_view = self._fleet_view()
        if rank not in train_view:
            raise CapacityFloorError(
                f"rank {rank} is not a training member",
                training_view=train_view, fleet_view=fleet_view)
        if train_view.size - 1 < self.min_world:
            self.stats["floor_refusals"] += 1
            raise CapacityFloorError(
                f"converting rank {rank} would shrink training below "
                f"min_world={self.min_world}",
                training_view=train_view, fleet_view=fleet_view)
        with observability.span("capacity/leave", tags={"rank": rank}):
            self._journal(rank, "LEAVE_ANNOUNCED", note="queue pressure")
            self._hook("LEAVE_ANNOUNCED")
            self._train_leave(rank,
                              note="capacity transfer: converting to serving")
        with observability.span("capacity/convert", tags={"rank": rank}):
            self._journal(rank, "CONVERTING")
            self._hook("CONVERTING")
            if engine is None:
                if self.engine_factory is None:
                    raise ValueError("convert_to_serving needs engine= or a "
                                     "broker engine_factory")
                engine = self.engine_factory(rank)
            rid = rank if rank not in self.fleet.replicas \
                else max(self.fleet.replicas) + 1
            self.fleet.join(engines={rid: engine})
            self._journal(rank, "SERVING")
            self._hook("SERVING")
        self.converted[rank] = rid
        self.stats["conversions"] += 1
        self.stats["role_transfers"] += 1
        self.stats["convert_s"] += self._clock() - t0
        self._last_convert = now if now is not None else self._clock()
        self._publish_gauges()
        return rank

    def retire_to_training(self, rank=None, now=None):
        """Fleet to training: a graceful retire (in-flight work reroutes
        first), then the rejoin through the training grow path.  Returns
        the rank.  Raises :class:`CapacityFloorError` when the fleet would
        keep no live replica."""
        t0 = self._clock()
        if rank is None:
            if not self.converted:
                raise CapacityFloorError(
                    "no converted rank to retire",
                    training_view=self.train.current_view(),
                    fleet_view=self._fleet_view())
            rank = next(reversed(self.converted))   # the newest stint
        rank = int(rank)
        rid = self.converted.get(rank, rank)
        live = {r.rid for r in self.fleet.live_replicas()}
        if rid in live and len(live) - 1 < self.fleet_floor:
            self.stats["floor_refusals"] += 1
            raise CapacityFloorError(
                f"retiring replica {rid} would shrink the fleet below its "
                f"floor of {self.fleet_floor}",
                training_view=self.train.current_view(),
                fleet_view=self._fleet_view())
        with observability.span("capacity/retire",
                                tags={"rank": rank, "rid": rid}):
            self._journal(rank, "RETIRING")
            self._hook("RETIRING")
            if rid in live:
                self.fleet.retire(rid, now=now)
            self._journal(rank, "REJOINING")
            self._hook("REJOINING")
            self._train_join(rank, note="capacity transfer: rejoining "
                                        "training")
            self.train.clear_conversion(rank)
        self.converted.pop(rank, None)
        self.stats["retires"] += 1
        self.stats["role_transfers"] += 1
        self.stats["convert_s"] += self._clock() - t0
        self._last_retire = now if now is not None else self._clock()
        self._publish_gauges()
        return rank

    # -- auto-apply ----------------------------------------------------------

    def apply(self, decision, now=None):
        """Execute one scale decision (+1/-1/0).  Returns ``("convert",
        rank)``, ``("retire", rank)`` or ``None``.  A cooldown, a floor or
        ``auto_apply=False`` answers ``None`` (the last counts the
        decision in ``stats["surfaced"]``): the broker never half-applies,
        and floors raise only on direct calls."""
        if not decision:
            return None
        if not self.auto_apply:
            self.stats["surfaced"] += 1
            return None
        t = now if now is not None else self._clock()
        if decision > 0:
            if self._last_convert is not None \
                    and t - self._last_convert < self.convert_cooldown_s:
                return None
            if self.train.current_view().size - 1 < self.min_world:
                self.stats["floor_refusals"] += 1
                return None
            return ("convert", self.convert_to_serving(now=now))
        if not self.converted:
            return None   # nothing of ours to give back
        if self._last_retire is not None \
                and t - self._last_retire < self.retire_cooldown_s:
            return None
        try:
            rank = self.retire_to_training(now=now)
        except CapacityFloorError:
            self.stats["floor_refusals"] += 1
            return None
        return ("retire", rank)

    # -- orphan recovery -----------------------------------------------------

    def recover_orphans(self, now=None):
        """The survivors' sweep: conversions whose journal beat froze for
        ``stale_s`` are rolled forward without their rank.  Returns
        ``(rank, step, action)`` tuples, ``action`` ``"roll-forward"``
        (the step's effects landed: complete it) or ``"abort"`` (they did
        not: scrub every trace).  A ``SERVING`` stint whose replica is
        live parks on purpose and is never an orphan."""
        t = now if now is not None else self._clock()
        actions = []
        standing = self.train.scan_conversions()
        for rank in list(self._orphan_seen):
            if rank not in standing:
                del self._orphan_seen[rank]    # journal cleared: done
        for rank, (step, beat, note) in sorted(standing.items()):
            live = {r.rid for r in self.fleet.live_replicas()}
            rid = self.converted.get(rank, rank)
            if step == "SERVING" and rid in live:
                self._orphan_seen.pop(rank, None)
                continue                       # a healthy stint
            prev = self._orphan_seen.get(rank)
            if prev is None or prev[0] != (step, beat):
                self._orphan_seen[rank] = ((step, beat), t)
                continue                       # first sight, or advancing
            if t - prev[1] < self.stale_s:
                continue                       # not stale yet
            actions.append((rank, step,
                            self._roll(rank, step, rid, live, now=now)))
            self._orphan_seen.pop(rank, None)
        if actions:
            self._publish_gauges()
        return tuple(actions)

    def _roll(self, rank, step, rid, live, now=None):
        """One orphaned conversion resolved (the failure matrix): complete
        a step whose effects landed, abort one whose effects did not, and
        leave the rank in neither role group."""
        observability.instant("capacity/orphan",
                              tags={"rank": rank, "step": step})
        if step == "LEAVE_ANNOUNCED":
            # died before the fleet, maybe before its own leave landed:
            # post it for the dead rank (idempotent) and scrub
            self._train_leave(rank, note="orphaned conversion abort")
            action = "abort"
        elif step == "CONVERTING":
            if rid in live:
                # the join landed, only the SERVING write was lost
                self._journal(rank, "SERVING", note="rolled forward")
                self.converted[rank] = rid
                self.stats["rolled_forward"] += 1
                return "roll-forward"
            self.fleet.discard(rid)   # a half-admitted replica, never live
            action = "abort"
        elif step == "SERVING":
            # the replica died while serving: the fleet's shed rerouted its
            # work already (live stints were skipped above)
            if rid in self.fleet.replicas and rid in live:
                self.fleet.preempt(rid, now=now)
            action = "roll-forward"
        elif step == "RETIRING":
            # complete the stalled retire; the rank is dead, so no rejoin
            if rid in live:
                self.fleet.preempt(rid, now=now)
            elif rid in self.fleet.replicas:
                self.fleet.discard(rid)
            action = "roll-forward"
        elif step == "REJOINING":
            # died between the retire and the admission: scrub the join
            # intent so that a dead rank is never admitted
            retract = getattr(self.train, "retract_join", None)
            if retract is not None:
                retract(rank=rank)
            action = "abort"
        else:
            action = "abort"   # an unknown step: scrub
        self.converted.pop(rank, None)
        self.train.clear_conversion(rank)
        self.stats["aborted" if action == "abort" else "rolled_forward"] += 1
        return action

    def __repr__(self):
        return (f"<CapacityBroker converted={sorted(self.converted)} "
                f"transfers={self.stats['role_transfers']}>")
