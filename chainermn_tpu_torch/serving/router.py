"""Fleet router: admission and load shedding across live decode replicas.

A copy of the JAX package's module (pure host code).  One host-side
router owns the request ledger and spreads admissions over the fleet's
live replicas:

* **Per-tenant fair spread**: each tenant has its own rotation cursor
  over the live replica list, so one tenant's flood spreads evenly over
  the replicas and two tenants' rotations are decorrelated.  The order is
  deterministic in the call sequence.
* **Bounded per-replica queues**: a replica whose tenant queue is full
  raises :class:`~.errors.QueueSaturatedError`; the router sheds the
  request sideways to the next replica in rotation and re-raises the same
  typed error only when every live replica refused.
  :class:`~.errors.PagePoolExhaustedError` (the could-never-fit check)
  sheds the same way.
* **Reroute on replica loss**: the fleet's shed path calls
  :meth:`FleetRouter.route` again with the dead replica excluded; the
  ledger (``request_id -> replica id``) tells the fleet which in-flight
  requests a replica held.

Every admission records a ``fleet/route`` span, tagged with the granted
replica and the number of sideways sheds.
"""

from __future__ import annotations

from .. import observability
from ..communicators._host_channel import ChannelError
from .errors import PagePoolExhaustedError, QueueSaturatedError, ServingError

__all__ = ["FleetRouter", "NoLiveReplicaError"]


class NoLiveReplicaError(ServingError):
    """The router has no live replica to admit into (the fleet shrank to
    nothing, or every replica was excluded).  Unlike
    :class:`QueueSaturatedError` there is no queue to wait on: the caller
    needs capacity, not patience."""

    def __init__(self, excluded=()):
        self.excluded = tuple(excluded)
        super().__init__(
            "no live replica to route to"
            + (f" (excluded: {list(self.excluded)})" if self.excluded
               else ""))


class FleetRouter:
    """Admission router over a :class:`~.fleet.ReplicaFleet` (or any
    object with a ``live_replicas()`` list of replica handles exposing
    ``rid``/``submit``/``queue_depth``/``tenant_depths``).  ``fleet`` is
    held by reference: the live set is read again on every route."""

    def __init__(self, fleet):
        self.fleet = fleet
        self._cursor = {}       # tenant -> rotation counter
        self.routed = 0
        self.rerouted = 0
        self.spills = 0         # sideways sheds on saturation
        self.by_replica = {}    # rid -> admissions granted
        self.ledger = {}        # request_id -> rid (current placement)

    def _rotation(self, tenant, exclude):
        live = [r for r in self.fleet.live_replicas()
                if r.rid not in exclude]
        if not live:
            raise NoLiveReplicaError(exclude)
        k = self._cursor.get(tenant, 0) % len(live)
        return live[k:] + live[:k]

    def route(self, request, exclude=(), reroute=False):
        """Admit ``request`` into a live replica.  Tries the tenant's
        rotation order, shedding sideways past saturated replicas, and
        re-raises the last typed error when every candidate refused.
        Returns the granted replica id.  ``exclude``: replica ids never
        considered (the fleet's shed path passes the dead one);
        ``reroute``: a replayed in-flight request (counted apart).  A
        replica whose channel fails at submit is skipped and, once the
        placement resolved, shed through the fleet's ``preempt``."""
        obs_on = observability.enabled()
        dead = []
        last_exc = None
        try:
            with observability.span(
                    "fleet/route",
                    tags={"tenant": request.tenant,
                          "request": request.request_id,
                          "reroute": reroute} if obs_on else None):
                order = self._rotation(request.tenant, exclude)
                for i, replica in enumerate(order):
                    try:
                        replica.submit(request)
                    except (QueueSaturatedError,
                            PagePoolExhaustedError) as e:
                        last_exc = e
                        self.spills += 1
                        continue
                    except ChannelError as e:
                        last_exc = e
                        dead.append(replica)
                        continue
                    self._cursor[request.tenant] = \
                        self._cursor.get(request.tenant, 0) + 1 + i
                    self.ledger[request.request_id] = replica.rid
                    self.by_replica[replica.rid] = \
                        self.by_replica.get(replica.rid, 0) + 1
                    self.routed += 1
                    if reroute:
                        self.rerouted += 1
                    if obs_on:
                        observability.instant(
                            "fleet/route",
                            tags={"replica": replica.rid,
                                  "request": request.request_id,
                                  "spills": i, "reroute": reroute})
                    return replica.rid
                raise last_exc
        finally:
            # channel-dead replicas go after this placement resolved (their
            # own work replays through the fleet's shed path)
            shed = getattr(self.fleet, "preempt", None)
            for replica in dead:
                if replica.live and shed is not None:
                    shed(replica.rid, exc=last_exc)

    def queue_depths(self, tenant=None):
        """``{rid: depth}`` over live replicas (one tenant's, or total)."""
        return {r.rid: r.queue_depth(tenant)
                for r in self.fleet.live_replicas()}

    def pressure(self):
        """The deepest per-tenant backlog summed over live replicas (the
        fleet's queue-depth gauge, which the scale policy reads), without
        the metrics registry; 0 with no pending work."""
        totals = {}
        for replica in self.fleet.live_replicas():
            for tenant, d in replica.tenant_depths().items():
                totals[tenant] = totals.get(tenant, 0) + d
        return max(totals.values()) if totals else 0

    def placements(self, rid):
        """Request ids placed on replica ``rid`` (the fleet scrubs
        completed ones from the ledger)."""
        return tuple(req_id for req_id, r in self.ledger.items()
                     if r == rid)
