"""Elastic shrink and grow: training that survives preemptible capacity.

The port of ``chainermn_tpu.extensions.elastic``.
:class:`~.failure_recovery.FailureRecovery` recovers faults at a fixed
world size; on preemptible capacity a rank leaves (its host reclaimed)
and later one joins.  The exchange is a pure function of the world
(bucket plans, the sharded update's chunks), so a changed world size
means re-planning, never a restart.

:class:`ElasticRecovery` extends the supervisor with three moves, all on
the membership protocol (:class:`~..communicators.ElasticMembership`):

* **shrink**: a survivor's typed failure (channel timeout, lost-peer
  heartbeat, injected fault) triggers a membership resolve in which
  unresponsive peers time out; the survivors rebuild the communicator over
  the decided members (:class:`~..communicators.ElasticMeshCommunicator`,
  a new default process group), re-plan every size-dependent structure
  through ``optimizer.change_communicator``, converge on the
  checkpointer's consensus snapshot, and keep training.
* **leave**: the preempted rank (:class:`RankPreempted`) announces a
  ``leave`` so the survivors never wait out a timeout on it, then
  fail-stops (the default: the scheduler restarts the process) or parks
  and re-joins (``rejoin_after_s``).
* **grow**: the survivors poll join announcements at iteration
  boundaries (rank 0 reads the store, a broadcast over the members makes
  every survivor enter the resize at the same call site), admit the
  joiner through the same resolve, rebuild at the larger size, ship the
  newest snapshot to the joiner, and consensus-load, so every member
  resumes from the same generation.

The global batch across resizes (:func:`global_batch_plan`): a rank of
the port feeds its own batch.  When the main iterator runs over a
scattered shard (``scatter_dataset``: a per-rank batch), a resize
re-slices the shard for the new world (:func:`rescatter_dataset`) and sets
the per-rank batch so that the global batch stays; when every rank
iterates the same data (the JAX convention: the global batch, each rank
taking its part), the plan is only validated.  Either way a global batch
that does not divide over the new world fails at the resize, with the
plan attached, not inside the first resized step.

Detection: a departed rank is detected at the control plane (a host
channel op's typed timeout, a heartbeat, an announced leave) between
steps; keep a per-iteration channel op in the loop (the multi-node
iterator's batch broadcast, a beacon, the join poll).  The object calls
ride the host channel on an :class:`ElasticMeshCommunicator` of more than
one member and under the fault-injection wrapper; a plain
:class:`~..communicators.MeshCommunicator` sends them over the process
group, where a departed peer shows as the backend's error, not a channel
error: ``DistBackendError``/``DistNetworkError``, or gloo's lost
connection (a ``RuntimeError`` naming ``Connection closed by peer`` or
``Connection reset by peer``).
Over any communicator but an :class:`ElasticMeshCommunicator` those count
as recoverable too (:func:`backend_peer_lost`), so the survivor of a peer
that exits without announcing shrinks as the JAX package's does on its
``ChannelError``.

Snapshots for joiners: the npz checkpointer's newest file is shipped to
the joiners over the members' channel.  The per-rank DCP checkpointer
keeps each rank's chunk in that rank's directory, so a joiner reads the
survivors' directories (a directory every rank can read).
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

from .. import observability
from ..communicators._host_channel import ChannelError, HostChannel
from ..communicators._membership import ElasticMembership
from ..communicators.fault_schedule import InjectedFault, RankPreempted
from ..communicators.mesh_communicator import ElasticMeshCommunicator
from .failure_recovery import (FailureRecovery, RecoveryGivingUp,
                               _drop_exchanges)

__all__ = ["ElasticRecovery", "global_batch_plan", "ElasticConfigError",
           "create_elastic_membership", "backend_peer_lost"]

_ELASTIC_RECOVERABLE = (InjectedFault, ChannelError, RankPreempted)

#: what gloo's TCP transport raises, as a plain ``RuntimeError``, on a rank
#: in a collective (or entering one) once a peer's process has gone: the
#: peer's socket read as closed, or reset when it went with bytes unread
_GLOO_PEER_LOST = ("Connection closed by peer", "Connection reset by peer")


def backend_peer_lost(exc):
    """Whether ``exc`` is the process group's report of a lost peer:
    ``torch.distributed``'s ``DistBackendError`` (NCCL's watchdog and
    abort) or ``DistNetworkError``, or gloo's closed or reset connection.
    Any other ``RuntimeError`` is not."""
    import torch.distributed as dist
    if isinstance(exc, (dist.DistBackendError, dist.DistNetworkError)):
        return True
    return isinstance(exc, RuntimeError) \
        and any(m in str(exc) for m in _GLOO_PEER_LOST)


class ElasticConfigError(RuntimeError):
    """A resize produced a configuration the run cannot satisfy (e.g.
    the global batch does not divide over the new world and the policy
    forbids accumulation).  Carries the computed ``plan``."""

    def __init__(self, message, plan=None):
        self.plan = plan
        super().__init__(message)


def global_batch_plan(global_bs, world_size, policy="rescale",
                      max_per_rank=None):
    """The global-batch preservation table: how one logical step of ``global_bs`` samples is fed to a world of
    ``world_size`` ranks.

    Returns ``{"policy", "global_bs", "world_size", "dispatch_bs",
    "per_rank_bs", "accum_steps"}`` where one logical step =
    ``accum_steps`` dispatches of ``dispatch_bs`` samples
    (``dispatch_bs × accum_steps == global_bs``), each dispatch
    sharding ``per_rank_bs = dispatch_bs / world_size`` per rank.

    * ``"rescale"`` (default): one dispatch of the full global batch;
      the per-rank share rescales.  Requires ``global_bs % world_size == 0`` and (when
      given) ``per_rank_bs <= max_per_rank``; otherwise falls through
      to the accumulation search so the caller still gets a feasible
      plan to act on (or reject).
    * ``"accumulate"``: the smallest ``accum_steps`` dividing
      ``global_bs`` whose dispatch batch divides over the world (and
      fits ``max_per_rank``) — per-rank memory stays bounded on a
      shrink at the cost of extra dispatches.

    Pure function — every member computes the identical plan from the
    identical (global_bs, world_size) pair.
    """
    if policy not in ("rescale", "accumulate"):
        raise ValueError(f"unknown global-batch policy {policy!r} "
                         f"(rescale|accumulate)")
    global_bs = int(global_bs)
    world_size = int(world_size)
    if global_bs < 1 or world_size < 1:
        raise ValueError(f"global_bs={global_bs}/world_size={world_size} "
                         f"must be >= 1")

    def fits(dispatch):
        per = dispatch // world_size
        return dispatch % world_size == 0 and per >= 1 \
            and (max_per_rank is None or per <= max_per_rank)

    if policy == "rescale" and fits(global_bs):
        return {"policy": "rescale", "global_bs": global_bs,
                "world_size": world_size, "dispatch_bs": global_bs,
                "per_rank_bs": global_bs // world_size, "accum_steps": 1}
    for k in range(1 if policy == "accumulate" else 2, global_bs + 1):
        if global_bs % k:
            continue
        dispatch = global_bs // k
        if fits(dispatch):
            return {"policy": "accumulate", "global_bs": global_bs,
                    "world_size": world_size, "dispatch_bs": dispatch,
                    "per_rank_bs": dispatch // world_size,
                    "accum_steps": k}
    raise ElasticConfigError(
        f"no feasible batch plan: global_bs={global_bs} cannot be "
        f"preserved over world_size={world_size}"
        + (f" within max_per_rank={max_per_rank}" if max_per_rank
           else ""),
        plan=None)


def create_elastic_membership(comm, **kwargs):
    """An :class:`ElasticMembership` bound to this process, over the
    store of the communicator's host channel (its boot channel for an
    elastic communicator): this process's stable rank in the boot world.
    Returns ``None`` when no cross-process channel exists (a world of
    one: pass a membership to run elastically)."""
    ch = getattr(comm, "_template", None)
    if ch is None:
        ch = comm._host_channel() if hasattr(comm, "_host_channel") \
            else None
    if ch is None:
        return None
    kwargs.setdefault("namespace", ch._ns.split("/el", 1)[0])
    return ElasticMembership(
        ch._client, rank=getattr(ch, "stable_rank", ch.process_id),
        world=ch.num_processes, **kwargs)


class ElasticRecovery(FailureRecovery):
    """The elastic supervisor extension (see the module docstring).

    Beyond :class:`FailureRecovery`'s arguments:

    ``membership``: an :class:`ElasticMembership` (default: over the
    communicator's host channel; ``None`` in a world of one, where
    elasticity needs a membership passed in).
    ``comm_factory``: ``factory(view) -> communicator``, called lock-step
    by every member of a decided view (default:
    :class:`ElasticMeshCommunicator` over the view's members with the
    boot communicator's exchange knobs, its two-level split kept when it
    still divides the new world).
    ``min_world``: shrink floor: a smaller view raises
    :class:`RecoveryGivingUp` (with the view in the message).
    ``rejoin_after_s``: a preempted rank re-raises and fail-stops when
    ``None`` (the default: the scheduler restarts the process), else
    parks that long, announces ``join`` and waits for re-admission.
    ``batch_policy``/``max_per_rank_bs``: the global-batch policy checked
    at each resize (:func:`global_batch_plan`).
    ``join_poll_interval``: iterations between the survivors' lock-step
    join polls (one object broadcast each).
    ``recoverable``: left at ``None``, the typed faults above and, while
    the communicator is not an :class:`ElasticMeshCommunicator` (its object
    calls then ride the process group), the backend's peer-loss errors
    (:func:`backend_peer_lost`).
    """

    priority = 100
    name = "ElasticRecovery"

    def __init__(self, checkpointer=None, comm=None, membership=None,
                 comm_factory=None, min_world=1, rejoin_after_s=None,
                 batch_policy="rescale", max_per_rank_bs=None,
                 join_poll_interval=1, recoverable=None,
                 unrecoverable=None, max_recoveries=3, cooldown_s=0.0,
                 sleep=time.sleep, on_recover=None, on_resize=None,
                 verbose=True, resolve_timeout_ms=None):
        super().__init__(checkpointer=checkpointer, comm=comm,
                         recoverable=(tuple(recoverable)
                                      if recoverable is not None
                                      else _ELASTIC_RECOVERABLE),
                         # a lost peer is what elasticity recovers:
                         # nothing is unrecoverable by default here
                         unrecoverable=(tuple(unrecoverable)
                                        if unrecoverable is not None
                                        else ()),
                         max_recoveries=max_recoveries,
                         cooldown_s=cooldown_s, sleep=sleep,
                         on_recover=on_recover, verbose=verbose)
        if membership is None and self.comm is not None:
            membership = create_elastic_membership(self.comm)
        self.membership = membership
        self._boot_comm = self.comm
        # the channel the default factory builds over: the boot
        # communicator's, else (a world of one) one over the membership's
        # store
        channel = None
        if self.comm is not None:
            channel = getattr(self.comm, "_template", None)
            if channel is None and hasattr(self.comm, "_host_channel"):
                channel = self.comm._host_channel()
        if channel is None and membership is not None \
                and hasattr(membership, "_client"):
            channel = HostChannel(namespace=membership._ns,
                                  client=membership._client,
                                  process_id=membership.rank,
                                  num_processes=membership.world)
        self._boot_channel = channel
        self._world_size = self.comm.size if self.comm is not None else 1
        self.comm_factory = comm_factory
        self.min_world = int(min_world)
        self.rejoin_after_s = rejoin_after_s
        self.batch_policy = batch_policy
        self.max_per_rank_bs = max_per_rank_bs
        self.on_resize = on_resize
        self.resolve_timeout_ms = resolve_timeout_ms
        self.view = membership.current_view() if membership is not None \
            else None
        self.trigger = (int(join_poll_interval), "iteration")
        self._backend_peer_loss = recoverable is None

    def can_recover(self, exc):
        """:meth:`FailureRecovery.can_recover`, and with the default
        ``recoverable`` over a communicator that is not an
        :class:`ElasticMeshCommunicator`, a peer lost in the backend."""
        if super().can_recover(exc):
            return True
        return (self._backend_peer_loss
                and not isinstance(self.comm, ElasticMeshCommunicator)
                and backend_peer_lost(exc)
                and not isinstance(exc, self.unrecoverable))

    # -- identity ------------------------------------------------------------
    @property
    def stable_rank(self):
        """This process's stable rank (membership identity)."""
        if self.membership is not None:
            return self.membership.rank
        return getattr(self.comm, "stable_rank",
                       getattr(self.comm, "rank", 0))

    def _log(self, msg):
        if self.verbose:
            print(f"chainermn_tpu elastic[r{self.stable_rank}]: {msg}",
                  file=sys.stderr)

    # -- per-iteration join poll (the grow trigger) -------------------------
    def __call__(self, trainer):
        if self.membership is None or self.view is None:
            return
        # lock-step poll: rank 0 reads the store and broadcasts what it
        # saw, so every survivor enters (or skips) the resize at the same
        # call site
        mine = self.membership.pending_joins(self.view) \
            if self.comm.rank == 0 else None
        joins = tuple(self.comm.bcast_obj(mine, root=0) or ())
        if joins:
            self._log(f"admitting joins {list(joins)} at iteration "
                      f"{trainer.updater.iteration}")
            self._resize(trainer,
                         expect=set(self.view.members) | set(joins))

    # -- supervisor protocol -------------------------------------------------
    def recover(self, trainer, exc):
        if self.membership is None:
            # no membership protocol: degrade to the fixed-size
            # supervisor (RankPreempted then fail-stops)
            if isinstance(exc, RankPreempted):
                raise exc
            return super().recover(trainer, exc)
        self._spend_recovery_budget(exc)
        if self.cooldown_s:
            self._sleep(self.cooldown_s)
        if isinstance(exc, RankPreempted) and (
                exc.rank is None or exc.rank == self.stable_rank):
            return self._preempted(trainer, exc)
        # survivor path: a typed failure that may mean lost peers.  A
        # fault with no casualties decides the same members at a new
        # epoch: the rebuild doubles as the fixed-size quiesce
        self._log(f"recovering from {type(exc).__name__}: {exc} "
                  f"(attempt {self.stats['recoveries']}"
                  f"/{self.max_recoveries})")
        observability.instant("elastic/preempt_detect",
                              tags={"exc": type(exc).__name__,
                                    "rank": getattr(exc, "rank", None)})
        with observability.span("recover/quiesce"):
            self._quiesce_transport()
            _drop_exchanges(trainer)
        suspects = set()
        rank = getattr(exc, "rank", None)
        if rank is not None and not isinstance(exc, InjectedFault):
            rank = int(rank)
            # a channel-borne rank (PeerLostError from the members-only
            # sub-channel) is a slot of the current view: translate it
            members = getattr(self.comm, "members", None)
            if members is not None and 0 <= rank < len(members):
                rank = members[rank]
            suspects.add(rank)
        expect = set(self.view.members) - suspects
        resumed = self._resize(trainer, expect=expect)
        if self.on_recover is not None:
            self.on_recover(trainer, exc, resumed)
        return resumed

    # -- capacity transfer ---------------------------------------------------
    # The CapacityBroker's view of this supervisor: a training rank moving
    # into the serving fleet departs cleanly (no exception, no rollback:
    # the survivors' shrink keeps the global batch as after a preemption)
    # and later re-enters through the guarded admission a preempted rank's
    # return takes.
    def capacity_leave(self, note="capacity transfer: to serving"):
        """Announce this rank's clean departure into the serving fleet.  The
        survivors shrink without a timeout (the announced-leave fast path).
        Returns the epoch at departure, so that the caller can wait for the
        shrink's decision before anything that would race it."""
        epoch = self.membership.current_epoch()
        self.membership.announce_leave(note=note)
        observability.instant("capacity/leave_announced",
                              tags={"rank": self.stable_rank})
        self._log(f"clean leave announced ({note})")
        return epoch

    def capacity_rejoin(self, trainer=None,
                        note="capacity transfer: rejoin"):
        """Re-enter training after a serving stint: the two-attempt
        admission of a preempted rank's return, ``require=`` the survivors
        (a joiner never settles a world alone).  With a ``trainer`` the
        full adopt runs (rebuild, snapshot sync, consensus load) and its
        result is returned; without one the decided view is adopted and
        returned.  Raises :class:`RecoveryGivingUp` when the survivors
        never admit this rank."""
        view = prev = self.membership.current_view()
        for attempt in range(2):
            self.membership.announce_join(note=note)
            prev = self.membership.current_view()
            self._log(f"capacity rejoin (current view "
                      f"{list(prev.members)}, attempt {attempt + 1})")
            with observability.span("elastic/resolve",
                                    tags={"rejoin": True, "capacity": True,
                                          "attempt": attempt + 1}):
                view = self.membership.resolve(
                    expect=set(prev.members) | {self.stable_rank},
                    require=set(prev.members) - {self.stable_rank},
                    timeout_ms=self.resolve_timeout_ms)
            if self.stable_rank in view:
                break
        if self.stable_rank not in view:
            raise RecoveryGivingUp("capacity re-join was not admitted",
                                   membership=view)
        if trainer is not None:
            return self._adopt(trainer, view, prev_view=prev)
        self.view = view
        return view

    # -- the three moves -----------------------------------------------------
    def _preempted(self, trainer, exc):
        """This rank's capacity was reclaimed: announce the departure
        (the survivors then shrink without a timeout), then fail-stop, or
        park and re-join.  The park waits for the survivors' shrink
        decision (the epoch advancing) before the ``rejoin_after_s``
        dwell: a join announced while the departure is being resolved
        would collapse the shrink and the grow into one no-op resolve."""
        epoch_at_leave = self.membership.current_epoch()
        self.membership.announce_leave(note=str(exc))
        observability.instant("elastic/preempt_detect",
                              tags={"exc": type(exc).__name__,
                                    "self_preempted": True})
        self._log(f"preempted ({exc}); leave announced")
        if self.rejoin_after_s is None:
            raise exc  # hard exit: the scheduler owns the restart
        timeout_ms = self.resolve_timeout_ms \
            if self.resolve_timeout_ms is not None \
            else self.membership.timeout_ms
        deadline = time.monotonic() + timeout_ms / 1000.0
        while self.membership.current_epoch() == epoch_at_leave \
                and time.monotonic() < deadline:
            self._sleep(self.membership.poll_s)
        self._sleep(self.rejoin_after_s)
        # two admission attempts: the first resolve can race a concurrent
        # survivors' resolve and adopt a view without us; the join intent
        # still stands, so one more rides the survivors' next poll
        for attempt in range(2):
            self.membership.announce_join(note="rejoin after preemption")
            prev = self.membership.current_view()
            self._log(f"re-joining (current view {list(prev.members)}, "
                      f"attempt {attempt + 1})")
            # require= the survivors: a joiner never settles a world by
            # itself
            with observability.span("elastic/resolve",
                                    tags={"rejoin": True,
                                          "attempt": attempt + 1}):
                view = self.membership.resolve(
                    expect=set(prev.members) | {self.stable_rank},
                    require=set(prev.members) - {self.stable_rank},
                    timeout_ms=self.resolve_timeout_ms)
            if self.stable_rank in view:
                break
        if self.stable_rank not in view:
            raise RecoveryGivingUp(
                "re-join was not admitted", membership=view) from exc
        return self._adopt(trainer, view, prev_view=prev)

    def _resize(self, trainer, expect):
        """Survivor-side resolve, rebuild, converge (shrink and grow; the
        joiner enters at :meth:`_adopt` after its own resolve)."""
        prev = self.view
        with observability.span("elastic/resolve",
                                tags={"expect": sorted(expect)}):
            view = self.membership.resolve(
                expect=expect, timeout_ms=self.resolve_timeout_ms)
        if self.stable_rank not in view:
            # the split-brain escape: too slow, settled without us
            self._log(f"excluded from view {list(view.members)}")
            if self.rejoin_after_s is None:
                raise RecoveryGivingUp(
                    "excluded from the decided membership view",
                    membership=view)
            self.membership.announce_join(note="excluded, re-joining")
            with observability.span("elastic/resolve",
                                    tags={"rejoin": True}):
                view = self.membership.resolve(
                    expect=set(view.members) | {self.stable_rank},
                    require=set(view.members) - {self.stable_rank},
                    timeout_ms=self.resolve_timeout_ms)
            if self.stable_rank not in view:
                raise RecoveryGivingUp(
                    "re-join after exclusion was not admitted",
                    membership=view)
        if view.size < self.min_world:
            raise RecoveryGivingUp(
                f"world shrank below min_world={self.min_world}",
                membership=view)
        return self._adopt(trainer, view, prev_view=prev)

    def _adopt(self, trainer, view, prev_view):
        """Lock-step across ``view.members``: rebuild the communicator,
        re-plan all size-dependent state, sync the newest snapshot to
        joiners, and converge everyone on it."""
        lost = [r for r in prev_view.members if r not in view]
        joined = [r for r in view.members if r not in prev_view]
        self.last_view = view
        self.view = view
        old_size = self._world_size
        with observability.span("elastic/rebuild",
                                tags={"epoch": view.epoch,
                                      "members": list(view.members),
                                      "lost": lost, "joined": joined}):
            new_comm = (self.comm_factory(view) if self.comm_factory
                        is not None else self._default_factory(view))
            self._check_batch(trainer, new_comm, old_size)
            self._swap_communicator(trainer, new_comm)
        self.stats["ranks_lost"] += len(lost)
        self.stats["ranks_joined"] += len(joined)
        if view.size != prev_view.size:
            self.stats["resizes"] += 1
        self._publish_stats()
        self._log(f"world e{view.epoch}: members {list(view.members)} "
                  f"(lost {lost}, joined {joined}, size {prev_view.size}"
                  f"->{view.size})")
        resumed = None
        if self.checkpointer is not None:
            with observability.span("elastic/snapshot_sync",
                                    tags={"joined": joined}):
                if joined:
                    self._sync_snapshot_to_joiners(trainer, joined)
                resumed = self.checkpointer.maybe_load(trainer)
            _fit_iterator(trainer)
        elif joined:
            raise ElasticConfigError(
                "growing the world needs a checkpointer: the joiner's "
                "state must be adopted from the survivors' newest "
                "snapshot (pass checkpointer= to ElasticRecovery)")
        self.stats["resumed_iterations"].append(resumed)
        self._log(f"converged -> iteration "
                  f"{resumed if resumed is not None else '(live state)'}")
        if self.on_resize is not None:
            self.on_resize(trainer, view, resumed)
        return resumed

    # -- rebuild plumbing ----------------------------------------------------
    def _default_factory(self, view):
        """Members-only communicator with the boot communicator's
        exchange knobs.  A two-level boot split is kept when its ranks per
        node still divide the new world (a property of the hosts) and
        degrades to flat otherwise, the per-hop dtype then collapsing
        onto the one hop as under ``CHAINERMN_TPU_HIERARCHY=flat`` (the
        inter-node entry wins)."""
        old = self._boot_comm
        kwargs = dict(batch_collectives=getattr(old, "batch_collectives",
                                                True),
                      bucket_mb=getattr(old, "bucket_mb", None),
                      error_feedback=getattr(old, "error_feedback", True),
                      channel=self._boot_channel,
                      device=getattr(old, "device", None))
        grad_dtype = getattr(old, "allreduce_grad_dtype", None)
        name = getattr(old, "name", "jax_ici")
        if getattr(old, "hierarchy", None) is not None:
            intra = old.ici_size
            dcn_dtype = old.dcn_grad_dtype
            if view.size % intra == 0:
                kwargs["intra_size"] = intra
                kwargs["inter_size"] = view.size // intra
                kwargs["allreduce_grad_dtype"] = {
                    "ici": grad_dtype, "dcn": dcn_dtype}
                if getattr(old, "stripe_ratio", 0):
                    kwargs["stripe_ratio"] = old.stripe_ratio
            else:
                name = "jax_ici"
                kwargs["allreduce_grad_dtype"] = dcn_dtype or grad_dtype
        else:
            kwargs["allreduce_grad_dtype"] = grad_dtype
        if name in ("hierarchical", "two_dimensional") \
                and "intra_size" not in kwargs:
            name = "jax_ici"
        return ElasticMeshCommunicator(view.members, epoch=view.epoch,
                                       name=name, **kwargs)

    def _swap_communicator(self, trainer, new_comm):
        """Point every consumer of the communicator at the rebuilt one:
        the supervisor, the checkpointer, every multi-node optimizer
        (``change_communicator`` re-plans and re-seeds), the
        comm-holding iterators (the multi-node batch broadcaster), and the
        model (its gradients from the old world dropped)."""
        self.comm = new_comm
        self._world_size = new_comm.size
        if self.checkpointer is not None:
            self.checkpointer.comm = new_comm
        for it in (getattr(trainer.updater, "_iterators", None)
                   or {}).values():
            while it is not None:
                if hasattr(it, "comm"):
                    it.comm = new_comm
                it = getattr(it, "actual_iterator", None)
        for opt in trainer.updater.get_all_optimizers().values():
            if hasattr(opt, "change_communicator"):
                opt.change_communicator(
                    new_comm, via_checkpoint=self.checkpointer is not None)
            target = getattr(opt, "target", None)
            if target is not None:
                _rehome_model(target, new_comm)

    def _check_batch(self, trainer, new_comm, old_size=None):
        """Check the global-batch policy against the new world before the
        first resized step.  Over a scattered shard (a per-rank batch)
        the shard is re-sliced for the new world and the per-rank batch
        set so that the global batch stays; over the same data on every
        rank (the global batch) the plan is only validated.  A failure
        carries the plan."""
        try:
            it = trainer.updater.get_iterator("main")
        except Exception:
            return
        # reach through comm-holding broadcasters to the base iterator
        while not hasattr(it, "batch_size") \
                and getattr(it, "actual_iterator", None) is not None:
            it = it.actual_iterator
        batch = getattr(it, "batch_size", None)
        if not batch:
            return
        from ..dataset.datasets import SubDataset
        from ..datasets import rescatter_dataset
        ds = getattr(it, "dataset", None)
        scattered = isinstance(ds, SubDataset) and hasattr(it, "reset")
        old_size = self._world_size if old_size is None else old_size
        global_bs = batch * old_size if scattered else batch
        plan = global_batch_plan(global_bs, new_comm.size,
                                 policy=self.batch_policy,
                                 max_per_rank=self.max_per_rank_bs)
        if plan["accum_steps"] != 1:
            raise ElasticConfigError(
                f"global batch {global_bs} needs "
                f"{plan['accum_steps']}-step gradient accumulation at "
                f"world size {new_comm.size} "
                f"(dispatch_bs={plan['dispatch_bs']}); plain updaters "
                f"dispatch one batch per step: re-shard the iterator or "
                f"use an accumulation-aware updater", plan=plan)
        if scattered:
            # re-sliced at every world size: a shrink to one rank must
            # widen the survivor's shard to the whole order
            it.dataset = rescatter_dataset(ds, new_comm)
            it.batch_size = plan["per_rank_bs"]
            it.reset()

    # -- snapshot shipping (the grow convergence) ---------------------------
    def _sync_snapshot_to_joiners(self, trainer, joined):
        """Survivors snapshot their current state.  With the npz
        checkpointer the lowest survivor ships its file to the joiners
        over the new members' channel, and the joiners write it under
        their own stable-rank name (with its checksum sidecar); the
        consensus ``maybe_load`` right after then finds the fresh
        generation on every member.  The per-rank DCP checkpointer's
        joiners read the survivors' directories instead (a directory
        every rank can read), so nothing is shipped."""
        cp = self.checkpointer
        me_joined = self.stable_rank in joined
        iteration = None
        if not me_joined:
            iteration = trainer.updater.iteration
            cp.save(trainer, iteration)
        if not hasattr(cp, "_filename"):
            self.comm.bcast_obj(None, root=0)   # saves durable: a barrier
            return
        survivors = [r for r in self.view.members if r not in joined]
        root = self.view.slot(min(survivors))
        payload = None
        if self.stable_rank == min(survivors):
            out = cp._dir(trainer)
            with open(os.path.join(out, cp._filename(iteration)),
                      "rb") as f:
                payload = (iteration, f.read())
        iteration, data = self.comm.bcast_obj(payload, root=root)
        if me_joined:
            out = cp._dir(trainer)
            os.makedirs(out, exist_ok=True)
            fname = cp._filename(iteration)
            digest = hashlib.sha256(data).hexdigest()
            with open(os.path.join(out, fname + ".sum"), "w") as f:
                f.write(digest)  # sidecar before data, as save does
            with open(os.path.join(out, fname), "wb") as f:
                f.write(data)
            self._log(f"adopted snapshot generation {iteration} "
                      f"({len(data)} bytes)")
        # every member passed the bcast above: the files are durable
        # before the consensus vote


def _rehome_model(model, comm):
    """A model after a resize: its parameters stay where they are (every
    rank holds them whole on its own device); a gradient from the old
    world means nothing in the new one and is dropped (the next step
    computes it)."""
    for param in model.parameters():
        param.grad = None
    return model


def _fit_iterator(trainer):
    """After a consensus load across a resize: a scattered iterator
    whose restored order was made for another shard length starts its
    epoch again over the new shard (the epoch count kept)."""
    try:
        it = trainer.updater.get_iterator("main")
    except Exception:
        return
    while getattr(it, "actual_iterator", None) is not None \
            and not hasattr(it, "_order"):
        it = it.actual_iterator
    order = getattr(it, "_order", None)
    if order is not None and hasattr(it, "reset") \
            and len(order) != len(it.dataset):
        epoch = it.epoch
        it.reset()
        it.epoch = epoch
