"""Elastic serving fleet: autoscaling decode replicas behind a router.

The port of ``chainermn_tpu.serving.fleet`` (host code over whole
engines).  A **fleet** is a set of decode replicas, each a full
:class:`~.engine.ServingEngine` with its own model, registered in an
:class:`~chainermn_tpu_torch.communicators.ElasticMembership` group under
the serving role (``<ns>/fleet``, key-disjoint from the training
``<ns>/elastic`` group in the same store), fronted by a
:class:`~.router.FleetRouter`.  Three moves:

* **shed**: a replica preempt (:class:`RankPreempted`, or a typed
  :class:`~chainermn_tpu_torch.communicators.ChannelError` from a remote
  replica's dead worker) triggers detect, resolve (the membership
  consensus) and reroute: the dead replica's in-flight sequences replay
  on survivors from their prompts, the generated tokens folded in (the
  engine's eviction path one level up), so a kill under load drops no
  request and greedy decode gives every rerouted sequence its solo-run
  trajectory.
* **join**: a cold replica is admitted by the resolve, and its weights
  sync over a **multicast tree**
  (:func:`~chainermn_tpu_torch.communicators.multicast_tree_plan`): the
  lowest survivor roots a binomial broadcast over ``{root} ∪ joiners``,
  ``ceil(log2(N + 1))`` rounds for N joiners.  Transfers ride the host
  channel's chunked objects across processes, or direct copies of the
  serialized payload in one process; the joiner's weights are bitwise the
  root's either way.
* **scale**: :class:`QueueDepthScalePolicy` turns the per-tenant fleet
  queue-depth gauges of the metrics registry into +1/-1/0 decisions; the
  fleet surfaces them in ``step()``'s stats, and only ``join``/``retire``
  (or :class:`~chainermn_tpu_torch.elastic.CapacityBroker`) act on them.

The weight payload (:func:`serialize_state`): the JAX package pickles the
leaves of its engine's state pytree; the port's engine holds an
``nn.Module``, so the payload is its ``state_dict()`` in order, as host
numpy arrays with their names and dtypes (a dtype numpy lacks, bfloat16,
goes as its raw bits).  It holds no device: a root on the card feeds a
joiner on the CPU and the other way round.  A JAX engine's state is
immutable, so two JAX replicas may share one model; a port replica's
weights are written in place on adoption (:meth:`LocalReplica.adopt_state`
also refreshes the prefill device's copy of a disaggregated engine), so
every replica needs a module of its own.

A single-controller fleet hosts every replica in this process and its
consensus is local bookkeeping (:class:`_LocalConsensus`); a
multi-controller fleet binds one ``ElasticMembership(role="fleet")`` a
replica process and drives :class:`RemoteReplica` handles to
:class:`FleetWorker` loops.  ``CHAINERMN_TPU_FLEET=off`` clamps the fleet
to one replica and the router to a pass-through: single-engine serving.

Observability: spans ``fleet/route`` (router), ``fleet/shed`` (a loss or
a retire and its reroute), ``fleet/weight_sync`` (the tree sync); the
instant ``fleet/preempt_detect``; the counter
``chainermn_tpu_fleet_reroutes_total``; the gauges
``chainermn_tpu_fleet_replicas`` and
``chainermn_tpu_fleet_queue_depth{tenant}``.
"""

from __future__ import annotations

import os
import pickle
import time
from collections import OrderedDict

import numpy as np
import torch

from .. import observability
from ..communicators._host_channel import ChannelError
from ..communicators._membership import MembershipView, multicast_tree_plan
from ..communicators.fault_schedule import RankPreempted
from ..extensions.failure_recovery import RecoveryGivingUp
from .errors import PagePoolExhaustedError, QueueSaturatedError
from .router import FleetRouter
from .scheduler import Request

__all__ = ["ReplicaFleet", "LocalReplica", "RemoteReplica", "FleetWorker",
           "QueueDepthScalePolicy", "fleet_mode", "serialize_state",
           "deserialize_state", "FLEET_ENV", "FLEET_ROLE",
           "FLEET_CTRL_TAG", "FLEET_SYNC_TAG"]

FLEET_ENV = "CHAINERMN_TPU_FLEET"
FLEET_ROLE = "fleet"
#: host-channel tags of the fleet's control and weight-sync planes
FLEET_CTRL_TAG = 7001
FLEET_SYNC_TAG = 7002


def fleet_mode(enabled=None):
    """Resolve the fleet knob: ``CHAINERMN_TPU_FLEET=off`` is the
    single-engine hatch and wins over everything; otherwise the
    constructor's intent (default on).  Resolved once, at construction."""
    if os.environ.get(FLEET_ENV, "").lower() == "off":
        return False
    return True if enabled is None else bool(enabled)


# -- weight payloads ---------------------------------------------------------

def _state_dict(state):
    return state.state_dict() if isinstance(state, torch.nn.Module) \
        else state


def _host_array(t):
    """A tensor's bytes as a host numpy array: its values, or for a dtype
    numpy lacks (bfloat16, the float8 types) its raw bits as a signed
    integer of the same width."""
    t = t.detach().cpu().contiguous()
    try:
        return t.numpy()
    except TypeError:
        return t.view({1: torch.int8, 2: torch.int16}[
            t.element_size()]).numpy()


def serialize_state(state):
    """An engine's weights (its ``nn.Module``, or a state dict) -> bytes:
    ``(name, dtype, array)`` for each entry of ``state_dict()`` in order,
    host arrays, pickled.  Exact: every dtype round-trips bitwise."""
    leaves = [(name, str(t.dtype).replace("torch.", ""), _host_array(t))
              for name, t in _state_dict(state).items()]
    return pickle.dumps(leaves, protocol=pickle.HIGHEST_PROTOCOL)


def deserialize_state(like, payload):
    """Bytes -> an ``OrderedDict`` of host tensors shaped like ``like``
    (the joiner's own module or state dict supplies the names, shapes and
    dtypes; the payload every value).  Raises ``ValueError`` when the
    entry count, a name, a shape or a dtype differs."""
    ref = _state_dict(like)
    new = pickle.loads(payload)
    if len(new) != len(ref):
        raise ValueError(f"weight payload has {len(new)} leaves, "
                         f"engine state has {len(ref)}")
    out = OrderedDict()
    for (name, dtype, arr), (want, t) in zip(new, ref.items()):
        if (name, dtype, tuple(arr.shape)) \
                != (want, str(t.dtype).replace("torch.", ""),
                    tuple(t.shape)):
            raise ValueError(
                f"weight payload entry {name!r} {dtype} {tuple(arr.shape)} "
                f"does not match the engine's {want!r} {t.dtype} "
                f"{tuple(t.shape)}")
        got = torch.from_numpy(np.ascontiguousarray(arr))
        out[name] = got if got.dtype == t.dtype else got.view(t.dtype)
    return out


def adopt_payload(engine, payload):
    """Copy a weight payload into ``engine``'s model in place, and into
    every other copy the engine computes with (the prefill device's copy
    of a disaggregated engine).  The JAX ``adopt_state`` replaces the
    engine's ``state`` alone and leaves its prefill slice's weights as
    they were."""
    state = deserialize_state(engine.model, payload)
    with torch.no_grad():
        engine.model.load_state_dict(state)
        copy = getattr(engine, "_model_prefill", None)
        if copy is not None and copy is not engine.model:
            copy.load_state_dict(state)


# -- replica handles ---------------------------------------------------------

class LocalReplica:
    """A decode replica in this controller process: a thin handle over a
    :class:`~.engine.ServingEngine` giving the fleet its uniform surface
    (``submit``/``step``/``queue_depth``/``drain_for_reroute``/
    ``state_bytes``).  ``kill_at``: seeded preemption, the replica raises
    :class:`RankPreempted` once its engine reaches that decode step."""

    remote = False

    def __init__(self, rid, engine, kill_at=None):
        self.rid = int(rid)
        self.engine = engine
        self.live = True
        self.kill_at = kill_at
        self._completed_seen = 0

    def submit(self, request):
        self.engine.submit(request)

    def step(self, now=None):
        if self.kill_at is not None \
                and self.engine.decode_steps >= self.kill_at:
            raise RankPreempted("fleet.step", self.engine.decode_steps,
                                rank=self.rid,
                                note="seeded replica preemption")
        return self.engine.step(now=now)

    def queue_depth(self, tenant=None):
        return self.engine.scheduler.pending(tenant)

    def tenant_depths(self):
        return self.engine.scheduler.tenant_depths()

    def can_ever_hold(self, request):
        """Whether this replica's pool could ever serve the request (the
        engine's submit-time fit check, without submitting)."""
        total = int(request.prompt.size) + request.max_new_tokens
        return total <= self.engine.max_context \
            and self.engine.allocator.pages_for(total) \
            <= self.engine.allocator.num_pages

    def force_requeue(self, request):
        """Front-of-line enqueue past the queue bound, for rerouted
        in-flight work: backpressure is an ingress contract, and an
        admitted sequence must not drop because a survivor's queue is
        full (the engine's eviction requeue is bound-exempt too)."""
        self.engine.scheduler.requeue_front(request, preempted=False)

    def busy(self):
        return bool(self.engine.running
                    or getattr(self.engine, "prefilling", ())
                    or self.engine.scheduler.pending())

    def pop_completed(self):
        """Requests retired since the last poll."""
        new = self.engine.completed[self._completed_seen:]
        self._completed_seen = len(self.engine.completed)
        return list(new)

    def drain_for_reroute(self, now=None):
        """Every in-flight sequence of a dead replica, ready to replay:
        running ones free their pages and fold their tokens into the
        prompt (``requeue_front``), mid-chunk ones free their pages and
        reset their chunk cursor (no token to fold), and the queued ones
        follow in fairness order.  Nothing else of this engine travels
        with a request: its position, draft position and scratch flag are
        set again by the survivor's admission.  The requeue stamp (on the
        engine's clock: ``now`` when the caller drives one, else the
        monotonic clock) books the gap until re-admission as queue wait;
        never-admitted requests keep their arrival-based wait."""
        eng = self.engine
        sched = eng.scheduler
        t_requeue = now if now is not None else time.monotonic()
        for pool in (eng.running, getattr(eng, "prefilling", [])):
            for req in list(pool):
                eng.allocator.free(req.request_id)
                pool.remove(req)
                req.requeue_time = t_requeue
                sched.requeue_front(req)   # folds tokens, preemptions += 1
        reqs = []
        while True:
            req = sched.next_admission(arrived_by=None)
            if req is None:
                break
            reqs.append(req)
        return reqs

    def state_bytes(self):
        return serialize_state(self.engine.model)

    def adopt_state(self, payload):
        adopt_payload(self.engine, payload)


class RemoteReplica:
    """Router-side handle to a replica that another controller process's
    :class:`FleetWorker` serves, over the host channel's chunked objects.
    Each ``step()`` is one pump round trip; a dead worker surfaces as the
    channel's typed timeout.  The handle keeps the original request
    objects it shipped (``outstanding``): after a preempt they replay from
    their prompts on a survivor."""

    remote = True

    def __init__(self, rid, channel, process):
        self.rid = int(rid)
        self.channel = channel
        self.process = int(process)
        self.live = True
        self.kill_at = None
        self.outstanding = {}       # request_id -> original Request
        self.completed = []         # Requests finished remotely
        self._depths = {}           # tenant -> last reported depth

    def submit(self, request):
        self.channel.send_obj(
            ("admit", {"prompt": np.asarray(request.prompt,
                                            dtype=np.int32),
                       "max_new_tokens": request.max_new_tokens,
                       "tenant": request.tenant,
                       "request_id": request.request_id,
                       "arrival_time": request.arrival_time}),
            self.process, tag=FLEET_CTRL_TAG)
        kind, *rest = self.channel.recv_obj(self.process,
                                            tag=FLEET_CTRL_TAG)
        if kind == "saturated":
            raise QueueSaturatedError(*rest)
        if kind == "oom":
            raise PagePoolExhaustedError(*rest)
        assert kind == "ok", kind
        self.outstanding[request.request_id] = request

    def step(self, now=None):
        """One remote decode pump; the channel's typed errors when the
        worker is gone (the fleet's shed path catches them)."""
        self.channel.send_obj(("pump",), self.process, tag=FLEET_CTRL_TAG)
        kind, report = self.channel.recv_obj(self.process,
                                             tag=FLEET_CTRL_TAG)
        assert kind == "pumped", kind
        t = time.monotonic() if now is None else now
        for req_id, toks, times in report["finished"]:
            req = self.outstanding.pop(req_id, None)
            if req is None:
                continue
            req.tokens = list(toks)
            req.token_times = list(times) if times else [t] * len(toks)
            if req.token_times:
                req.first_token_time = req.token_times[0]
            req.finish_time = t
            self.completed.append(req)
        self._depths = dict(report.get("depths", {}))
        return {"admitted": 0, "evicted": report.get("evicted", 0),
                "running": report.get("running", 0),
                "decoded": report.get("decoded", 0),
                "occupancy": report.get("occupancy", 0.0),
                "capacity_x": report.get("capacity_x", 1.0)}

    def stop(self):
        """Graceful worker shutdown (its work drained)."""
        try:
            self.channel.send_obj(("stop",), self.process,
                                  tag=FLEET_CTRL_TAG)
            self.channel.recv_obj(self.process, tag=FLEET_CTRL_TAG)
        except ChannelError:
            pass

    def queue_depth(self, tenant=None):
        if tenant is not None:
            return self._depths.get(tenant, 0)
        return sum(self._depths.values())

    def tenant_depths(self):
        return dict(self._depths)

    def can_ever_hold(self, request):
        return True   # the remote submit's typed fit check decides

    def force_requeue(self, request):
        # no bound-exempt remote enqueue: the worker's typed submit is the
        # only ingress, and a refusal falls to the next candidate
        self.submit(request)

    def busy(self):
        return bool(self.outstanding)

    def pop_completed(self):
        done, self.completed = self.completed, []
        return done

    def drain_for_reroute(self, now=None):
        """The replay set of a dead remote replica: everything shipped and
        never reported finished, from the original prompts (the remote
        copies died with the worker)."""
        reqs = list(self.outstanding.values())
        self.outstanding = {}
        t_requeue = now if now is not None else time.monotonic()
        for req in reqs:
            req.preemptions += 1
            req.requeue_time = t_requeue
        return reqs

    def state_bytes(self):
        raise NotImplementedError(
            "remote replicas ship weights worker to worker along the tree "
            "plan; the router transfers only on pairs it is an endpoint of")

    def adopt_state(self, payload):
        self.channel.send_obj(payload, self.process, tag=FLEET_SYNC_TAG)


class FleetWorker:
    """Replica-side serve loop of a multi-controller fleet: one engine in
    one process, driven by the router's control messages over the host
    channel (strict request and reply, so a wedge is a typed timeout on
    the router's side, never a hang).  On a preemption (``kill_at``
    reached) the worker announces its leave in the fleet group and stops
    replying: the router's next pump times out typed within the channel's
    deadline."""

    def __init__(self, engine, channel, membership=None, router_process=0):
        self.engine = engine
        self.channel = channel
        self.membership = membership
        self.router_process = int(router_process)
        self._reported = 0

    def _report(self):
        done = self.engine.completed[self._reported:]
        self._reported = len(self.engine.completed)
        return {"finished": [(r.request_id, list(r.tokens),
                              list(r.token_times)) for r in done],
                "depths": self.engine.scheduler.tenant_depths(),
                "running": len(self.engine.running)}

    def _reply(self, msg):
        self.channel.send_obj(msg, self.router_process, tag=FLEET_CTRL_TAG)

    def serve(self, kill_at=None, now=None):
        """The message loop; returns ``"preempted"`` or ``"stopped"``."""
        while True:
            msg = self.channel.recv_obj(self.router_process,
                                        tag=FLEET_CTRL_TAG)
            kind = msg[0]
            if kind == "admit":
                spec = msg[1]
                try:
                    self.engine.submit(Request(
                        spec["prompt"], spec["max_new_tokens"],
                        tenant=spec["tenant"],
                        arrival_time=spec["arrival_time"],
                        request_id=spec["request_id"]))
                except QueueSaturatedError as e:
                    self._reply(("saturated", e.tenant, e.depth, e.bound))
                    continue
                except PagePoolExhaustedError as e:
                    self._reply(("oom", e.requested, e.free, e.total))
                    continue
                self._reply(("ok",))
            elif kind == "pump":
                if kill_at is not None \
                        and self.engine.decode_steps >= kill_at:
                    # announce the leave (survivors skip the settle
                    # timeout) and go silent
                    if self.membership is not None:
                        self.membership.announce_leave(
                            note="replica preempted")
                    return "preempted"
                st = self.engine.step(now=now)
                report = self._report()
                report.update(decoded=st["decoded"], evicted=st["evicted"],
                              occupancy=st["occupancy"],
                              capacity_x=st["capacity_x"])
                self._reply(("pumped", report))
            elif kind == "stop":
                self._reply(("stopped", self._report()))
                return "stopped"
            else:
                raise ValueError(f"unknown fleet control message {kind!r}")

    def sync_weights(self, view, joiners, root=None):
        """Walk the view's multicast tree plan from this worker's seat:
        receive the payload where this rank is a ``dst``, relay it where a
        later round names it a ``src``, and adopt it as a joiner (the
        counterpart of :meth:`ReplicaFleet._sync_weights`).  Returns the
        plan's rounds."""
        me = self.membership.rank
        survivors = [m for m in view.members if m not in joiners]
        root = min(survivors) if root is None else root
        plan = multicast_tree_plan((root, *joiners), root=root)
        payload = None
        if me == root:
            payload = serialize_state(self.engine.model)
        for rnd in plan:
            for src, dst in rnd:
                if me == dst:
                    payload = self.channel.recv_obj(src, tag=FLEET_SYNC_TAG)
                elif me == src:
                    self.channel.send_obj(payload, dst, tag=FLEET_SYNC_TAG)
        if me in joiners and payload is not None:
            adopt_payload(self.engine, payload)
        return len(plan)


# -- consensus (single-controller form) --------------------------------------

class _LocalConsensus:
    """The membership surface of a single-controller fleet: every replica
    lives in this process, so the consensus is epoch bookkeeping with the
    view and role surface of the real protocol."""

    role = FLEET_ROLE

    def __init__(self):
        self._epoch = 0
        self._members = ()

    def resolve(self, expect=None, require=None, timeout_ms=None):
        self._epoch += 1
        self._members = tuple(sorted(expect or ()))
        return MembershipView(self._epoch, self._members, role=FLEET_ROLE)

    def current_epoch(self):
        return self._epoch

    def current_view(self):
        return MembershipView(self._epoch, self._members, role=FLEET_ROLE)

    def pending_joins(self, view=None):
        return ()

    def announce_leave(self, note="", rank=None):
        pass

    def announce_join(self, note="", rank=None):
        pass


# -- scale policy ------------------------------------------------------------

class QueueDepthScalePolicy:
    """Scale decisions from the metrics registry: reads the per-tenant
    ``chainermn_tpu_fleet_queue_depth`` gauges the fleet publishes every
    step and returns ``+1`` (a tenant's backlog above ``scale_up_depth``
    and room below ``max_replicas``), ``-1`` (every tenant at or below
    ``scale_down_depth`` and more than ``min_replicas`` live) or ``0``.

    Hysteresis: one sustained excursion past a water mark gives one
    decision.  After emitting in a direction, that direction is disarmed
    until the gauge returns past its own mark and, when the caller passes
    ``now``, until that direction's cooldown has elapsed."""

    GAUGE = "chainermn_tpu_fleet_queue_depth"

    def __init__(self, scale_up_depth=8, scale_down_depth=0,
                 min_replicas=1, max_replicas=8, up_cooldown_s=0.0,
                 down_cooldown_s=0.0):
        self.scale_up_depth = float(scale_up_depth)
        self.scale_down_depth = float(scale_down_depth)
        if self.scale_down_depth > self.scale_up_depth:
            raise ValueError(
                f"scale_down_depth ({self.scale_down_depth}) must not "
                f"exceed scale_up_depth ({self.scale_up_depth})")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_cooldown_s = float(up_cooldown_s)
        self.down_cooldown_s = float(down_cooldown_s)
        self._armed = {1: True, -1: True}
        self._last_emit = {1: None, -1: None}

    def decide(self, registry, n_live, now=None):
        gauge = registry.gauge(self.GAUGE)
        depths = [gauge.value(**dict(key)) for key in gauge.labels()]
        depths = [d for d in depths if d is not None]
        if not depths:
            return 0
        peak = max(depths)
        # a direction re-arms once the gauge is back past its own mark
        if peak <= self.scale_up_depth:
            self._armed[1] = True
        if peak > self.scale_down_depth:
            self._armed[-1] = True
        if peak > self.scale_up_depth and n_live < self.max_replicas:
            want = 1
        elif peak <= self.scale_down_depth and n_live > self.min_replicas:
            want = -1
        else:
            return 0
        if not self._armed[want]:
            return 0    # the same excursion: already answered
        cooldown = self.up_cooldown_s if want == 1 else self.down_cooldown_s
        last = self._last_emit[want]
        if now is not None and last is not None and now - last < cooldown:
            return 0
        self._armed[want] = False
        if now is not None:
            self._last_emit[want] = now
        return want


# -- the fleet ---------------------------------------------------------------

class ReplicaFleet:
    """The replica set and its supervisor (see the module docstring).

    ``engine_factory``: ``factory(rid) -> ServingEngine``, for the initial
    replicas and any joiner the caller hands no engine (one model a
    replica: adoption writes in place).  ``replicas``: the initial count
    (1 under ``CHAINERMN_TPU_FLEET=off``).  ``engines``: ``{rid: engine or
    replica handle}`` instead of the factory.  ``membership``: the fleet
    role group's protocol object (default :class:`_LocalConsensus`).
    ``min_replicas``: the shed floor; falling below it raises
    :class:`RecoveryGivingUp` carrying the fleet-role view.
    ``scale_policy``: a :class:`QueueDepthScalePolicy` whose decision
    rides ``step()``'s stats."""

    def __init__(self, engine_factory=None, replicas=2, engines=None,
                 membership=None, min_replicas=1, scale_policy=None,
                 enabled=None, clock=time.monotonic):
        self.enabled = fleet_mode(enabled)
        self.engine_factory = engine_factory
        self.membership = membership if membership is not None \
            else _LocalConsensus()
        self.min_replicas = int(min_replicas)
        self.scale_policy = scale_policy
        self._clock = clock
        self.replicas = {}
        if engines:
            for rid, eng in engines.items():
                self.replicas[int(rid)] = _handle(rid, eng)
        else:
            n = int(replicas) if self.enabled else 1
            if engine_factory is None:
                raise ValueError("ReplicaFleet needs engine_factory= or "
                                 "engines=")
            for rid in range(n):
                self.replicas[rid] = LocalReplica(rid, engine_factory(rid))
        if not self.replicas:
            raise ValueError("a fleet needs at least one replica")
        # boot: adopt the membership's view when it covers the replica set
        # (the real protocol's bootstrap view); resolve otherwise
        rids = [r.rid for r in self.replicas.values()]
        boot = self.membership.current_view() \
            if hasattr(self.membership, "current_view") else None
        if boot is not None and set(rids) <= set(boot.members):
            self.view = boot
        else:
            self.view = self._resolve(rids)
        self.completed = []
        self.steps = 0
        self.sheds = 0
        self.reroutes = 0
        self.joins = 0
        self.weight_syncs = 0
        self.weight_sync_s = 0.0
        self.weight_sync_rounds = 0
        self.weight_sync_bytes = 0
        self.last_detection_s = None
        self.router = FleetRouter(self)
        self._publish_gauges()

    # -- membership ----------------------------------------------------------

    def live_replicas(self):
        return [self.replicas[rid] for rid in sorted(self.replicas)
                if self.replicas[rid].live]

    def _resolve(self, members, require=None):
        return self.membership.resolve(expect=set(members), require=require)

    def _fleet_view(self, members):
        """A fleet-role view for a give-up when no resolve can run."""
        return MembershipView(self.membership.current_epoch() + 1, members,
                              role=FLEET_ROLE)

    # -- ingress and the step loop -------------------------------------------

    def submit(self, request):
        """Route one request (typed backpressure surfaces unchanged)."""
        return self.router.route(request)

    def step(self, now=None):
        """One fleet step: every live replica takes one decode step; a
        replica's typed failure sheds it (detect, resolve, reroute)
        without dropping a request.  Returns aggregated stats."""
        stats = {"admitted": 0, "decoded": 0, "running": 0, "evicted": 0,
                 "rerouted": 0}
        occ, cap = [], []
        for replica in self.live_replicas():
            try:
                st = replica.step(now=now)
            except (RankPreempted, ChannelError) as exc:
                stats["rerouted"] += self._shed(replica, exc, now=now)
                continue
            for k in ("admitted", "decoded", "running", "evicted"):
                stats[k] += st.get(k, 0)
            occ.append(st.get("occupancy", 0.0))
            cap.append(st.get("capacity_x", 1.0))
            for req in replica.pop_completed():
                self.router.ledger.pop(req.request_id, None)
                self.completed.append(req)
        stats["occupancy"] = float(np.mean(occ)) if occ else 0.0
        stats["capacity_x"] = float(np.mean(cap)) if cap else 1.0
        stats["replicas"] = len(self.live_replicas())
        self.steps += 1
        self._publish_gauges()
        if self.scale_policy is not None:
            stats["scale_decision"] = self.scale_policy.decide(
                observability.registry(), stats["replicas"], now=now)
        return stats

    def pending(self):
        """Live replicas still holding queued or running work."""
        return sum(1 for r in self.live_replicas() if r.busy())

    def drain(self, max_steps=10000, now=None):
        steps = 0
        while self.pending() and steps < max_steps:
            self.step(now=now)
            steps += 1
        return steps

    # -- shed (replica loss) -------------------------------------------------

    def _shed(self, replica, exc, now=None):
        """Detect, resolve, reroute.  Returns the reroute count."""
        t_detect = self._clock()
        observability.instant("fleet/preempt_detect",
                              tags={"replica": replica.rid,
                                    "exc": type(exc).__name__})
        with observability.span("fleet/shed",
                                tags={"replica": replica.rid,
                                      "exc": type(exc).__name__}):
            replica.live = False
            survivors = [r.rid for r in self.live_replicas()]
            if len(survivors) < self.min_replicas:
                raise RecoveryGivingUp(
                    f"fleet shrank below min_replicas={self.min_replicas}",
                    membership=self._fleet_view(survivors)) from exc
            self.view = self._resolve(survivors)
            reqs = replica.drain_for_reroute(now=now)
            self._reroute(reqs, exclude=(replica.rid,))
            self.sheds += 1
            self.reroutes += len(reqs)
            self.last_detection_s = self._clock() - t_detect
            observability.registry().counter(
                "chainermn_tpu_fleet_reroutes_total",
                help="in-flight sequences replayed onto survivors after a "
                     "replica loss").inc(len(reqs))
        self._publish_gauges()
        return len(reqs)

    def _reroute(self, reqs, exclude):
        """Replay ``reqs`` on survivors with no drop: a router refusal
        (saturation, the fit check) forces the request front-of-line onto
        the least-loaded survivor whose pool could ever hold it.  Only a
        request no survivor could ever serve raises, after every other
        request has been placed."""
        unserveable = None
        for req in reqs:
            try:
                self.router.route(req, exclude=exclude, reroute=True)
                continue
            except (QueueSaturatedError, PagePoolExhaustedError) as exc:
                candidates = sorted(
                    (r for r in self.live_replicas()
                     if r.rid not in exclude and r.can_ever_hold(req)),
                    key=lambda r: (r.queue_depth(), r.rid))
                for target in candidates:
                    try:
                        target.force_requeue(req)
                    except (QueueSaturatedError, PagePoolExhaustedError,
                            ChannelError):
                        continue
                    self.router.ledger[req.request_id] = target.rid
                    self.router.routed += 1
                    self.router.rerouted += 1
                    self.router.by_replica[target.rid] = \
                        self.router.by_replica.get(target.rid, 0) + 1
                    break
                else:
                    unserveable = unserveable or exc
        if unserveable is not None:
            raise unserveable

    def discard(self, rid):
        """Remove a replica that never went live (what a capacity
        conversion that died mid-``join`` leaves behind; it was never
        routed to).  A live replica goes through :meth:`preempt` or
        :meth:`retire`, so that its work reroutes."""
        replica = self.replicas.get(rid)
        if replica is None:
            return False
        if replica.live:
            raise ValueError(f"replica {rid} is live; use preempt() or "
                             f"retire(), not discard()")
        del self.replicas[rid]
        self._publish_gauges()
        return True

    def preempt(self, rid, exc=None, now=None):
        """Shed replica ``rid`` now (the deployer's reclaim signal).
        ``now`` stamps the requeues on a caller-driven clock."""
        return self._shed(self.replicas[rid], exc or RankPreempted(
            "fleet.preempt", self.steps, rank=rid,
            note="capacity reclaimed"), now=now)

    # -- join (scale-up over the multicast tree) -----------------------------

    def join(self, engines=None, count=1, warmup=False):
        """Admit cold replicas: resolve the grown view (``require=`` the
        survivors, so a joiner never settles a world alone), then sync the
        root's weights over the multicast tree.  ``warmup``: run each
        local joiner's :meth:`~.engine.ServingEngine.warmup` once it is
        live.  Returns the new replica ids."""
        if not self.enabled:
            raise RecoveryGivingUp(
                "fleet is disabled (CHAINERMN_TPU_FLEET=off): a "
                "single-engine deployment cannot grow",
                membership=self.view)
        if engines is None:
            if self.engine_factory is None:
                raise ValueError("join() needs engines= or a fleet "
                                 "engine_factory")
            next_rid = max(self.replicas) + 1
            engines = {next_rid + i: self.engine_factory(next_rid + i)
                       for i in range(count)}
        elif not isinstance(engines, dict):
            engines = {max(self.replicas) + 1: engines}
        joiners = {int(rid): _handle(rid, eng)
                   for rid, eng in engines.items()}
        survivors = [r.rid for r in self.live_replicas()]
        for rid, replica in joiners.items():
            replica.live = False       # live once its weights landed
            self.replicas[rid] = replica
        self.view = self._resolve(set(survivors) | set(joiners),
                                  require=set(survivors))
        self._sync_weights(sorted(joiners), survivors)
        for rid in joiners:
            self.replicas[rid].live = True
            if warmup and not self.replicas[rid].remote:
                self.replicas[rid].engine.warmup()
        self.joins += len(joiners)
        self._publish_gauges()
        return sorted(joiners)

    def _sync_weights(self, joiners, survivors):
        """Tree-sync the root's weights to every joiner, over ``{root} ∪
        joiners`` only (survivors hold the weights already).  Per pair:
        local to local copies the payload bytes; local to remote ships
        them over the host channel (the worker walks
        :meth:`FleetWorker.sync_weights`); remote to remote is between the
        workers alone."""
        if not joiners:
            return
        root = min(survivors)
        plan = multicast_tree_plan((root, *joiners), root=root)
        t0 = self._clock()
        with observability.span("fleet/weight_sync",
                                tags={"root": root, "joiners": list(joiners),
                                      "rounds": len(plan)}):
            payloads = {}   # rid -> bytes held in this process
            for rnd in plan:
                for src, dst in rnd:
                    src_rep = self.replicas.get(src)
                    dst_rep = self.replicas.get(dst)
                    if src_rep is None or dst_rep is None:
                        continue
                    if src_rep.remote and dst_rep.remote:
                        continue
                    if src_rep.remote:
                        payload = src_rep.channel.recv_obj(
                            src_rep.process, tag=FLEET_SYNC_TAG)
                    else:
                        if src not in payloads:
                            payloads[src] = src_rep.state_bytes()
                        payload = payloads[src]
                    dst_rep.adopt_state(payload)
                    payloads[dst] = payload
                    self.weight_sync_bytes += len(payload)
            self.weight_sync_rounds += len(plan)
            self.weight_syncs += 1
        self.weight_sync_s += self._clock() - t0

    # -- scale-down ----------------------------------------------------------

    def retire(self, rid, now=None):
        """Graceful scale-down: the replica leaves after its in-flight work
        rerouted (the announced-leave fast path: no detection timeout).
        Returns the reroute count."""
        replica = self.replicas[rid]
        survivors = [r.rid for r in self.live_replicas() if r.rid != rid]
        if len(survivors) < self.min_replicas:
            raise RecoveryGivingUp(
                f"retiring replica {rid} would shrink the fleet below "
                f"min_replicas={self.min_replicas}",
                membership=self._fleet_view(survivors))
        with observability.span("fleet/shed",
                                tags={"replica": rid, "retire": True}):
            replica.live = False
            # the leave is the retiring replica's, not the router's
            self.membership.announce_leave(note=f"retire {rid}", rank=rid)
            self.view = self._resolve(survivors)
            reqs = replica.drain_for_reroute(now=now)
            self._reroute(reqs, exclude=(rid,))
            self.reroutes += len(reqs)
            if replica.remote:
                replica.stop()
        self._publish_gauges()
        return len(reqs)

    # -- observability -------------------------------------------------------

    def _publish_gauges(self):
        """The per-tenant fleet-wide queue depth the scale policy reads and
        the live replica count, published whether tracing is on or not."""
        reg = observability.registry()
        depth = reg.gauge(
            "chainermn_tpu_fleet_queue_depth",
            help="pending requests per tenant, summed over live replicas")
        totals = {}
        for replica in self.live_replicas():
            for tenant, d in replica.tenant_depths().items():
                totals[tenant] = totals.get(tenant, 0) + d
        for tenant, d in totals.items():
            depth.set(d, tenant=tenant)
        reg.gauge("chainermn_tpu_fleet_replicas",
                  help="live decode replicas").set(len(self.live_replicas()))

    def stats(self):
        return {"replicas": len(self.live_replicas()),
                "sheds": self.sheds, "reroutes": self.reroutes,
                "joins": self.joins, "weight_syncs": self.weight_syncs,
                "weight_sync_rounds": self.weight_sync_rounds,
                "weight_sync_bytes": self.weight_sync_bytes,
                "weight_sync_s": self.weight_sync_s,
                "last_detection_s": self.last_detection_s,
                "routed": self.router.routed,
                "rerouted": self.router.rerouted,
                "spills": self.router.spills}

    def __repr__(self):
        return (f"<ReplicaFleet replicas={sorted(self.replicas)} "
                f"live={[r.rid for r in self.live_replicas()]} "
                f"epoch={self.view.epoch}>")


def _handle(rid, engine):
    """A replica handle as given, or a :class:`LocalReplica` over an
    engine."""
    if isinstance(engine, (LocalReplica, RemoteReplica)):
        return engine
    return LocalReplica(rid, engine)
