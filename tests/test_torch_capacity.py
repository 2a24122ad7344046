"""The port's capacity broker against the JAX package's (twins of
``tests/resilience_tests/test_capacity.py``), single process, on the CPU.

The conversion journal over the port's ``ElasticMembership`` (a training
and a fleet member on one KV read the same entries), the convert/retire
round trip with the joiner's weights bitwise the root's, both role floors,
the state machine's legal transitions, ``apply`` with cooldowns and the
surfaced-only mode, and the crash-recovery matrix: a seeded kill at each
of the five steps, the orphan typed and rolled forward or aborted with no
trace left in either role group.  The round trip, ``apply`` and every
matrix case also run on the JAX broker over the JAX fleet, and the two
give the same actions, stats and views.

The fakes: an engine with the ``LocalReplica`` surface and no model
computation, whose weights are a one-parameter module, so the fleet's
payload and adoption run for real.
"""

import numpy as np
import pytest
import torch

import chainermn_tpu.observability as jax_obs
from chainermn_tpu_torch import observability
from chainermn_tpu_torch.communicators._membership import ElasticMembership
from chainermn_tpu_torch.communicators.fault_schedule import (FaultSchedule,
                                                              RankPreempted)
from chainermn_tpu_torch.elastic import (CONVERSION_STEPS, CapacityBroker,
                                         CapacityFloorError,
                                         CapacityProtocolError,
                                         LocalTrainGroup)
from chainermn_tpu_torch.serving.fleet import LocalReplica, ReplicaFleet
from tests.resilience_tests.test_capacity import KV


@pytest.fixture(autouse=True)
def _fresh_registry():
    observability.reset_registry()
    jax_obs.reset_registry()
    yield
    observability.reset_registry()
    jax_obs.reset_registry()


def _member(kv, rank, role="elastic", world=2, **kw):
    kw.setdefault("settle_s", 0.05)
    kw.setdefault("poll_s", 0.002)
    kw.setdefault("timeout_ms", 4000)
    return ElasticMembership(kv, rank=rank, world=world, role=role, **kw)


class _Scheduler:
    def __init__(self):
        self.q = []

    def pending(self, tenant=None):
        return len(self.q)

    def tenant_depths(self):
        out = {}
        for r in self.q:
            out[r.tenant] = out.get(r.tenant, 0) + 1
        return out

    def requeue_front(self, request, preempted=True):
        self.q.insert(0, request)

    def next_admission(self, arrived_by=None):
        return self.q.pop(0) if self.q else None


class _Allocator:
    num_pages = 8

    def pages_for(self, total):
        return 1

    def free(self, request_id):
        pass


class _Weights(torch.nn.Module):
    def __init__(self, seed):
        super().__init__()
        rng = np.random.RandomState(seed)
        self.w = torch.nn.Parameter(torch.from_numpy(
            rng.rand(4).astype(np.float32)))


class FakeEngine:
    """The ``LocalReplica`` surface with no model computation; the
    weights (the JAX fake's ``state["w"]``) are a module, so the payload
    and the adoption run for real."""

    def __init__(self, seed=0):
        self.model = _Weights(seed)
        self.decode_steps = 0
        self.running = []
        self.completed = []
        self.max_context = 64
        self.scheduler = _Scheduler()
        self.allocator = _Allocator()

    def submit(self, request):
        self.scheduler.q.append(request)

    def step(self, now=None):
        self.decode_steps += 1
        return {"admitted": 0, "decoded": 0, "running": 0, "evicted": 0,
                "occupancy": 0.0, "capacity_x": 1.0}


def _weights(fleet, rid):
    eng = fleet.replicas[rid].engine
    if isinstance(getattr(eng, "model", None), torch.nn.Module):
        return eng.model.w.detach().numpy().copy()
    return np.asarray(eng.state["w"])


def _world(world=3, schedule=None, min_world=1, package="port", **kw):
    """One broker over a 3-rank training group and a 1-replica fleet, on
    a synthetic clock (``t[0]``), in the port or in the JAX package."""
    if package == "port":
        group, fleet_cls, broker_cls, fake = (
            LocalTrainGroup, ReplicaFleet, CapacityBroker, FakeEngine)
    else:
        from chainermn_tpu.elastic import CapacityBroker as JaxBroker
        from chainermn_tpu.elastic import LocalTrainGroup as JaxGroup
        from chainermn_tpu.serving.fleet import ReplicaFleet as JaxFleet
        from tests.resilience_tests.test_capacity import \
            FakeEngine as JaxFake
        group, fleet_cls, broker_cls, fake = (JaxGroup, JaxFleet,
                                              JaxBroker, JaxFake)
    t = [0.0]
    train = group(world=world)
    fleet = fleet_cls(engine_factory=lambda rid: fake(seed=0), replicas=1,
                      clock=lambda: t[0])
    broker = broker_cls(train, fleet,
                        engine_factory=lambda r: fake(seed=100 + r),
                        min_world=min_world, stale_s=0.5, schedule=schedule,
                        clock=lambda: t[0], **kw)
    return train, fleet, broker, t


def _snapshot(train, fleet, broker):
    """What the two packages' runs must agree on."""
    return {"training": train.current_view().members,
            "fleet": [r.rid for r in fleet.live_replicas()],
            "replicas": sorted(fleet.replicas),
            "journal": train.scan_conversions(),
            "converted": dict(broker.converted),
            "stats": {k: v for k, v in broker.stats.items()
                      if k != "convert_s"}}


# -- journal over the membership protocol -------------------------------------

def test_journal_round_trip_and_role_shared_visibility():
    kv = KV()
    train = _member(kv, 0, role="elastic")
    fleet = _member(kv, 0, role="fleet")
    assert train.read_conversion(1) is None
    train.journal_conversion("LEAVE_ANNOUNCED", note="queue pressure",
                             rank=1)
    assert train.read_conversion(1) == ("LEAVE_ANNOUNCED", 1,
                                        "queue pressure")
    assert fleet.read_conversion(1) == ("LEAVE_ANNOUNCED", 1,
                                        "queue pressure")
    train.journal_conversion("CONVERTING", rank=1)
    assert fleet.read_conversion(1) == ("CONVERTING", 2, "")
    assert fleet.scan_conversions() == {1: ("CONVERTING", 2, "")}
    train.announce_leave(note="x")
    assert fleet.scan_conversions() == {1: ("CONVERTING", 2, "")}
    fleet.clear_conversion(1)
    assert train.read_conversion(1) is None
    assert train.scan_conversions() == {}


def test_retract_join_scrubs_intent_without_leave():
    kv = KV()
    m0, m1 = _member(kv, 0), _member(kv, 1)
    m1.announce_join(note="wants in")
    assert m0.pending_joins() == ()
    m1.announce_leave(note="gone")
    v = m0.resolve(expect={0})
    assert v.members == (0,)
    m1.announce_join(note="back")
    assert m0.pending_joins(v) == (1,)
    m0.retract_join(rank=1)
    assert m0.pending_joins(v) == ()


# -- the round trip -----------------------------------------------------------

def _round_trip(package):
    train, fleet, broker, t = _world(package=package)
    obs = observability if package == "port" else jax_obs
    gauge = obs.registry().gauge("chainermn_tpu_role_world_size")
    seen = [(gauge.value(role="elastic"), gauge.value(role="fleet"))]
    rank = broker.convert_to_serving(now=0.0)
    rid = broker.converted[rank]
    bitwise = _weights(fleet, rid).tobytes() == _weights(fleet, 0).tobytes()
    differs = _weights(fleet, rid).tobytes() != np.random.RandomState(
        100 + rank).rand(4).astype(np.float32).tobytes()
    mid = _snapshot(train, fleet, broker)
    seen.append((gauge.value(role="elastic"), gauge.value(role="fleet")))
    back = broker.retire_to_training(now=1.0)
    seen.append((gauge.value(role="elastic"), gauge.value(role="fleet")))
    return {"rank": rank, "rid": rid, "bitwise": bitwise,
            "overwritten": differs, "mid": mid, "back": back,
            "end": _snapshot(train, fleet, broker), "gauges": seen,
            "sync": (fleet.weight_sync_rounds, fleet.weight_sync_bytes > 0)}


def test_convert_retire_round_trip():
    """Training to fleet to training: the donor leaves training, serves
    with the root's weights bitwise, retires and rejoins; the journal is
    scrubbed and the role gauges follow.  The JAX broker does the same."""
    got = _round_trip("port")
    assert got == _round_trip("jax")
    assert got["rank"] == 2 and got["rid"] == 2 and got["back"] == 2
    assert got["bitwise"] and got["overwritten"] and got["sync"] == (1, True)
    mid = got["mid"]
    assert mid["training"] == (0, 1) and mid["fleet"] == [0, 2]
    assert mid["journal"][2][0] == "SERVING"
    end = got["end"]
    assert end["training"] == (0, 1, 2) and end["fleet"] == [0]
    assert end["journal"] == {} and end["converted"] == {}
    assert got["gauges"] == [(3, 1), (2, 2), (3, 1)]
    assert (end["stats"]["conversions"], end["stats"]["retires"],
            end["stats"]["role_transfers"]) == (1, 1, 2)


def test_floors_refuse_typed_with_both_views():
    train, fleet, broker, t = _world(world=2, min_world=2)
    with pytest.raises(CapacityFloorError) as ei:
        broker.convert_to_serving()
    assert ei.value.training_view.members == (0, 1)
    assert ei.value.fleet_view.role == "fleet"
    assert "training=[0, 1]" in str(ei.value) and "fleet=[0]" in str(ei.value)
    assert broker.stats["floor_refusals"] == 1

    train2, fleet2, broker2, _ = _world(world=3, min_world=1)
    rank = broker2.convert_to_serving(now=0.0)
    fleet2.preempt(0)
    with pytest.raises(CapacityFloorError) as ei:
        broker2.retire_to_training(rank, now=1.0)
    assert ei.value.fleet_view is not None
    assert rank not in train2.current_view()
    assert train2.read_conversion(rank)[0] == "SERVING"
    assert broker2.converted[rank] in {r.rid for r in fleet2.live_replicas()}


def test_state_machine_rejects_illegal_transitions():
    train, fleet, broker, t = _world()
    with pytest.raises(CapacityProtocolError):
        broker._journal(2, "CONVERTING")
    broker._journal(2, "LEAVE_ANNOUNCED")
    for bad in ("SERVING", "LEAVE_ANNOUNCED"):
        with pytest.raises(CapacityProtocolError):
            broker._journal(2, bad)
    for step in CONVERSION_STEPS[1:]:
        broker._journal(2, step)
    with pytest.raises(CapacityProtocolError):
        broker._journal(2, "LEAVE_ANNOUNCED")
    train.clear_conversion(2)


# -- auto-apply and hysteresis ------------------------------------------------

def _apply_script(package):
    train, fleet, broker, t = _world(convert_cooldown_s=5.0,
                                     retire_cooldown_s=5.0, package=package)
    script = [(0, 0.0), (1, 0.0), (1, 2.0), (1, 6.0), (1, 20.0),
              (-1, 20.0), (-1, 21.0), (-1, 30.0), (-1, 40.0)]
    out = [broker.apply(d, now=now) for d, now in script]
    return out, _snapshot(train, fleet, broker)


def test_apply_executes_decisions_with_cooldowns():
    out, end = _apply_script("port")
    assert (out, end) == _apply_script("jax")
    assert out == [None, ("convert", 2), None, ("convert", 1), None,
                   ("retire", 1), None, ("retire", 2), None]
    assert end["stats"]["floor_refusals"] == 1
    assert end["training"] == (0, 1, 2)


def test_apply_false_preserves_surfaced_only_behavior():
    train, fleet, broker, t = _world(auto_apply=False)
    assert broker.apply(1, now=0.0) is None
    assert broker.apply(-1, now=1.0) is None
    assert broker.stats["surfaced"] == 2
    assert broker.stats["role_transfers"] == 0
    assert train.current_view().members == (0, 1, 2)
    assert len(fleet.live_replicas()) == 1


# -- the crash-recovery matrix ------------------------------------------------

_MATRIX = [("LEAVE_ANNOUNCED", "convert", "abort"),
           ("CONVERTING", "convert", "abort"),
           ("SERVING", "convert", "roll-forward"),
           ("RETIRING", "retire", "roll-forward"),
           ("REJOINING", "retire", "abort")]


def _assert_no_zombie(train, fleet, rank, broker):
    assert rank not in train.current_view().members
    assert rank not in {r.rid for r in fleet.live_replicas()}
    rid = broker.converted.get(rank, rank)
    assert rid not in {r.rid for r in fleet.live_replicas()}
    assert train.read_conversion(rank) is None
    assert rank not in broker.converted


def _kill_at(step, leg, package):
    if package == "port":
        schedule_cls, preempted = FaultSchedule, RankPreempted
    else:
        from chainermn_tpu.communicators.fault_schedule import \
            FaultSchedule as schedule_cls
        from chainermn_tpu.communicators.fault_schedule import \
            RankPreempted as preempted
    schedule = schedule_cls([dict(op="capacity.convert", action="preempt",
                                  prob=1.0, step=step, rank=2)],
                            seed=7).bind_rank(2)
    train, fleet, broker, t = _world(schedule=schedule, package=package)
    if leg == "convert":
        with pytest.raises(preempted):
            broker.convert_to_serving(now=0.0)
        killed = 2
    else:
        broker.schedule = None
        killed = broker.convert_to_serving(now=0.0)
        broker.schedule = schedule
        with pytest.raises(preempted):
            broker.retire_to_training(killed, now=0.0)
    entry = train.read_conversion(killed)
    assert entry is not None and entry[0] == step
    if step == "SERVING":
        fleet.preempt(broker.converted.get(killed, killed), now=0.0)
    first = broker.recover_orphans(now=1.0)
    assert train.read_conversion(killed) is not None
    actions = broker.recover_orphans(now=2.0)
    return killed, first, actions, train, fleet, broker


@pytest.mark.parametrize("step,leg,expect", _MATRIX,
                         ids=[s for s, _, _ in _MATRIX])
def test_seeded_kill_at_every_step_recovers(step, leg, expect):
    """A seeded preempt at ``step``; the orphaned journal entry is found
    after ``stale_s``, typed, and rolled forward or aborted, leaving no
    trace in either role group and the fleet's first replica live; the
    JAX broker takes the same action to the same world."""
    killed, first, actions, train, fleet, broker = _kill_at(step, leg,
                                                            "port")
    assert first == ()
    assert actions == ((killed, step, expect),)
    _assert_no_zombie(train, fleet, killed, broker)
    key = "aborted" if expect == "abort" else "rolled_forward"
    assert broker.stats[key] == 1
    assert 0 in {r.rid for r in fleet.live_replicas()}
    j = _kill_at(step, leg, "jax")
    assert (j[0], j[1], j[2]) == (killed, first, actions)
    assert _snapshot(*j[3:]) == _snapshot(train, fleet, broker)


def test_orphan_sweep_skips_live_conversions():
    train, fleet, broker, t = _world()
    rank = broker.convert_to_serving(now=0.0)
    assert broker.recover_orphans(now=0.0) == ()
    assert broker.recover_orphans(now=100.0) == ()
    assert train.read_conversion(rank)[0] == "SERVING"
    train.journal_conversion("RETIRING", rank=rank)
    assert broker.recover_orphans(now=100.0) == ()
    train.journal_conversion("RETIRING", rank=rank, note="still moving")
    assert broker.recover_orphans(now=200.0) == ()
    assert broker.recover_orphans(now=200.2) == ()
    assert broker.recover_orphans(now=300.0) \
        == ((rank, "RETIRING", "roll-forward"),)
    _assert_no_zombie(train, fleet, rank, broker)


def test_half_admitted_carcass_is_discarded():
    train, fleet, broker, t = _world()
    broker._journal(2, "LEAVE_ANNOUNCED")
    train.announce_leave(rank=2)
    broker._journal(2, "CONVERTING")
    carcass = LocalReplica(2, FakeEngine(seed=9))
    carcass.live = False
    fleet.replicas[2] = carcass
    with pytest.raises(ValueError):
        fleet.discard(0)
    assert broker.recover_orphans(now=0.0) == ()
    assert broker.recover_orphans(now=1.0) == ((2, "CONVERTING", "abort"),)
    assert 2 not in fleet.replicas
    _assert_no_zombie(train, fleet, 2, broker)


def test_converting_orphan_with_landed_join_rolls_forward():
    train, fleet, broker, t = _world()
    rank = broker.convert_to_serving(now=0.0)
    rid = broker.converted[rank]
    train._journal[rank] = ("CONVERTING", 2, "")
    broker.converted.pop(rank)
    assert broker.recover_orphans(now=10.0) == ()
    assert broker.recover_orphans(now=11.0) \
        == ((rank, "CONVERTING", "roll-forward"),)
    assert train.read_conversion(rank)[0] == "SERVING"
    assert rid in {r.rid for r in fleet.live_replicas()}
    assert broker.converted[rank] == rid


def test_conversion_steps_constant_is_ordered():
    from chainermn_tpu.elastic import CONVERSION_STEPS as JAX_STEPS
    assert CONVERSION_STEPS == JAX_STEPS == (
        "LEAVE_ANNOUNCED", "CONVERTING", "SERVING", "RETIRING", "REJOINING")


def test_broker_acts_through_the_supervisor_on_its_own_rank():
    """A broker on the converting rank leaves and rejoins through its
    ``ElasticRecovery``'s ``capacity_leave``/``capacity_rejoin`` (which no
    longer raise): the leave is announced in the training group, and the
    rejoin is admitted by a survivor's resolve."""
    import threading

    from chainermn_tpu_torch.extensions import ElasticRecovery
    kv = KV()
    m0, m1 = _member(kv, 0), _member(kv, 1)
    rec = ElasticRecovery(membership=m1, verbose=False)
    fleet = ReplicaFleet(engine_factory=lambda rid: FakeEngine(seed=0),
                         replicas=1)
    broker = CapacityBroker(m1, fleet, recovery=rec,
                            engine_factory=lambda r: FakeEngine(seed=5))
    assert broker.convert_to_serving(rank=1) == 1
    assert m0.resolve(expect={0}).members == (0,)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "view", broker.retire_to_training(1)))
    t.start()
    import time
    deadline = time.monotonic() + 10
    while not m0.pending_joins() and time.monotonic() < deadline:
        time.sleep(0.01)
    view = m0.resolve(expect={0, 1})
    t.join()
    assert view.members == (0, 1) and out["view"] == 1
    assert rec.view == view and m1.scan_conversions() == {}
