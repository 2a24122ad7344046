"""The port's serving fleet against the JAX package's (twins of
``tests/serving_tests/test_fleet.py``), single process, on the CPU.

* The role-namespaced membership and the multicast tree plan: the port's
  plan equal to the JAX one; a ``fleet`` and an ``elastic`` group on one
  KV key-disjoint (a JAX member and a port member side by side as well);
  views of two roles never equal; the leader's published plan; the
  give-up naming the ``fleet`` group.
* The router on fake replicas (placements equal to the JAX router's), the
  scale policy's reads, hysteresis and cooldowns (decisions equal to the
  JAX policy's over the same gauge scripts), the off hatch, the surfaced
  scale decision, the zero-drop reroute past a saturated survivor and the
  requeue stamps.
* The kill/join arc on the JAX fleet and the port fleet at fp32 on the
  same weights (the JAX ``save_npz`` read by the port's ``load_npz``): the
  same tokens for every request, both equal to the solo run, the same
  ``sheds``, ``reroutes``, placements and sync rounds, the joiner bitwise
  the root, and the typed give-up naming ``'fleet'``.
* The port's own: the weight payload (bf16 bitwise, host arrays only, the
  typed mismatch), a disaggregated joiner whose prefill copy is refreshed
  on adoption, a mid-chunk request rerouted to a survivor, ``warmup``
  leaving pages and counters as they were, ``capacity_x``.

Tolerances: none; tokens, counters, placements and weights compare
exactly (both engines fp32 on the CPU, greedy).
"""

import math
import pickle
import threading

import numpy as np
import pytest
import torch

import chainermn_tpu.observability as jax_obs
from chainermn_tpu.communicators import ElasticMembership as JaxMembership
from chainermn_tpu.communicators import \
    multicast_tree_plan as jax_tree_plan
from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.serializers import save_npz
from chainermn_tpu_torch import observability
from chainermn_tpu_torch.communicators import (ElasticMembership,
                                               MembershipView,
                                               multicast_tree_plan)
from chainermn_tpu_torch.communicators._host_channel import \
    ChannelTimeoutError
from chainermn_tpu_torch.extensions import RecoveryGivingUp
from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.serializers import load_npz
from chainermn_tpu_torch.serving import (FleetRouter, NoLiveReplicaError,
                                         QueueDepthScalePolicy,
                                         QueueSaturatedError, ReplicaFleet,
                                         Request, ServingEngine, fleet_mode)
from chainermn_tpu_torch.serving.fleet import (LocalReplica,
                                               deserialize_state,
                                               serialize_state)
from tests.serving_tests.test_fleet import KV

VOCAB = 97
KW = dict(n_vocab=VOCAB, d_model=32, n_heads=1, n_layers=1, max_len=32)
ENGINE = dict(num_pages=32, page_size=16, max_batch=2, max_context=32,
              prefix_cache=False)


@pytest.fixture(autouse=True)
def _fresh_registry():
    observability.reset_registry()
    jax_obs.reset_registry()
    yield
    observability.reset_registry()
    jax_obs.reset_registry()


# -- multicast tree plan (pure) ----------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 9, 16, 17])
def test_tree_plan_properties(n):
    members = tuple(range(100, 100 + 3 * n, 3))
    root = members[n // 2]
    plan = multicast_tree_plan(members, root=root)
    assert plan == jax_tree_plan(members, root=root)
    assert plan == multicast_tree_plan(members, root=root)
    assert len(plan) == (math.ceil(math.log2(n)) if n > 1 else 0)
    dsts = [d for rnd in plan for _, d in rnd]
    assert sorted(dsts) == sorted(m for m in members if m != root)
    have = {root}
    for rnd in plan:
        for src, dst in rnd:
            assert src in have and dst not in have
        have |= {d for _, d in rnd}
    assert have == set(members)


def test_tree_plan_default_root_and_errors():
    assert multicast_tree_plan([5, 3, 9]) \
        == multicast_tree_plan([3, 5, 9], root=3)
    for bad in ([], [1, 1, 2]):
        with pytest.raises(ValueError):
            multicast_tree_plan(bad)
    with pytest.raises(ValueError):
        multicast_tree_plan([1, 2], root=7)


# -- role-namespaced membership ----------------------------------------------

def _member(kv, rank, role="elastic", world=2, cls=ElasticMembership, **kw):
    kw.setdefault("settle_s", 0.05)
    kw.setdefault("poll_s", 0.002)
    kw.setdefault("timeout_ms", 4000)
    return cls(kv, rank=rank, world=world, role=role, **kw)


@pytest.mark.parametrize("mix", ["port", "jax-rank1"])
def test_role_groups_are_key_disjoint(mix):
    """A fleet group and a training group in one store never see each
    other's keys; with ``jax-rank1`` rank 1's members are the JAX
    package's, on the same store."""
    cls1 = JaxMembership if mix == "jax-rank1" else ElasticMembership
    kv = KV()
    fleet0 = _member(kv, 0, role="fleet")
    el0 = _member(kv, 0)
    _member(kv, 1, role="fleet", cls=cls1).announce_join()
    _member(kv, 1, cls=cls1).announce_leave()
    assert el0.pending_joins() == ()
    assert "cmn/fleet/join/1" in kv.store
    assert "cmn/elastic/leave/1" in kv.store
    out = {}
    fleet1 = _member(kv, 1, role="fleet", cls=cls1)
    t = threading.Thread(target=lambda: out.setdefault(
        1, fleet1.resolve(expect={0, 1})))
    t.start()
    out[0] = fleet0.resolve(expect={0, 1})
    t.join()
    assert (out[0].epoch, out[0].members, out[0].role) \
        == (out[1].epoch, out[1].members, out[1].role) == (1, (0, 1),
                                                          "fleet")
    v = el0.resolve(expect={0})
    assert v.members == (0,) and v.role == "elastic"
    assert fleet0.current_epoch() == 1 and el0.current_epoch() == 1
    assert all(k.startswith(("cmn/fleet/", "cmn/elastic/"))
               for k in kv.store)


def test_views_of_different_roles_never_compare_equal():
    assert MembershipView(1, (0, 1), role="fleet") \
        != MembershipView(1, (0, 1))
    assert MembershipView(1, (0, 1)) == MembershipView(1, (0, 1))


def test_leader_publishes_tree_plan_next_to_view():
    kv = KV()
    m0 = _member(kv, 0, role="fleet", world=3)
    out = {}
    others = [_member(kv, r, role="fleet", world=3) for r in (1, 2)]
    ts = [threading.Thread(target=lambda m=m, r=r: out.setdefault(
        r, m.resolve(expect={0, 1, 2}))) for r, m in zip((1, 2), others)]
    for t in ts:
        t.start()
    out[0] = m0.resolve(expect={0, 1, 2})
    for t in ts:
        t.join()
    assert out[0].members == (0, 1, 2)
    assert "cmn/fleet/e1/tree" in kv.store
    assert others[0].read_tree_plan(1) == multicast_tree_plan((0, 1, 2))
    kv.key_value_delete("cmn/fleet/e1/tree")
    assert m0.read_tree_plan(1) == multicast_tree_plan((0, 1, 2))


def test_giving_up_names_the_fleet_group():
    err = RecoveryGivingUp(
        "fleet shrank below min_replicas=1",
        membership=MembershipView(4, (0, 2), role="fleet"))
    assert "group 'fleet'" in str(err)
    assert "epoch 4" in str(err) and "members [0, 2]" in str(err)
    err = RecoveryGivingUp("budget exhausted",
                           membership=MembershipView(2, (0,)))
    assert "group 'elastic'" in str(err)
    assert "membership" not in str(RecoveryGivingUp("budget exhausted"))


def test_membership_role_validation():
    for role in ("a/b", ""):
        with pytest.raises(ValueError):
            ElasticMembership(KV(), 0, 2, role=role)


# -- router policy (fake replicas, no engines) -------------------------------

class _FakeReplica:
    remote = False

    def __init__(self, rid, capacity=100):
        self.rid = rid
        self.live = True
        self.capacity = capacity
        self.q = []

    def submit(self, req):
        if len(self.q) >= self.capacity:
            raise QueueSaturatedError(req.tenant, len(self.q), self.capacity)
        self.q.append(req)

    def queue_depth(self, tenant=None):
        if tenant is None:
            return len(self.q)
        return sum(1 for r in self.q if r.tenant == tenant)

    def tenant_depths(self):
        out = {}
        for r in self.q:
            out[r.tenant] = out.get(r.tenant, 0) + 1
        return out

    def busy(self):
        return bool(self.q)


class _FakeFleet:
    def __init__(self, replicas):
        self.replicas = {r.rid: r for r in replicas}

    def live_replicas(self):
        return [self.replicas[rid] for rid in sorted(self.replicas)
                if self.replicas[rid].live]


def _req(tenant, rid=None, cls=Request):
    return cls(np.arange(1, 5, dtype=np.int32), 2, tenant=tenant,
               arrival_time=0.0, request_id=rid)


def test_router_per_tenant_fair_spread_is_decorrelated():
    """Each tenant rotates over every live replica with a cursor of its
    own, placements equal to the JAX router's on the same calls."""
    from chainermn_tpu.serving import FleetRouter as JaxRouter
    from chainermn_tpu.serving import Request as JaxRequest
    from tests.serving_tests.test_fleet import _FakeFleet as JaxFakeFleet
    from tests.serving_tests.test_fleet import _FakeReplica as JaxFake
    got = {}
    for name, router_cls, fake, fleet_cls, req_cls in [
            ("port", FleetRouter, _FakeReplica, _FakeFleet, Request),
            ("jax", JaxRouter, JaxFake, JaxFakeFleet, JaxRequest)]:
        router = router_cls(fleet_cls([fake(0), fake(1), fake(2)]))
        calls = [router.route(_req(t, cls=req_cls))
                 for t in ["a"] * 6 + ["b"] * 3 + ["a", "b"]]
        got[name] = (calls, router.by_replica, router.pressure())
    assert got["port"] == got["jax"]
    assert got["port"][0][:9] == [0, 1, 2, 0, 1, 2, 0, 1, 2]
    assert got["port"][1] == {0: 5, 1: 3, 2: 3}
    assert got["port"][2] == 7           # tenant a's 7, summed over replicas


def test_router_sheds_sideways_and_reraises_typed():
    full = _FakeReplica(0, capacity=0)
    fleet = _FakeFleet([full, _FakeReplica(1)])
    router = FleetRouter(fleet)
    assert router.route(_req("t")) == 1
    assert router.spills == 1
    fleet.replicas[1].capacity = 1
    with pytest.raises(QueueSaturatedError) as e:
        router.route(_req("t"))
    assert e.value.tenant == "t"
    for r in fleet.replicas.values():
        r.live = False
    with pytest.raises(NoLiveReplicaError):
        router.route(_req("t"))


def test_router_sheds_channel_dead_replica_at_ingress():
    """A dead remote worker found at submit (a typed channel error) does
    not reach the caller while a live replica exists: it is skipped for
    the placement and shed after it."""
    class _DeadReplica(_FakeReplica):
        remote = True

        def submit(self, req):
            raise ChannelTimeoutError("p2p", "key", 6000, 1)

    class _FleetWithPreempt(_FakeFleet):
        def __init__(self, replicas):
            super().__init__(replicas)
            self.preempted = []

        def preempt(self, rid, exc=None, now=None):
            self.replicas[rid].live = False
            self.preempted.append((rid, type(exc).__name__))

    fleet = _FleetWithPreempt([_DeadReplica(0), _FakeReplica(1)])
    router = FleetRouter(fleet)
    assert router.route(_req("t")) == 1
    assert fleet.preempted == [(0, "ChannelTimeoutError")]
    assert fleet.replicas[0].live is False
    assert router.route(_req("t")) == 1


def test_router_exclude_and_ledger():
    fleet = _FakeFleet([_FakeReplica(0), _FakeReplica(1)])
    router = FleetRouter(fleet)
    assert router.route(_req("t", rid="r-1"), exclude=(0,)) == 1
    assert router.ledger["r-1"] == 1
    assert router.placements(1) == ("r-1",)
    assert router.rerouted == 0
    router.route(_req("t", rid="r-2"), exclude=(1,), reroute=True)
    assert router.rerouted == 1
    assert router.queue_depths() == {0: 1, 1: 1}


# -- scale policy off the registry gauges ------------------------------------

#: (policy kwargs, [(gauge {tenant: depth} or None, n_live, now, expected)])
_POLICY_SCRIPTS = {
    "reads": (dict(scale_up_depth=8, scale_down_depth=0, min_replicas=1,
                   max_replicas=4),
              [(None, 2, None, 0), ({"a": 3, "b": 9}, 2, None, 1),
               ({}, 4, None, 0), ({"a": 0, "b": 0}, 2, None, -1),
               ({}, 1, None, 0)]),
    "hysteresis": (dict(scale_up_depth=8, scale_down_depth=2,
                        min_replicas=1, max_replicas=4),
                   [({"a": 9}, 2, None, 1), ({}, 2, None, 0),
                    ({}, 3, None, 0), ({"a": 5}, 3, None, 0),
                    ({"a": 12}, 3, None, 1), ({}, 3, None, 0),
                    ({"a": 1}, 4, None, -1), ({}, 3, None, 0),
                    ({}, 2, None, 0), ({"a": 5}, 2, None, 0),
                    ({"a": 0}, 2, None, -1)]),
    "cooldown": (dict(scale_up_depth=8, scale_down_depth=0, max_replicas=8,
                      up_cooldown_s=10.0, down_cooldown_s=20.0),
                 [({"a": 9}, 2, 0.0, 1), ({"a": 3}, 2, 1.0, 0),
                  ({"a": 9}, 2, 5.0, 0), ({}, 2, 12.0, 1),
                  ({"a": 0}, 3, 13.0, -1), ({"a": 9}, 3, 14.0, None),
                  ({"a": 0}, 3, 20.0, 0), ({}, 3, 34.0, -1)]),
}


@pytest.mark.parametrize("script", sorted(_POLICY_SCRIPTS))
def test_queue_depth_scale_policy_matches_jax(script):
    """The JAX suite's three policy tests (registry reads, one decision a
    sustained excursion, per-direction cooldowns) as gauge scripts: the
    port's policy over the port's registry gives the JAX policy's
    decisions over the JAX registry, and the JAX test's expectations
    (``None``: not asserted there)."""
    from chainermn_tpu.serving import QueueDepthScalePolicy as JaxPolicy
    kwargs, steps = _POLICY_SCRIPTS[script]
    runs = []
    for policy_cls, obs in ((QueueDepthScalePolicy, observability),
                            (JaxPolicy, jax_obs)):
        reg = obs.registry()
        policy = policy_cls(**kwargs)
        gauge = None
        out = []
        for depths, n_live, now, _ in steps:
            if depths is not None:
                gauge = reg.gauge(QueueDepthScalePolicy.GAUGE)
                for tenant, d in depths.items():
                    gauge.set(d, tenant=tenant)
            out.append(policy.decide(reg, n_live, now=now))
        runs.append(out)
    assert runs[0] == runs[1]
    assert [d for d, (*_, want) in zip(runs[0], steps) if want is not None] \
        == [want for *_, want in steps if want is not None]
    with pytest.raises(ValueError):
        QueueDepthScalePolicy(scale_up_depth=2, scale_down_depth=5)


# -- engine-level pieces (tiny fp32 engines) ---------------------------------

@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """The JAX fleet test's models (seeds 0 and 123), for both packages."""
    d = tmp_path_factory.mktemp("fleet")
    out = {}
    for seed in (0, 123):
        out[seed] = str(d / f"lm{seed}.npz")
        save_npz(out[seed], JaxLM(seed=seed, **KW))
    return out


def _port_engine(npz_file, **kw):
    """A port engine over a module of its own (adoption writes in place:
    replicas never share one)."""
    opts = dict(ENGINE, page_dtype=torch.float32, device="cpu")
    opts.update(kw)
    return ServingEngine(load_npz(npz_file, TransformerLM(device="cpu",
                                                          **KW)), **opts)


def _jax_engine(seed):
    """The JAX engine over the model the npz of ``seed`` was saved from."""
    import jax.numpy as jnp

    from chainermn_tpu.serving import ServingEngine as JaxEngine
    return JaxEngine(JaxLM(seed=seed, **KW), page_dtype=jnp.float32,
                     **ENGINE)


def test_reroute_forces_past_saturated_survivor_zero_drop(npz):
    def factory(rid):
        eng = _port_engine(npz[0])
        eng.scheduler.max_queue = 1
        return eng

    fleet = ReplicaFleet(engine_factory=factory, replicas=2)
    rng = np.random.RandomState(11)
    reqs = [Request(rng.randint(1, VOCAB, 5).astype(np.int32), 3,
                    tenant="t0", arrival_time=0.0, request_id=i)
            for i in range(2)]
    assert [fleet.submit(r) for r in reqs] == [0, 1]
    fleet.preempt(1, now=0.0)
    assert fleet.reroutes == 1
    fleet.drain(now=1.0)
    assert sorted(r.request_id for r in fleet.completed) == [0, 1]


def test_drain_for_reroute_requeue_stamp_clock_domains(npz):
    engine = _port_engine(npz[0])
    running = Request(np.arange(1, 6, dtype=np.int32), 3, tenant="t",
                      arrival_time=0.0, request_id="run")
    queued = Request(np.arange(1, 6, dtype=np.int32), 3, tenant="t",
                     arrival_time=0.0, request_id="q")
    engine.submit(running)
    engine.step(now=0.5)
    engine.submit(queued)
    reqs = {r.request_id: r
            for r in LocalReplica(0, engine).drain_for_reroute(now=5.0)}
    assert reqs["run"].requeue_time == 5.0
    assert reqs["q"].requeue_time is None
    assert engine.allocator.used_pages == 0 and not engine.running
    engine2 = _port_engine(npz[0])
    r2 = Request(np.arange(1, 6, dtype=np.int32), 3, tenant="t",
                 arrival_time=0.0)
    engine2.submit(r2)
    engine2.step()
    assert LocalReplica(1, engine2).drain_for_reroute()[0].requeue_time \
        is not None


def test_fleet_off_hatch_is_single_engine(npz, monkeypatch):
    monkeypatch.setenv("CHAINERMN_TPU_FLEET", "off")
    assert fleet_mode() is False and fleet_mode(True) is False
    calls = []

    def factory(rid):
        calls.append(rid)
        return _port_engine(npz[0])

    fleet = ReplicaFleet(engine_factory=factory, replicas=3)
    assert calls == [0]
    reqs = [Request(np.arange(1, 6, dtype=np.int32), 2, tenant="t",
                    arrival_time=0.0) for _ in range(3)]
    assert [fleet.submit(r) for r in reqs] == [0, 0, 0]
    with pytest.raises(RecoveryGivingUp) as e:
        fleet.join(engines={1: _port_engine(npz[123])})
    assert "CHAINERMN_TPU_FLEET=off" in str(e.value)
    fleet.drain(now=1.0)
    assert len(fleet.completed) == 3
    monkeypatch.delenv("CHAINERMN_TPU_FLEET")
    assert fleet_mode() is True and fleet_mode(False) is False


def test_fleet_step_surfaces_scale_decision(npz):
    fleet = ReplicaFleet(engine_factory=lambda rid: _port_engine(npz[0]),
                         replicas=1,
                         scale_policy=QueueDepthScalePolicy(
                             scale_up_depth=2, max_replicas=4))
    for i in range(8):
        fleet.submit(Request(np.arange(1, 5, dtype=np.int32), 2,
                             tenant="t", arrival_time=10.0 + i))
    st = fleet.step(now=0.0)
    assert st["scale_decision"] == 1
    assert st["capacity_x"] == 1.0 and st["replicas"] == 1
    fleet.drain(now=20.0)
    assert fleet.step(now=30.0)["scale_decision"] in (-1, 0)


# -- the fleet arc on both packages ------------------------------------------

def _leaves(engine):
    if isinstance(getattr(engine, "model", None), torch.nn.Module):
        return [t.numpy() for t in engine.model.state_dict().values()]
    import jax
    return [np.asarray(x) for x in jax.tree.leaves(engine.state)]


def _arc(fleet_cls, request_cls, make_engine, reg, giving_up):
    """The JAX ``test_fleet_arc_kill_join_parity`` on one package: six
    requests over two replicas, replica 1 killed at its first decode
    step, a cold replica (seed-123 weights) joined, four more requests,
    then both remaining replicas lost.  Returns what the two packages must
    agree on."""
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, VOCAB, rng.randint(4, 9)).astype(np.int32)
               for _ in range(6)]
    fleet = fleet_cls(engine_factory=lambda rid: make_engine(0), replicas=2)
    assert fleet.view.role == "fleet"
    reqs = [request_cls(p, 4, tenant=f"t{i % 2}", arrival_time=0.0,
                        request_id=i) for i, p in enumerate(prompts)]
    placements = [fleet.submit(r) for r in reqs]
    epoch0 = fleet.view.epoch
    fleet.replicas[1].kill_at = 1
    fleet.drain(now=1.0)
    r = {"placements": placements,
         "completed": sorted(q.request_id for q in fleet.completed),
         "generated": {q.request_id: [int(t) for t in
                                      q.prompt[len(prompts[q.request_id]):]]
                       + [int(t) for t in q.tokens]
                       for q in fleet.completed},
         "rerouted": sorted(q.request_id for q in fleet.completed
                            if q.preemptions > 0),
         "sheds": fleet.sheds, "reroutes": fleet.reroutes,
         "epoch_moved": fleet.view.epoch > epoch0}
    joiner = make_engine(123)
    root = _leaves(fleet.replicas[0].engine)
    r["joiner_differed"] = any((a != b).any()
                               for a, b in zip(_leaves(joiner), root))
    r["join"] = fleet.join(engines={2: joiner})
    r["join_bitwise"] = all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
                            for a, b in zip(_leaves(joiner), root))
    r["sync"] = (fleet.weight_syncs, fleet.weight_sync_rounds,
                 fleet.weight_sync_bytes > 0)
    more = [request_cls(rng.randint(1, VOCAB, 4).astype(np.int32), 2,
                        tenant="t0", arrival_time=0.0, request_id=100 + i)
            for i in range(4)]
    r["new_placements"] = [fleet.submit(q) for q in more]
    fleet.drain(now=2.0)
    r["more_tokens"] = {q.request_id: [int(t) for t in q.tokens]
                        for q in fleet.completed if q.request_id >= 100}
    r["by_replica"] = dict(fleet.router.by_replica)
    r["gauges"] = (reg.gauge("chainermn_tpu_fleet_replicas").value(),
                   reg.counter("chainermn_tpu_fleet_reroutes_total").value())
    fleet.preempt(0)
    with pytest.raises(giving_up) as e:
        fleet.preempt(2)
    r["give_up"] = ("group 'fleet'" in str(e.value),
                    e.value.membership.role)
    return r, prompts


def test_fleet_arc_kill_join_parity(npz):
    """The arc on the JAX fleet and on the port fleet, fp32, the same
    weights: every request completes exactly once, with the same tokens
    in both packages and the solo run's; the same sheds, reroutes,
    placements and sync rounds; the joiner bitwise the root; the last
    replica's loss gives up typed, naming the fleet group."""
    from chainermn_tpu.extensions import RecoveryGivingUp as JaxGivingUp
    from chainermn_tpu.serving import ReplicaFleet as JaxFleet
    from chainermn_tpu.serving import Request as JaxRequest
    port, prompts = _arc(ReplicaFleet, Request,
                         lambda seed: _port_engine(npz[seed]),
                         observability.registry(), RecoveryGivingUp)
    jax_r, _ = _arc(JaxFleet, JaxRequest, _jax_engine, jax_obs.registry(),
                    JaxGivingUp)
    assert port == jax_r
    assert set(port["placements"]) == {0, 1}
    assert port["completed"] == list(range(6))
    assert port["sheds"] == 1 and port["reroutes"] >= 1
    assert port["rerouted"] and port["epoch_moved"]
    assert port["joiner_differed"] and port["join_bitwise"]
    assert port["join"] == [2] and port["sync"] == (1, 1, True)
    assert 2 in port["new_placements"]
    assert sorted(port["more_tokens"]) == [100, 101, 102, 103]
    assert port["gauges"] == (2, port["reroutes"])
    assert port["give_up"] == (True, "fleet")
    # the solo run: each request alone through one engine
    solo = _port_engine(npz[0])
    for i, p in enumerate(prompts):
        solo.submit(Request(p, 4, tenant="g", arrival_time=0.0))
        solo.drain(now=1.0)
        assert port["generated"][i] == solo.completed[-1].tokens, i


# -- the port's own ----------------------------------------------------------

def test_bf16_payload_round_trips_bitwise():
    """A bf16 module's payload goes as raw 16-bit integers with its dtype
    named, and lands bitwise; the payload holds host arrays and strings
    only (no device)."""
    src = TransformerLM(seed=0, device="cpu", **KW).to(torch.bfloat16)
    dst = TransformerLM(seed=5, device="cpu", **KW).to(torch.bfloat16)
    payload = serialize_state(src)
    leaves = pickle.loads(payload)
    assert all(isinstance(name, str) and isinstance(arr, np.ndarray)
               for name, _, arr in leaves)
    assert {dt for _, dt, _ in leaves} == {"bfloat16"}
    assert {arr.dtype for _, _, arr in leaves} == {np.dtype(np.int16)}
    state = deserialize_state(dst, payload)
    dst.load_state_dict(state)
    for (name, a), b in zip(src.state_dict().items(),
                            dst.state_dict().values()):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), name
    # a state dict serializes as its module does
    assert serialize_state(src.state_dict()) == payload


def test_payload_mismatch_is_typed():
    src = TransformerLM(seed=0, device="cpu", **KW)
    wider = TransformerLM(seed=0, device="cpu",
                          **dict(KW, n_layers=2))
    with pytest.raises(ValueError, match="leaves"):
        deserialize_state(wider, serialize_state(src))
    with pytest.raises(ValueError, match="does not match"):
        deserialize_state(src.to(torch.bfloat16),
                          serialize_state(TransformerLM(seed=0,
                                                        device="cpu",
                                                        **KW)))


def _tokens(engine, prompts, max_new=6):
    for i, p in enumerate(prompts):
        engine.submit(Request(p, max_new, tenant=f"t{i % 2}",
                              arrival_time=0.0, request_id=i))
    engine.drain(now=0.0)
    return {r.request_id: [int(t) for t in r.prompt[len(prompts[
        r.request_id]):]] + list(r.tokens) for r in engine.completed}


def test_disagg_joiner_refreshes_its_prefill_copy(npz):
    """A disaggregated engine whose prefill device is another device keeps
    a copy of the model there (``cpu:0`` here, a device of its own to the
    engine).  Adoption refreshes it: the joiner's tokens are the root's.
    Without the refresh its prefills would run on the cold weights."""
    root = ReplicaFleet(engines={0: _port_engine(npz[0], prefix_cache=True,
                                                 max_context=32)})
    joiner = _port_engine(npz[123], disagg=True, prefill_device="cpu:0",
                          prefix_cache=True)
    assert joiner._model_prefill is not joiner.model
    root.join(engines={1: joiner})
    for a, b in zip(joiner._model_prefill.state_dict().values(),
                    root.replicas[0].engine.model.state_dict().values()):
        assert torch.equal(a, b)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, VOCAB, n).astype(np.int32) for n in (9, 20)]
    assert _tokens(joiner, prompts) \
        == _tokens(_port_engine(npz[0]), prompts)
    assert joiner.transfers == 2


def test_mid_chunk_request_reroutes_to_a_survivor(npz):
    """A replica dies holding a prompt between its chunks (disaggregated:
    the chunks ran on its scratch pool) and a running one: both replay on
    the survivor and finish with the solo run's tokens; nothing of the
    dead engine travels with them."""
    opts = dict(disagg=True, chunk_tokens=16, prefix_cache=True,
                max_context=32)
    fleet = ReplicaFleet(engines={0: _port_engine(npz[0], **opts),
                                  1: _port_engine(npz[0], **opts)})
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, VOCAB, n).astype(np.int32)
               for n in (6, 28, 7, 25)]
    reqs = [Request(p, 3, tenant="t", arrival_time=0.0, request_id=i)
            for i, p in enumerate(prompts)]
    assert [fleet.submit(r) for r in reqs] == [0, 1, 0, 1]
    dead = fleet.replicas[1].engine
    dead.step(now=0.0)       # admits 1 (chunk 0 on the scratch pool)
    assert [r.request_id for r in dead.prefilling] == [1] \
        and dead.prefilling[0]._chunk_scratch
    assert fleet.preempt(1, now=0.0) == 2
    assert dead.allocator.used_pages == 0
    fleet.drain(now=1.0)
    done = {r.request_id: [int(t) for t in r.prompt[len(prompts[
        r.request_id]):]] + list(r.tokens) for r in fleet.completed}
    assert done == _tokens(_port_engine(npz[0]), prompts, max_new=3)
    survivor = fleet.replicas[0].engine
    assert survivor.allocator.check() and survivor.allocator.used_pages == 0


@pytest.mark.parametrize("opts", [
    dict(), dict(prefix_cache=True, chunk_tokens=16),
    dict(prefix_cache=True, disagg=True, chunk_tokens=16, spec_k=2)],
    ids=["plain", "chunks", "disagg-chunks-spec"])
def test_warmup_leaves_pages_and_counters(npz, opts):
    """``warmup`` runs a dispatch of every padded shape with its writes on
    the trash pages: mid-run, the live pages, the allocator, the
    counters and the tokens that follow are unchanged."""
    rng = np.random.RandomState(9)
    prompts = [rng.randint(1, VOCAB, n).astype(np.int32) for n in (5, 21)]
    want = _tokens(_port_engine(npz[0], **opts), prompts, max_new=4)
    engine = _port_engine(npz[0], **opts)
    for i, p in enumerate(prompts):
        engine.submit(Request(p, 4, tenant=f"t{i % 2}", arrival_time=0.0,
                              request_id=i))
    engine.step(now=0.0)
    names = ("full_prefills", "admissions", "decode_steps", "chunk_prefills",
             "transfers", "transferred_page_bytes", "spec_steps", "forks",
             "prefix_hits", "evictions")
    before = ({k: getattr(engine, k) for k in names},
              engine.kv.k_pool.clone(), engine.kv.v_pool.clone(),
              engine.allocator.used_pages)
    engine.warmup()
    after = ({k: getattr(engine, k) for k in names},
             engine.kv.k_pool, engine.kv.v_pool,
             engine.allocator.used_pages)
    assert before[0] == after[0] and before[3] == after[3]
    assert torch.equal(before[1], after[1]) \
        and torch.equal(before[2], after[2])
    engine.drain(now=0.0)
    got = {r.request_id: [int(t) for t in r.prompt[len(prompts[
        r.request_id]):]] + list(r.tokens) for r in engine.completed}
    assert got == want


def test_scheduler_tenant_depths_and_total_len():
    from chainermn_tpu_torch.serving import RequestScheduler
    sched = RequestScheduler()
    for i, t in enumerate("aab"):
        sched.submit(Request(np.arange(1, 4), 2, tenant=t, request_id=i))
    assert sched.tenant_depths() == {"a": 2, "b": 1}
    req = sched.next_admission()
    req.tokens = [5, 6]
    assert req.total_len == 5
    assert sched.tenant_depths() == {"a": 1, "b": 1}
