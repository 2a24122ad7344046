"""The serving fleet and the capacity transfer over a real 2-rank gloo
world: twins of ``tests/multiprocess_tests``' ``fleet`` and ``capacity``
scenarios (``_worker.run_fleet``, ``_worker.run_capacity``) with their PASS
names, and a third leg the JAX suite lacks, run one after the other in one
spawned world on a FileStore (the job's store: the object channel and the
membership ride it).  The workers import no JAX.

``fleet``: rank 0 runs the router and replica 0, rank 1 a ``FleetWorker``.
Replica 1 is killed at its 2nd decode step under load: the worker
announces its fleet-role leave and goes silent, the router detects it
through the channel's typed timeout (6 s, the JAX detection deadline),
resolves the fleet to {0} and replays every request replica 1 held from
its original prompt: no drop, every stream the solo run's.  Replica 1
parks, rejoins, perturbs its weights and adopts the root's over the
multicast tree bitwise; the router then places new requests on it.

``capacity``: leg A, a seeded preempt at ``CONVERTING`` kills rank 1's
conversion after its training leave and before its fleet admission; the
survivor's ``recover_orphans`` finds the frozen journal beat in the store
and aborts the orphan (rank 1 in neither group, the journal scrubbed), and
rank 1 rejoins training.  Leg B, queue pressure trips the policy's +1,
``CapacityBroker.apply`` converts rank 1 (training {0}, fleet {0, 1}, the
joiner's seed-1 weights overwritten bitwise over the tree), the fleet
serves the backlog on both replicas with no drop, the drained queues trip
the -1, and ``apply`` retires rank 1 into training: both groups whole.

``elastic_capacity``: ``ElasticRecovery.capacity_leave`` and
``capacity_rejoin(trainer)`` on an ``ElasticMeshCommunicator``.  Rank 1
leaves training cleanly at iteration 4 (its supervisor takes the stint:
it waits for the survivors' shrink, serves two requests on a one-replica
fleet, then rejoins); rank 0 detects the departure at the beacon, shrinks
to {0} keeping the global batch of 8 (it takes the whole batch), and
admits rank 1 again at its join poll; rank 1 comes back through the
snapshot sync, and both end at 24 iterations with the same parameters,
the loss within the elastic twin's +-5 % of an uninterrupted run.

The two scenarios take their membership groups in namespaces of their own
(the training leg keeps the default one).  The world's join deadline is
300 s; it takes ~30 s alone.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_chaos import (BAND, ITERS, _beacon, _data, _digest,
                                    _model, _slicer)
from tests.test_torch_communicator import spawn_ranks

JOIN_S = 300
DETECT_S = 6.0          # the JAX scenario's channel deadline
LM = dict(n_vocab=127, d_model=32, n_heads=1, n_layers=1, max_len=32)
ENGINE = dict(num_pages=32, page_size=16, max_batch=2, max_context=32,
              prefix_cache=False, device="cpu")
FLEET_PASS = ("fleet_zero_drop", "fleet_detection_bounded",
              "fleet_replay_parity", "fleet_router_spreads_to_joiner",
              "fleet_shrunk_to_survivor", "fleet_weight_sync_bit_identical")
CAPACITY_PASS = ("capacity_kill_mid_conversion", "capacity_orphan_aborted",
                 "capacity_abort_rank_rejoined", "capacity_auto_converted",
                 "capacity_sync_bit_identical", "capacity_zero_drop",
                 "capacity_worker_served_and_stopped",
                 "capacity_retired_to_training")
ELASTIC_PASS = ("capacity_leave_clean", "elastic_shrunk_keeping_batch",
                "capacity_served_stint", "capacity_rejoined_via_snapshot",
                "elastic_capacity_agreed")


def _engine(seed=0):
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import ServingEngine
    return ServingEngine(TransformerLM(seed=seed, device="cpu", **LM),
                         **ENGINE)


def _state(engine):
    return [t.clone() for t in engine.model.state_dict().values()]


def _ok(passed, name):
    """A gate passed: printed as the JAX workers print it, and kept."""
    print(f"PASS {name}", flush=True)
    passed.append(name)


def _wait(cond, timeout_s, poll_s=0.02):
    import time
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(poll_s)
    return cond()


def _fleet(rank, ch):
    """The twin of ``_worker.run_fleet``."""
    import time

    from chainermn_tpu_torch.communicators import ElasticMembership
    from chainermn_tpu_torch.serving import (FleetWorker, RemoteReplica,
                                             ReplicaFleet, Request)
    passed = []
    kill_at, n_reqs = 2, 8
    membership = ElasticMembership(ch._client, rank=rank, world=2,
                                   namespace="fleetchaos", role="fleet",
                                   settle_s=0.5, poll_s=0.02,
                                   timeout_ms=90_000)
    engine = _engine()
    if rank == 1:
        worker = FleetWorker(engine, ch, membership=membership,
                             router_process=0)
        assert worker.serve(kill_at=kill_at) == "preempted"
        before = _state(engine)
        epoch = membership.current_epoch()
        assert _wait(lambda: membership.current_epoch() != epoch, 60)
        assert membership.current_view().members == (0,)
        _ok(passed, "fleet_shrunk_to_survivor")
        time.sleep(0.5)
        with torch.no_grad():
            for p in engine.model.parameters():
                p.add_(1.0)
        membership.announce_join(note="rejoin after preemption")
        view = membership.resolve(expect={0, 1}, require={0})
        assert 1 in view and view.role == "fleet"
        assert worker.sync_weights(view, joiners=(1,)) == 1
        assert all(torch.equal(a, b) for a, b in zip(_state(engine),
                                                     before))
        _ok(passed, "fleet_weight_sync_bit_identical")
        assert worker.serve() == "stopped"
        return {"passed": passed}

    fleet = ReplicaFleet(engines={0: engine, 1: RemoteReplica(1, ch, 1)},
                         membership=membership)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, LM["n_vocab"], rng.randint(4, 9))
               .astype(np.int32) for _ in range(n_reqs)]
    reqs = [Request(p, 4, tenant=f"t{i % 2}", arrival_time=0.0,
                    request_id=i) for i, p in enumerate(prompts)]
    assert {fleet.submit(r) for r in reqs} == {0, 1}
    rejoined, detect_dt = False, None
    deadline = time.monotonic() + 120
    while (fleet.pending() or not rejoined) and time.monotonic() < deadline:
        if fleet.pending():
            sheds, t0 = fleet.sheds, time.monotonic()
            fleet.step()
            if fleet.sheds > sheds:
                detect_dt = time.monotonic() - t0
        if not rejoined and fleet.sheds:
            if membership.pending_joins(fleet.view):
                fleet.join(engines={1: RemoteReplica(1, ch, 1)})
                rejoined = True
            else:
                time.sleep(0.05)
    assert rejoined, "replica 1 never rejoined"
    assert sorted(r.request_id for r in fleet.completed) \
        == list(range(n_reqs))
    assert fleet.sheds == 1 and fleet.reroutes >= 1, fleet.stats()
    _ok(passed, "fleet_zero_drop")
    assert detect_dt is not None and detect_dt <= DETECT_S + 8.0, detect_dt
    _ok(passed, "fleet_detection_bounded")
    golden = _engine()
    for req in sorted(fleet.completed, key=lambda r: r.request_id):
        golden.submit(Request(prompts[req.request_id], 4, tenant="g",
                              arrival_time=0.0))
        golden.drain(now=1.0)
        generated = [int(t) for t in req.prompt[len(prompts[
            req.request_id]):]] + list(req.tokens)
        assert generated == golden.completed[-1].tokens, req.request_id
    _ok(passed, "fleet_replay_parity")
    more = [Request(rng.randint(1, LM["n_vocab"], 5).astype(np.int32), 2,
                    tenant="t0", arrival_time=0.0, request_id=100 + i)
            for i in range(3)]
    placements = [fleet.submit(r) for r in more]
    assert 1 in placements, placements
    fleet.drain()
    assert sorted(r.request_id for r in fleet.completed
                  if r.request_id >= 100) == [100, 101, 102]
    _ok(passed, "fleet_router_spreads_to_joiner")
    for rep in fleet.replicas.values():
        if rep.remote and rep.live:
            rep.stop()
    return {"passed": passed, "detect_s": detect_dt,
            "stats": fleet.stats()}


def _capacity(rank, ch):
    """The twin of ``_worker.run_capacity``."""
    import time

    from chainermn_tpu_torch.communicators import (ElasticMembership,
                                                   FaultSchedule)
    from chainermn_tpu_torch.communicators.fault_schedule import \
        RankPreempted
    from chainermn_tpu_torch.elastic import CapacityBroker
    from chainermn_tpu_torch.serving import (FleetWorker,
                                             QueueDepthScalePolicy,
                                             RemoteReplica, ReplicaFleet,
                                             Request)
    cap_tag = 7003
    passed = []

    def member(role):
        return ElasticMembership(ch._client, rank=rank, world=2,
                                 namespace="capchaos", role=role,
                                 settle_s=2.0 if rank == 0 else 0.5,
                                 poll_s=0.02, timeout_ms=90_000)

    def digest(engine):
        return [t.numpy().tobytes() for t in _state(engine)]
    train, fleet_member = member("elastic"), member("fleet")
    engine = _engine(seed=rank)
    if rank == 1:
        worker = FleetWorker(engine, ch, membership=fleet_member,
                             router_process=0)
        assert ch.recv_obj(0, tag=cap_tag) == ("rejoin_training",)
        train.announce_join(note="back after aborted conversion")
        assert train.resolve(expect={0, 1}, require={0}).members == (0, 1)
        _ok(passed, "capacity_abort_rank_rejoined")
        assert ch.recv_obj(0, tag=cap_tag) == ("convert",)
        fleet_member.announce_join(note="capacity transfer")
        fview = fleet_member.resolve(expect={0, 1}, require={0})
        assert 1 in fview and fview.role == "fleet", fview
        assert worker.sync_weights(fview, joiners=(1,)) == 1
        ch.send_obj(digest(engine), 0, tag=cap_tag)
        assert worker.serve() == "stopped"
        _ok(passed, "capacity_worker_served_and_stopped")
        train.announce_join(note="capacity transfer: rejoin")
        assert train.resolve(expect={0, 1}, require={0}).members == (0, 1)
        _ok(passed, "capacity_retired_to_training")
        return {"passed": passed}

    policy = QueueDepthScalePolicy(scale_up_depth=2, scale_down_depth=0,
                                   min_replicas=1, max_replicas=2)
    fleet = ReplicaFleet(engines={0: engine}, membership=fleet_member,
                         min_replicas=1, scale_policy=policy)
    sched = FaultSchedule([dict(op="capacity.convert", action="preempt",
                                prob=1.0, step="CONVERTING", rank=1,
                                count=1)], seed=1234).bind_rank(1)
    broker = CapacityBroker(train, fleet,
                            engine_factory=lambda r: RemoteReplica(r, ch, r),
                            min_world=1, stale_s=1.0, schedule=sched)
    # -- leg A: a seeded preempt mid-conversion
    with pytest.raises(RankPreempted):
        broker.convert_to_serving(rank=1)
    entry = train.read_conversion(1)
    assert entry is not None and entry[0] == "CONVERTING", entry
    _ok(passed, "capacity_kill_mid_conversion")
    broker.schedule = None
    actions = ()
    deadline = time.monotonic() + 30
    while not actions and time.monotonic() < deadline:
        actions = broker.recover_orphans()
        time.sleep(0.25)
    assert actions == ((1, "CONVERTING", "abort"),), actions
    assert train.scan_conversions() == {}
    assert train.resolve(expect={0}).members == (0,)
    assert [r.rid for r in fleet.live_replicas()] == [0]
    assert 1 not in fleet.replicas and 1 not in broker.converted
    _ok(passed, "capacity_orphan_aborted")
    ch.send_obj(("rejoin_training",), 1, tag=cap_tag)
    assert _wait(lambda: train.pending_joins() == (1,), 60, 0.05)
    assert train.resolve(expect={0, 1}).members == (0, 1)
    _ok(passed, "capacity_abort_rank_rejoined")
    # -- leg B: pressure, convert, serve, drain, retire
    rng = np.random.RandomState(3)
    reqs = [Request(rng.randint(1, LM["n_vocab"], rng.randint(4, 9))
                    .astype(np.int32), 4, tenant=f"t{i % 2}",
                    arrival_time=0.0, request_id=i) for i in range(8)]
    for r in reqs:
        fleet.submit(r)
    st = fleet.step()
    assert st["scale_decision"] == 1, st
    ch.send_obj(("convert",), 1, tag=cap_tag)
    assert _wait(lambda: fleet_member._try_get(
        f"{fleet_member._base}/join/1") is not None, 60)
    assert broker.apply(st["scale_decision"]) == ("convert", 1)
    assert train.read_conversion(1)[0] == "SERVING"
    assert train.resolve(expect={0}).members == (0,)
    assert sorted(r.rid for r in fleet.live_replicas()) == [0, 1]
    _ok(passed, "capacity_auto_converted")
    assert ch.recv_obj(1, tag=cap_tag) == digest(engine), \
        "the tree sync did not land bitwise weights on the joiner"
    _ok(passed, "capacity_sync_bit_identical")
    more = [Request(rng.randint(1, LM["n_vocab"], 5).astype(np.int32), 3,
                    tenant=f"t{i % 2}", arrival_time=0.0,
                    request_id=100 + i) for i in range(6)]
    assert 1 in [fleet.submit(r) for r in more]
    decision, steps = 0, 0
    while fleet.pending() and steps < 10000:
        st = fleet.step()
        decision = st["scale_decision"] or decision
        steps += 1
    assert sorted(r.request_id for r in fleet.completed) \
        == sorted(r.request_id for r in reqs + more)
    _ok(passed, "capacity_zero_drop")
    assert decision == -1, decision
    assert broker.apply(decision) == ("retire", 1)
    assert train.read_conversion(1) is None
    assert [r.rid for r in fleet.live_replicas()] == [0]
    assert (broker.stats["conversions"], broker.stats["retires"],
            broker.stats["role_transfers"]) == (1, 1, 2), broker.stats
    assert _wait(lambda: train.pending_joins() == (1,), 60, 0.05)
    assert train.resolve(expect={0, 1}).members == (0, 1)
    _ok(passed, "capacity_retired_to_training")
    return {"passed": passed, "stats": dict(broker.stats)}


def _elastic_capacity(rank, tmpdir):
    """``capacity_leave`` and ``capacity_rejoin(trainer)`` on an elastic
    world (see the module docstring)."""
    import os
    import time

    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_checkpointer,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.communicators import (
        FaultInjectionCommunicator, FaultSchedule)
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.dataset import SerialIterator, TupleDataset
    from chainermn_tpu_torch.extensions import ElasticRecovery
    from chainermn_tpu_torch.serving import ReplicaFleet, Request
    from chainermn_tpu_torch.training import StandardUpdater, Trainer
    from chainermn_tpu_torch.training.trainer import Extension
    x, t = _data()
    leave_at = 4
    r = {"passed": []}

    class _ToServing(Exception):
        """This rank moves into the serving fleet (raised after the clean
        leave; its supervisor runs the stint)."""

    class _Convert(Extension):
        trigger = (1, "iteration")
        priority = 450            # before the beacon

        def __init__(self, recovery):
            self.recovery = recovery
            self.fired = False

        def __call__(self, trainer):
            if rank == 1 and not self.fired \
                    and trainer.updater.iteration == leave_at:
                self.fired = True
                r["left_epoch"] = self.recovery.capacity_leave()
                raise _ToServing()

    class _Supervisor(ElasticRecovery):
        """The supervisor of a rank that serves between two stints of
        training: the stint is its recovery."""

        def can_recover(self, exc):
            return isinstance(exc, _ToServing) or super().can_recover(exc)

        def recover(self, trainer, exc):
            if not isinstance(exc, _ToServing):
                return super().recover(trainer, exc)
            epoch = r["left_epoch"]
            assert _wait(lambda: self.membership.current_epoch() != epoch,
                         60)
            r["shrunk_view"] = self.membership.current_view().members
            fleet = ReplicaFleet(engines={rank: _engine()})
            for i in range(2):
                fleet.submit(Request(np.arange(1, 6, dtype=np.int32), 3,
                                     tenant="t", request_id=i))
            fleet.drain()
            r["served"] = sorted(q.request_id for q in fleet.completed)
            r["resumed"] = self.capacity_rejoin(trainer)
            return r["resumed"]

    class _Pacer(Extension):
        trigger = (1, "iteration")
        priority = 350

        def __init__(self, dwell_s):
            self.dwell_s = dwell_s

        def __call__(self, trainer):
            time.sleep(self.dwell_s)

    def run(out, converting):
        comm = create_communicator("jax_ici", device="cpu")
        comm._host_channel()._timeout_ms = int(DETECT_S * 1000)
        comm = FaultInjectionCommunicator(comm, FaultSchedule([]))
        model = _model()
        comm.bcast_data(model)
        opt = create_multi_node_optimizer(
            MomentumSGD(lr=0.05, momentum=0.9), comm).setup(model)
        cp = create_multi_node_checkpointer(comm, name="ec", path=out)
        recovery = _Supervisor(checkpointer=cp, comm=comm,
                               resolve_timeout_ms=90_000, verbose=True)
        sizes = []
        convert = _slicer(recovery)

        def recorded(batch, device=None):
            xb, tb = convert(batch, device)
            sizes.append((recovery.comm.size, int(xb.shape[0])))
            return xb, tb
        it = SerialIterator(TupleDataset(x, t), 8, shuffle=False)
        trainer = Trainer(StandardUpdater(it, opt, converter=recorded),
                          (ITERS, "iteration"), out=out)
        trainer.extend(_beacon(recovery))
        if converting:
            trainer.extend(_Convert(recovery))
            trainer.extend(_Pacer(0.2))
        trainer.extend(cp, trigger=(3, "iteration"))
        trainer.extend(recovery)
        trainer.run()
        with torch.no_grad():
            loss = float(model(torch.from_numpy(x), torch.from_numpy(t)))
        return trainer, recovery, model, loss, sizes

    _, _, _, base_loss, _ = run(os.path.join(tmpdir, "ecbase"), False)
    trainer, recovery, model, loss, sizes = run(
        os.path.join(tmpdir, "ec"), True)
    s = recovery.stats
    r.update(base_loss=base_loss, loss=loss, sizes=sizes,
             stats={k: s[k] for k in ("resizes", "ranks_lost",
                                      "ranks_joined", "recoveries",
                                      "resumed_iterations")},
             final=(trainer.updater.iteration, recovery.view.members,
                    recovery.view.epoch, recovery.comm.size,
                    type(recovery.comm).__name__),
             agreed=recovery.comm.allgather_obj(_digest(model)))
    passed = r["passed"]
    if rank == 1:
        if r["left_epoch"] == 0 and r["shrunk_view"] == (0,):
            _ok(passed, "capacity_leave_clean")
        if r["served"] == [0, 1]:
            _ok(passed, "capacity_served_stint")
        if s["resumed_iterations"] == [r["resumed"]]:
            _ok(passed, "capacity_rejoined_via_snapshot")
    elif set(sizes) == {(2, 4), (1, 8)} \
            and (s["resizes"], s["ranks_lost"], s["ranks_joined"]) \
            == (2, 1, 1):
        _ok(passed, "elastic_shrunk_keeping_batch")
    if r["final"] == (ITERS, (0, 1), 2, 2, "ElasticMeshCommunicator") \
            and r["agreed"][0] == r["agreed"][1] \
            and abs(loss - base_loss) <= BAND * abs(base_loss) + 1e-6:
        _ok(passed, "elastic_capacity_agreed")
    return r


def _worker(rank, tmpdir):
    from chainermn_tpu_torch import create_communicator
    ch = create_communicator("jax_ici", device="cpu")._host_channel()
    ch._timeout_ms = int(DETECT_S * 1000)
    return {"fleet": _fleet(rank, ch), "capacity": _capacity(rank, ch),
            "elastic_capacity": _elastic_capacity(rank, tmpdir)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet_chaos")
    return spawn_ranks(tmp, _worker, world=2, join_s=JOIN_S,
                       tmpdir=str(tmp / "run"))


def _passed(world, scenario):
    return {name for r in world for name in r[scenario]["passed"]}


def test_two_rank_fleet_kill_reroute_and_rejoin(world):
    assert _passed(world, "fleet") == set(FLEET_PASS)
    stats = world[0]["fleet"]["stats"]
    assert stats["sheds"] == 1 and stats["weight_sync_rounds"] == 1
    assert stats["weight_sync_bytes"] > 0
    assert world[0]["fleet"]["detect_s"] >= DETECT_S * 0.9


def test_two_rank_capacity_transfer_chaos(world):
    assert _passed(world, "capacity") == set(CAPACITY_PASS)
    stats = world[0]["capacity"]["stats"]
    assert (stats["conversions"], stats["retires"], stats["aborted"]) \
        == (1, 1, 1)


def test_two_rank_elastic_capacity_leave_and_rejoin(world):
    """The survivor shrinks to {0} at the leave and grows back at the
    rejoin; the converting rank served its stint and came back through
    the snapshot sync; both end together, within the band of the
    uninterrupted run."""
    e0, e1 = world[0]["elastic_capacity"], world[1]["elastic_capacity"]
    assert e1["left_epoch"] == 0 and e1["shrunk_view"] == (0,)
    assert e1["served"] == [0, 1]
    assert e0["stats"]["resizes"] == 2 and e0["stats"]["ranks_lost"] == 1 \
        and e0["stats"]["ranks_joined"] == 1
    assert e0["stats"]["recoveries"] == 1
    # the global batch of 8: halves in the world of two, whole in the
    # survivor's world of one
    assert set(e0["sizes"]) == {(2, 4), (1, 8)}
    # the rank rejoined at the generation the survivor shipped
    assert e1["resumed"] == e0["stats"]["resumed_iterations"][-1] \
        == e1["stats"]["resumed_iterations"][-1]
    for e in (e0, e1):
        assert e["final"] == (ITERS, (0, 1), 2, 2, "ElasticMeshCommunicator")
        assert e["agreed"][0] == e["agreed"][1]
        assert abs(e["loss"] - e["base_loss"]) \
            <= BAND * abs(e["base_loss"]) + 1e-6
    assert _passed(world, "elastic_capacity") == set(ELASTIC_PASS)
