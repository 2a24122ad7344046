"""End-to-end chaos over a real 2-rank gloo world: twins of
``tests/multiprocess_tests``' ``chaos_recovery`` and ``elastic`` scenarios
(``_worker.run_chaos_recovery``, ``_worker.run_elastic``), run one after
the other in one spawned world on a FileStore (the job's store: the
ranks' object channel rides it).  The workers import no JAX.

``chaos_recovery``: an injected collective fault (both ranks, the same
seeded call site), a transient host-channel fault on rank 1 (absorbed by
the bounded retry) and a torn checkpoint write, each recovered through the
consensus resume; the final parameters equal the fault-free run's BITWISE,
and a snapshot corrupted on rank 0 is excluded from a fresh consensus
vote on both ranks.

``elastic``: a seeded rank-targeted ``preempt`` hard-stops rank 1 at
iteration 4; rank 0 detects it through the channel's typed timeout, the
membership protocol shrinks the world to {0} (a new default world of one)
and training goes on solo with the global batch kept; rank 1 parks,
announces its join, is re-admitted, adopts the survivor's newest snapshot
shipped over the members' channel, and the world grows back to {0, 1} at
epoch 2.  The run ends at 24 iterations with the final loss within the
JAX test's +-5 % band of the uninterrupted run (the rollback replays the
same batches, but the world-of-one steps sum the batch in another order),
parameters bit-identical across the regrown world, and a world-of-one
snapshot loaded bit-exact into a 2-rank-shaped trainer.

``silent_exit`` (last, in the world the elastic scenario left): the
JAX elastic workers' communicator, ``create_communicator("jax_ici")``,
under ``ElasticRecovery`` with no fault-injection wrapper, so the object
calls ride the process group.  Rank 1 leaves at iteration 4 without
announcing: its process group goes down, as a crashed process's sockets
close.  Rank 0 sees gloo's ``Connection closed by peer`` or ``Connection
reset by peer`` (a plain ``RuntimeError``), recovers it as the backend's
peer loss, the membership
settles on {0} without rank 1, a world of one is built at epoch 3 after
the old one is torn down, and training finishes its iterations from the
consensus snapshot, the final loss within the same band.

Deadlines: the channel's op timeout is 6 s (the detection), the world's
join deadline 300 s (the three scenarios take ~35 s alone).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_communicator import spawn_ranks

ITERS = 24
BAND = 0.05
JOIN_S = 300


def _data():
    rng = np.random.RandomState(11)
    return (rng.normal(0, 1, (64, 12)).astype(np.float32),
            rng.randint(0, 3, 64).astype(np.int64))


def _model():
    from chainermn_tpu_torch.models import MLP, Classifier
    return Classifier(MLP(n_units=8, n_out=3, seed=0, device="cpu"))


def _slicer(holder):
    """The JAX twins' batch convention: every rank iterates the same
    global batch stream and takes its part of each batch (over the
    current world: ``holder.comm`` follows every resize)."""
    from chainermn_tpu_torch.dataset import concat_examples

    def convert(batch, device=None):
        comm = holder.comm
        x, t = concat_examples(batch, device)
        n = x.shape[0] // comm.size
        lo = comm.rank * n
        return x[lo:lo + n], t[lo:lo + n]
    return convert


def _beacon(holder):
    from chainermn_tpu_torch.training.trainer import Extension

    class _Beacon(Extension):
        """Per-iteration control-plane op over the current world's object
        channel: the fault site, and the survivor's detection site."""
        trigger = (1, "iteration")
        priority = 400

        def __call__(self, trainer):
            out = holder.comm.bcast_obj(
                {"it": trainer.updater.iteration}, root=0)
            assert out["it"] == trainer.updater.iteration
    return _Beacon()


def _digest(model):
    return [p.detach().numpy().tobytes() for p in model.parameters()]


def _chaos_recovery(rank, tmpdir):
    import os
    from types import SimpleNamespace

    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_checkpointer,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.communicators import (
        FaultInjectionCommunicator, FaultSchedule, bind_host_channel)
    from chainermn_tpu_torch.communicators._host_channel import \
        get_host_channel
    from chainermn_tpu_torch.communicators.fault_schedule import \
        InjectedFault
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.dataset import SerialIterator, TupleDataset
    from chainermn_tpu_torch.extensions import FailureRecovery
    from chainermn_tpu_torch.training import StandardUpdater, Trainer
    x, t = _data()
    r = {}

    def run(out, schedule=None, hc_specs=None, write_fault=None):
        comm = create_communicator("jax_ici", device="cpu")
        if hc_specs is not None:
            bind_host_channel(comm._host_channel(),
                              FaultSchedule(hc_specs, seed=1))
        if schedule is not None:
            comm = FaultInjectionCommunicator(comm, schedule)
        holder = SimpleNamespace(comm=comm)
        model = _model()
        opt = create_multi_node_optimizer(
            MomentumSGD(lr=0.05, momentum=0.9), comm).setup(model)
        it = SerialIterator(TupleDataset(x, t), 8, shuffle=False)
        trainer = Trainer(StandardUpdater(it, opt,
                                          converter=_slicer(holder)),
                          (10, "iteration"), out=out)
        trainer.extend(_beacon(holder))
        cp = create_multi_node_checkpointer(comm, name="cz", path=out)
        trainer.extend(cp, trigger=(3, "iteration"))
        recovery = FailureRecovery(checkpointer=cp, verbose=False)
        trainer.extend(recovery)
        if write_fault is not None:
            cp._write_fault_hook = write_fault
        trainer.run()
        comm._host_channel().set_fault_hook(None)
        return trainer, recovery, model

    base = os.path.join(tmpdir, "base")
    b_trainer, b_rec, b_model = run(base)
    r["baseline"] = (b_trainer.updater.iteration,
                     b_rec.stats["recoveries"])

    fired = []

    def write_fault(tmp, fname):
        if ".9." in fname and not fired:
            fired.append(fname)
            raise InjectedFault("checkpoint.save", 1, "torn write")

    chaos = os.path.join(tmpdir, "chaos")
    trainer, recovery, model = run(
        chaos, schedule=FaultSchedule([dict(op="bcast_obj", nth=5)],
                                      seed=1234),
        hc_specs=[dict(op="hc.get", nth=3)] if rank == 1 else [],
        write_fault=write_fault)
    r["recovered"] = (recovery.stats["recoveries"],
                      recovery.stats["resumed_iterations"],
                      recovery.stats["generation_bumps"], bool(fired))
    r["retries"] = get_host_channel().stats["retries"]
    r["final_equal"] = (trainer.updater.iteration == 10
                        and _digest(model) == _digest(b_model))

    if rank == 0:   # tear rank 0's newest snapshot only
        with open(os.path.join(chaos, "cz.9.0"), "r+b") as f:
            f.seek(12)
            f.write(b"\xde\xad\xbe\xef")
    comm2 = create_communicator("jax_ici", device="cpu")
    comm2._host_channel().barrier()   # the tear is durable before the vote
    model2 = _model()
    opt2 = create_multi_node_optimizer(
        MomentumSGD(lr=0.05, momentum=0.9), comm2).setup(model2)
    it2 = SerialIterator(TupleDataset(x, t), 8, shuffle=False)
    trainer2 = Trainer(StandardUpdater(it2, opt2), (10, "iteration"),
                       out=os.path.join(tmpdir, f"resume{rank}"))
    cp2 = create_multi_node_checkpointer(comm2, name="cz", path=chaos)
    r["corrupt"] = (cp2.maybe_load(trainer2, path=chaos),
                    trainer2.updater.iteration,
                    cp2.stats["verify_failures"])
    comm2.finalize()
    return r


def _elastic(rank, tmpdir):
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
    from chainermn_tpu_torch.serializers.npz import load_npz
    from chainermn_tpu_torch.training import StandardUpdater, Trainer
    from chainermn_tpu_torch.training.trainer import Extension
    x, t = _data()
    r = {}

    class _Pacer(Extension):
        """Slows the loop so that the parked rank's rejoin lands mid-run."""
        trigger = (1, "iteration")
        priority = 350

        def __init__(self, dwell_s):
            self.dwell_s = dwell_s

        def __call__(self, trainer):
            if self.dwell_s:
                time.sleep(self.dwell_s)

    def run(out, schedule=None, pace_s=0.0):
        comm = create_communicator("jax_ici", device="cpu")
        comm._host_channel()._timeout_ms = 6000   # detection in seconds
        if schedule is not None:
            comm = FaultInjectionCommunicator(comm, schedule)
        model = _model()
        comm.bcast_data(model)
        opt = create_multi_node_optimizer(
            MomentumSGD(lr=0.05, momentum=0.9), comm).setup(model)
        cp = create_multi_node_checkpointer(comm, name="el", path=out)
        recovery = ElasticRecovery(checkpointer=cp, comm=comm,
                                   rejoin_after_s=2.0,
                                   resolve_timeout_ms=90_000, verbose=True)
        it = SerialIterator(TupleDataset(x, t), 8, shuffle=False)
        trainer = Trainer(StandardUpdater(it, opt,
                                          converter=_slicer(recovery)),
                          (ITERS, "iteration"), out=out)
        trainer.extend(_beacon(recovery))
        trainer.extend(_Pacer(pace_s))
        trainer.extend(cp, trigger=(3, "iteration"))
        trainer.extend(recovery)
        trainer.run()
        return trainer, recovery, model

    def full_loss(model):
        with torch.no_grad():
            return float(model(torch.from_numpy(x), torch.from_numpy(t)))

    b_trainer, b_rec, b_model = run(os.path.join(tmpdir, "ebase"))
    r["baseline"] = (b_trainer.updater.iteration, b_rec.stats["resizes"],
                     full_loss(b_model))

    # beacon and join poll make two bcast_obj calls an iteration: call #7
    # is iteration 4's beacon
    sched = FaultSchedule([dict(op="bcast_obj", nth=7, action="preempt",
                                rank=1)], seed=99)
    el_out = os.path.join(tmpdir, "elastic")
    trainer, recovery, model = run(el_out, schedule=sched, pace_s=0.25)
    s = recovery.stats
    r["stats"] = {k: s[k] for k in ("resizes", "ranks_lost", "ranks_joined",
                                    "recoveries")}
    r["final"] = (trainer.updater.iteration, recovery.view.members,
                  recovery.view.epoch, recovery.comm.size,
                  type(recovery.comm).__name__)
    r["agreed"] = recovery.comm.allgather_obj(_digest(model))
    r["loss"] = full_loss(model)

    # a world-of-one snapshot of the solo phase, loaded into a 2-rank
    # shaped trainer and into a plain one: the same bytes
    comm2 = create_communicator("jax_ici", device="cpu")
    m2 = _model()
    comm2.bcast_data(m2)
    opt2 = create_multi_node_optimizer(
        MomentumSGD(lr=0.05, momentum=0.9), comm2).setup(m2)
    t2 = Trainer(StandardUpdater(SerialIterator(TupleDataset(x, t), 8,
                                                shuffle=False), opt2),
                 (ITERS, "iteration"),
                 out=os.path.join(tmpdir, f"xsize{rank}"))
    if rank == 0:
        solo = sorted(int(f.split(".")[1]) for f in os.listdir(el_out)
                      if f.startswith("el.") and f.endswith(".0")
                      and not os.path.exists(os.path.join(
                          el_out, f"el.{f.split('.')[1]}.1")))
        pick = solo[-1]
        load_npz(os.path.join(el_out, f"el.{pick}.0"), t2, strict=False)
        m1 = _model()
        opt1 = MomentumSGD(lr=0.05, momentum=0.9).setup(m1)
        t1 = Trainer(StandardUpdater(SerialIterator(TupleDataset(x, t), 8,
                                                    shuffle=False), opt1),
                     (ITERS, "iteration"),
                     out=os.path.join(tmpdir, "xsize1p"))
        load_npz(os.path.join(el_out, f"el.{pick}.0"), t1, strict=False)
        sa, sb = opt2.actual_optimizer.state_leaves(), opt1.state_leaves()
        r["xsize"] = (pick, t2.updater.iteration,
                      _digest(m2) == _digest(m1),
                      len(sa) == len(sb) > 0
                      and all(np.array_equal(a, b) for a, b in zip(sa, sb)))
    comm2.finalize()
    return r


def _finalize_waits_for_sends(rank):
    """``finalize`` waits for the point-to-point sends still in flight
    (a send never waits): rank 1 sends and finalizes at once, rank 0
    receives a second later; torn down under it, the send would be lost
    and rank 0 would fail on a closed connection."""
    import time

    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.functions import recv, send
    comm = create_communicator("jax_ici", device="cpu")
    both = comm.split(color=0, key=rank)
    if rank == 1:
        send(torch.arange(5.0), both, 0)
        t0 = time.monotonic()
        both.finalize()
        return time.monotonic() - t0
    time.sleep(1.0)
    got = recv(both, 1)
    both.finalize()
    return got


def _object_paths(rank):
    """A communicator's object calls go over the process group and leave
    the host channel untouched; the fault-injection wrapper sends them
    over the wrapped communicator's host channel."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.communicators import (
        FaultInjectionCommunicator, FaultSchedule)
    comm = create_communicator("jax_ici", device="cpu")
    ch = comm._host_channel()

    def calls(c):
        if rank == 0:                # the process group's send blocks
            c.send_obj(("to", 1), 1)
            got = c.recv_obj(1)
        else:
            got = c.recv_obj(0)
            c.send_obj(("to", 0), 0)
        return (got, c.bcast_obj({"root": rank}, root=1),
                c.allgather_obj(rank), c.gather_obj(rank * 10))

    def channel_state():
        return (ch._epoch, dict(ch._send_seq), dict(ch._recv_seq))
    before = channel_state()
    plain = calls(comm)
    after_plain = channel_state()
    wrapped = calls(FaultInjectionCommunicator(comm, FaultSchedule([])))
    return {"plain": plain, "wrapped": wrapped,
            "plain_channel": (before, after_plain),
            "wrapped_channel": channel_state()}


def _silent_exit(rank, tmpdir):
    """A peer that exits without announcing, under ``ElasticRecovery``
    over a plain communicator (see the module docstring).  Rank 1 returns
    as soon as its process group is down: the world's last item."""
    import os

    import torch.distributed as dist

    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_checkpointer,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.dataset import SerialIterator, TupleDataset
    from chainermn_tpu_torch.extensions import ElasticRecovery
    from chainermn_tpu_torch.training import StandardUpdater, Trainer
    from chainermn_tpu_torch.training.trainer import Extension
    x, t = _data()

    class _Vanish(Exception):
        """Rank 1's exit: no recovery extension can recover it."""

    class _Leave(Extension):
        trigger = (1, "iteration")
        priority = 450            # before the beacon

        def __call__(self, trainer):
            if rank == 1 and trainer.updater.iteration == 4:
                raise _Vanish()

    comm = create_communicator("jax_ici", device="cpu")
    model = _model()
    comm.bcast_data(model)
    opt = create_multi_node_optimizer(
        MomentumSGD(lr=0.05, momentum=0.9), comm).setup(model)
    out = os.path.join(tmpdir, "silent")
    cp = create_multi_node_checkpointer(comm, name="sx", path=out)
    causes = []
    recovery = ElasticRecovery(
        checkpointer=cp, comm=comm, resolve_timeout_ms=60_000,
        verbose=True,
        on_recover=lambda trainer, exc, resumed: causes.append(
            (type(exc).__name__, str(exc), resumed)))
    it = SerialIterator(TupleDataset(x, t), 8, shuffle=False)
    trainer = Trainer(StandardUpdater(it, opt,
                                      converter=_slicer(recovery)),
                      (ITERS, "iteration"), out=out)
    trainer.extend(_Leave())
    trainer.extend(_beacon(recovery))
    trainer.extend(cp, trigger=(3, "iteration"))
    trainer.extend(recovery)
    try:
        trainer.run(show_loop_exception_msg=False)
    except _Vanish:
        dist.destroy_process_group()
        return {"left_at": trainer.updater.iteration}
    with torch.no_grad():
        loss = float(model(torch.from_numpy(x), torch.from_numpy(t)))
    s = recovery.stats
    return {"causes": causes,
            "stats": {k: s[k] for k in ("recoveries", "resizes",
                                        "ranks_lost", "ranks_joined")},
            "final": (trainer.updater.iteration, recovery.view.members,
                      recovery.view.epoch, recovery.comm.size,
                      type(recovery.comm).__name__,
                      dist.get_world_size()),
            "loss": loss}


def _worker(rank, tmpdir):
    return {"objects": _object_paths(rank),
            "finalize": _finalize_waits_for_sends(rank),
            "chaos": _chaos_recovery(rank, tmpdir),
            "elastic": _elastic(rank, tmpdir),
            "silent_exit": _silent_exit(rank, tmpdir)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chaos")
    return spawn_ranks(tmp, _worker, world=2, join_s=JOIN_S,
                       tmpdir=str(tmp / "run"))


def test_object_calls_ride_the_channel_only_where_asked(world):
    for rank, r in enumerate(world):
        o = r["objects"]
        want = (("to", rank), {"root": 1}, [0, 1], [0, 10])
        assert o["plain"] == o["wrapped"] == want
        before, after = o["plain_channel"]
        assert before == after == (0, {}, {})
        epoch, sent, received = o["wrapped_channel"]
        assert epoch == 3        # bcast, allgather and gather: one each
        assert sent == {(1 - rank, 0): 1} and received == sent


def test_finalize_waits_for_sends_in_flight(world):
    assert torch.equal(world[0]["finalize"], torch.arange(5.0))
    assert world[1]["finalize"] > 0.5   # it waited for rank 0's receive


def test_two_rank_chaos_recovery(world):
    for rank, r in enumerate(world):
        c = r["chaos"]
        assert c["baseline"] == (10, 0)
        recoveries, resumed, bumps, fired = c["recovered"]
        assert (recoveries, resumed, fired) == (2, [3, 6], True)
        assert bumps == 2            # the channel's generation, per recovery
        if rank == 1:
            assert c["retries"] >= 1   # the transient hc.get was absorbed
        assert c["final_equal"]
        resumed, iteration, failures = c["corrupt"]
        assert resumed == 6 and iteration == 6
        if rank == 0:
            assert failures == 1


def test_two_rank_elastic_preempt_shrink_rejoin_grow(world):
    base_loss = world[0]["elastic"]["baseline"][2]
    for rank, r in enumerate(world):
        e = r["elastic"]
        assert e["baseline"][:2] == (ITERS, 0)
        want = dict(resizes=2, ranks_lost=1) if rank == 0 \
            else dict(resizes=1, ranks_lost=0)
        assert e["stats"] == dict(want, ranks_joined=1, recoveries=1)
        assert e["final"] == (ITERS, (0, 1), 2, 2, "ElasticMeshCommunicator")
        assert e["agreed"][0] == e["agreed"][1]
        assert abs(e["loss"] - base_loss) <= BAND * abs(base_loss) + 1e-6
    pick, iteration, params_equal, state_equal = world[0]["elastic"]["xsize"]
    assert iteration == pick and params_equal and state_equal


def test_survivor_recovers_a_peer_that_exits_without_announcing(world):
    """C6: the survivor of a silent exit over a plain communicator
    recovers gloo's closed connection to a world of one and finishes."""
    assert world[1]["silent_exit"] == {"left_at": 4}
    r = world[0]["silent_exit"]
    (cause, message, resumed), = r["causes"]
    # which of gloo's two texts depends on whether rank 1 left a beacon
    # byte unread (its socket then resets)
    assert cause == "RuntimeError" and any(
        m in message for m in ("Connection closed by peer",
                               "Connection reset by peer"))
    assert resumed == 3               # the consensus snapshot before the exit
    assert r["stats"] == dict(recoveries=1, resizes=1, ranks_lost=1,
                              ranks_joined=0)
    # the elastic scenario left epoch 2; the shrink decides epoch 3
    assert r["final"] == (ITERS, (0,), 3, 1, "ElasticMeshCommunicator", 1)
    base_loss = world[0]["elastic"]["baseline"][2]
    assert abs(r["loss"] - base_loss) <= BAND * abs(base_loss) + 1e-6


def test_backend_peer_loss_is_recoverable_only_over_a_plain_communicator():
    """The backend's peer-loss errors count with the default
    ``recoverable`` while the communicator is not elastic; any other
    ``RuntimeError`` never does."""
    import torch.distributed as dist

    from chainermn_tpu_torch.communicators import ElasticMeshCommunicator
    from chainermn_tpu_torch.extensions import ElasticRecovery
    from chainermn_tpu_torch.extensions.elastic import backend_peer_lost
    closed = RuntimeError("[pair.cc:553] Connection closed by peer [::1]:1")
    reset = RuntimeError("[pair.cc:537] Read error [::1]:1: Connection "
                         "reset by peer")
    typed = [dist.DistBackendError("watchdog"), dist.DistNetworkError("x")]
    other = RuntimeError("CUDA out of memory")
    assert all(backend_peer_lost(e) for e in [closed, reset] + typed)
    assert not backend_peer_lost(other)
    recovery = ElasticRecovery(verbose=False)
    recovery.comm = object()               # a plain communicator
    assert recovery.can_recover(closed) and recovery.can_recover(reset)
    assert not recovery.can_recover(other)
    recovery.comm = ElasticMeshCommunicator.__new__(ElasticMeshCommunicator)
    assert not recovery.can_recover(closed)
    explicit = ElasticRecovery(verbose=False, recoverable=(ValueError,))
    explicit.comm = object()
    assert not explicit.can_recover(closed)
