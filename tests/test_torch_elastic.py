"""The port's elastic machinery against the JAX package's
(``tests/resilience_tests/test_elastic.py``).

* The membership protocol: a JAX and a port ``ElasticMembership`` over ONE
  shared in-memory KV decide the same views (shrink by announced leave,
  grow by join, the typed timeout, the lone-joiner guard), and the port's
  twins run over ``StoreKV`` on a ``HashStore`` as well.
* ``global_batch_plan``'s table and ``rescatter_dataset``'s index sets
  against the JAX functions.
* One spawned 4-rank gloo world (FileStore): ``change_communicator``
  re-seeding the double-buffered gradient and the quantized wire's
  residual, re-committing the sharded state in memory (losses against one
  process on the whole batch, and the JAX ``MomentumSGD`` run, 1e-5
  relative as the JAX test: a two-rank mean of half-batch gradients
  against one full-batch mean), dropping it under ``via_checkpoint``, and
  refusing a striped-layout change without it; a per-rank DCP snapshot
  written by 2 ranks resumed at 1 and at 4 (the whole flat state and the
  parameters BITWISE: the resume only moves bytes); and the membership
  protocol over the job's store deciding a shrink to {0, 1, 2}, onto which
  an ``ElasticMeshCommunicator`` is built (a new default world of 3).
"""

import threading

import numpy as np
import pytest
import torch

from chainermn_tpu_torch.communicators import (ElasticMembership,
                                               MembershipView,
                                               multicast_tree_plan)
from chainermn_tpu_torch.communicators._host_channel import (
    ChannelTimeoutError, StoreKV)
from chainermn_tpu_torch.extensions import (ElasticConfigError,
                                            RecoveryGivingUp,
                                            global_batch_plan)
from tests.test_torch_communicator import spawn_ranks

LOSS_RTOL = 1e-5
WORLD = 4


def _kv(kind):
    import torch.distributed as dist
    from tests.resilience_tests.test_elastic import KV
    return KV() if kind == "fake" else StoreKV(dist.HashStore())


def _member(cls, kv, rank, world=2, **kw):
    kw.setdefault("settle_s", 0.05)
    kw.setdefault("poll_s", 0.002)
    kw.setdefault("timeout_ms", 4000)
    return cls(kv, rank=rank, world=world, **kw)


def _classes(mix):
    """(rank 0's class, rank 1's class): the JAX and the port membership
    side by side on one store, or the port's alone."""
    from chainermn_tpu.communicators import ElasticMembership as Jax
    return {"jax0-port1": (Jax, ElasticMembership),
            "port0-jax1": (ElasticMembership, Jax),
            "port": (ElasticMembership, ElasticMembership)}[mix]


def _view(v):
    return (v.epoch, v.members, v.role)


@pytest.mark.parametrize("mix", ["jax0-port1", "port0-jax1", "port"])
def test_shrink_and_grow_decide_the_same_views(mix):
    c0, c1 = _classes(mix)
    kv = _kv("fake")
    m0, m1 = _member(c0, kv, 0), _member(c1, kv, 1)
    assert _view(m0.current_view()) == _view(m1.current_view()) \
        == (0, (0, 1), "elastic")
    m1.announce_leave(note="preempted")
    v = m0.resolve(expect={0})
    assert _view(v) == (1, (0,), "elastic")
    assert _view(m1.current_view()) == _view(v)
    m1.announce_join()
    assert m0.pending_joins() == (1,)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        1, m1.resolve(expect={0, 1}, require={0})))
    t.start()
    out[0] = m0.resolve(expect={0, 1})
    t.join()
    assert _view(out[0]) == _view(out[1]) == (2, (0, 1), "elastic")
    assert m0.pending_joins() == () and m1.pending_joins() == ()
    assert m0.read_tree_plan() == m1.read_tree_plan() \
        == multicast_tree_plan((0, 1))
    assert sorted(kv.store) == sorted(_keys_of(mix))


def _keys_of(mix):
    """The store's keys after the arc above, read from a JAX-only run:
    the two packages write the same keys."""
    from chainermn_tpu.communicators import ElasticMembership as Jax
    kv = _kv("fake")
    m0, m1 = _member(Jax, kv, 0), _member(Jax, kv, 1)
    m1.announce_leave(note="preempted")
    m0.resolve(expect={0})
    m1.announce_join()
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        1, m1.resolve(expect={0, 1}, require={0})))
    t.start()
    m0.resolve(expect={0, 1})
    t.join()
    return kv.store


@pytest.mark.parametrize("kind", ["fake", "hash"])
def test_membership_twins(kind):
    kv = _kv(kind)
    m0 = _member(ElasticMembership, kv, 0)
    m1 = _member(ElasticMembership, kv, 1)
    # epochs append-only and monotone across resolves
    m1.announce_leave()
    assert [m0.resolve(expect={0}).epoch for _ in range(3)] == [1, 2, 3]
    assert _member(ElasticMembership, kv, 0).current_epoch() == 3
    # a join retracts a standing leave
    m1.announce_leave()
    m1.announce_join()
    assert m0.pending_joins() == (1,)
    # a lone joiner cannot settle a world by itself: typed timeout
    with pytest.raises(ChannelTimeoutError) as e:
        m1.resolve(expect={0, 1}, require={0}, timeout_ms=300)
    assert e.value.op == "membership.resolve"


@pytest.mark.parametrize("kind", ["fake", "hash"])
def test_zombie_screen_and_adopting_an_excluding_view(kind):
    kv = _kv(kind)
    kv.key_value_set("cmn/elastic/e1/present/1", "99")   # frozen token
    v = _member(ElasticMembership, kv, 0).resolve()
    assert v.members == (0,)
    kv2 = _kv(kind)
    kv2.key_value_set("cmn/elastic/e1/view", "0")        # decided without 1
    adopted = _member(ElasticMembership, kv2, 1).resolve()
    assert adopted == MembershipView(1, (0,)) and 1 not in adopted


def test_global_batch_plan_table():
    from chainermn_tpu.extensions import global_batch_plan as jplan
    for g in (1, 8, 12, 24, 64, 96):
        for w in (1, 2, 3, 4, 8):
            for policy in ("rescale", "accumulate"):
                for cap in (None, 2, 8):
                    try:
                        want = jplan(g, w, policy=policy, max_per_rank=cap)
                    except Exception as e:  # noqa: BLE001
                        with pytest.raises(Exception) as mine:
                            global_batch_plan(g, w, policy=policy,
                                              max_per_rank=cap)
                        assert type(mine.value).__name__ \
                            == type(e).__name__
                        assert str(mine.value) == str(e)
                        continue
                    assert global_batch_plan(
                        g, w, policy=policy, max_per_rank=cap) == want
    with pytest.raises(ElasticConfigError):
        global_batch_plan(12, 8)
    with pytest.raises(ValueError):
        global_batch_plan(8, 2, policy="bogus")


class _Topology:
    """A communicator's topology: the JAX rescatter splits by host
    (``inter_*``), the port's by rank; one process per host makes them
    the same split."""

    def __init__(self, size, rank):
        self.size = self.inter_size = size
        self.rank = self.inter_rank = rank

    def allgather_obj(self, obj):
        return [obj] * self.size


@pytest.mark.parametrize("n,old,new", [(21, 2, 1), (21, 2, 4), (16, 4, 3),
                                       (9, 3, 2)])
def test_rescatter_dataset_index_sets(n, old, new):
    import chainermn_tpu as jct
    import chainermn_tpu_torch as ct
    data = list(range(n))
    for shuffle in (False, True):
        shard = ct.scatter_dataset(data, _Topology(old, 0), shuffle=shuffle,
                                   seed=5)
        jshard = jct.scatter_dataset(data, _Topology(old, 0),
                                     shuffle=shuffle, seed=5)
        assert [shard[i] for i in range(len(shard))] \
            == [jshard[i] for i in range(len(jshard))]
        seen = []
        for r in range(new):
            mine = ct.rescatter_dataset(shard, _Topology(new, r))
            ref = jct.rescatter_dataset(jshard, _Topology(new, r))
            got = [mine[i] for i in range(len(mine))]
            assert got == [ref[i] for i in range(len(ref))]
            seen += got
        # the union is the data; only the wrap-around pad repeats
        assert set(seen) == set(data)
        assert len(seen) == -(-n // new) * new
        assert len(seen) - len(set(seen)) == -(-n // new) * new - n
    with pytest.raises(TypeError):
        ct.rescatter_dataset(data, _Topology(1, 0))


def test_giving_up_message_carries_last_view():
    err = RecoveryGivingUp("budget exhausted (3/3)",
                           membership=MembershipView(4, (0, 2, 3)))
    assert "epoch 4" in str(err) and "members [0, 2, 3]" in str(err)
    assert "membership" not in str(RecoveryGivingUp("budget"))


# -- the 4-rank world ---------------------------------------------------------

def _data(n=16, d=12, k=3, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 1, (n, d)).astype(np.float32),
            rng.randint(0, k, n).astype(np.int64))


def _model():
    from chainermn_tpu_torch.models import MLP, Classifier
    return Classifier(MLP(n_units=16, n_out=3, seed=0, device="cpu"))


def _half(x, comm):
    n = x.shape[0] // comm.size
    return torch.from_numpy(x[comm.rank * n:(comm.rank + 1) * n])


def _recommit(comm, pair, solo):
    """Sharded MomentumSGD: 2 steps on the pair (half batches), then a
    swap to this rank alone (the pair's world still up: the whole state
    is gathered over it) and 2 steps on the whole batch."""
    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    x, t = _data()
    model = _model()
    opt = create_multi_node_optimizer(MomentumSGD(lr=0.1, momentum=0.9),
                                      pair, exchange="reduce_scatter"
                                      ).setup(model)
    losses = [float(opt.update(model, _half(x, pair), _half(t, pair)))
              for _ in range(2)]
    opt.change_communicator(solo)
    n, n_pad, lo, hi = opt._flat_layout()    # this rank alone holds it
    assert (lo, hi) == (0, n_pad) and opt._pending is None
    losses += [float(opt.update(model, torch.from_numpy(x),
                                torch.from_numpy(t))) for _ in range(2)]
    return losses


def _reseed(comm, rank):
    """Double buffering and the int8 wire's residual re-seed at a swap;
    the sharded state drops under via_checkpoint; a striped-layout change
    needs it."""
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    x, t = _data()
    out = {}
    q = create_communicator("pure_nccl", device="cpu",
                            allreduce_grad_dtype="int8")
    qpair = q.split(color=rank // 2, key=rank)
    solo = q.split(color=rank, key=0)
    model = _model()
    opt = create_multi_node_optimizer(MomentumSGD(lr=0.1, momentum=0.9),
                                      qpair, double_buffering=True
                                      ).setup(model)
    for _ in range(2):
        opt.update(model, _half(x, qpair), _half(t, qpair))
    out["before"] = (opt._pending is not None, opt._residual is not None)
    opt.change_communicator(solo)
    out["after"] = (opt._pending, opt._stale, opt._residual, opt._obs_plan)
    out["finite"] = bool(np.isfinite(float(opt.update(
        model, torch.from_numpy(x), torch.from_numpy(t)))))
    out["residual_len"] = opt._residual.numel()

    model = _model()
    opt = create_multi_node_optimizer(MomentumSGD(lr=0.1), qpair,
                                      zero_sharding=True).setup(model)
    opt.update(model, _half(x, qpair), _half(t, qpair))
    opt.change_communicator(solo, via_checkpoint=True)
    out["dropped"] = opt.actual_optimizer._state == {}

    striped = create_communicator("hierarchical", device="cpu",
                                  intra_size=2, inter_size=2,
                                  stripe_ratio=0.5)
    model = _model()
    opt = create_multi_node_optimizer(MomentumSGD(lr=0.1), striped,
                                      exchange="reduce_scatter"
                                      ).setup(model)
    opt.update(model, _half(x, striped), _half(t, striped))
    flat = striped.split(color=0, key=rank)
    try:
        opt.change_communicator(flat)
        out["striped"] = None
    except RuntimeError as e:
        out["striped"] = str(e)
    opt.change_communicator(flat, via_checkpoint=True)
    out["striped_dropped"] = opt.actual_optimizer._state == {}
    for c in (flat, striped, solo, qpair):
        c.finalize()
    return out


def _dcp_trainer(comm, out):
    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.dataset import SerialIterator, TupleDataset
    from chainermn_tpu_torch.extensions import \
        create_multi_node_orbax_checkpointer
    from chainermn_tpu_torch.training import StandardUpdater, Trainer
    x, t = _data(n=32)
    model = _model()
    opt = create_multi_node_optimizer(Adam(alpha=1e-2), comm,
                                      zero_sharding=True).setup(model)
    n = len(x) // comm.size
    lo = comm.rank * n
    it = SerialIterator(TupleDataset(x[lo:lo + n], t[lo:lo + n]),
                        16 // comm.size, shuffle=False)
    trainer = Trainer(StandardUpdater(it, opt), (3, "iteration"), out=out)
    cp = create_multi_node_orbax_checkpointer(comm, out + "/dcp")
    trainer.extend(cp, trigger=(3, "iteration"))
    return model, opt, trainer, cp


def _whole_state(opt, model):
    leaves = opt._save_flat_state()
    return ([np.asarray(v) for v in leaves],
            {p: v.detach().clone() for p, v in model.namedparams()})


def _dcp_reshard(comm, rank, pair, out):
    """A per-rank DCP snapshot written by the pair {0, 1} (sharded Adam,
    3 steps), resumed by each rank alone and by the world of 4."""
    r = {}
    if rank < 2:
        model, opt, trainer, cp = _dcp_trainer(pair, out)
        trainer.run()
        r["written"] = _whole_state(opt, model)
    comm.allgather_obj(None)                 # the snapshot is on disk
    solo = comm.split(color=rank, key=0)
    model, opt, trainer, cp = _dcp_trainer(solo, out)
    r["at1"] = cp.maybe_load(trainer)
    r["at1_state"] = _whole_state(opt, model)
    r["at1_iteration"] = trainer.updater.iteration
    solo.finalize()
    model, opt, trainer, cp = _dcp_trainer(comm, out)
    r["at4"] = cp.maybe_load(trainer)
    r["at4_state"] = _whole_state(opt, model)
    r["at4_chunk"] = opt._flat_layout()
    return r


def _dcp_striped(comm, rank, out):
    """A per-rank DCP snapshot of the striped sharded update written at a
    2 x 2 split, resumed at a 1 x 4 split of the same world: every rank's
    two chunks (fast-hop-major and slow-hop-major) move."""
    from chainermn_tpu_torch import create_communicator
    r = {}
    c22 = create_communicator("hierarchical", device="cpu", intra_size=2,
                              inter_size=2, stripe_ratio=0.5)
    model, opt, trainer, cp = _dcp_trainer(c22, out)
    trainer.run()
    r["written"] = _whole_state(opt, model)
    r["chunks22"] = (c22.chunk_index, c22.striped_chunk_index)
    c22.finalize()
    c14 = create_communicator("hierarchical", device="cpu", intra_size=1,
                              inter_size=4, stripe_ratio=0.5)
    model, opt, trainer, cp = _dcp_trainer(c14, out)
    r["resumed"] = cp.maybe_load(trainer)
    r["state"] = _whole_state(opt, model)
    r["chunks14"] = (c14.chunk_index, c14.striped_chunk_index)
    c14.finalize()
    return r


def _elastic_world(comm, rank):
    """The membership protocol over the job's store decides a shrink to
    {0, 1, 2} (rank 3 announces its leave), and the members build the
    elastic communicator on it: a new default world of 3."""
    import torch.distributed as dist
    from chainermn_tpu_torch.communicators import ElasticMeshCommunicator
    from chainermn_tpu_torch.extensions import create_elastic_membership
    r = {}
    m = create_elastic_membership(comm, settle_s=0.5, poll_s=0.01,
                                  timeout_ms=60_000)
    r["boot"] = _view(m.current_view())
    channel = comm._host_channel()
    if rank == 3:
        m.announce_leave(note="preempted")
        comm.allgather_obj(None)             # the leave is posted first
        try:
            ElasticMeshCommunicator((0, 1, 2), epoch=1, channel=channel,
                                    device="cpu")
        except ValueError as e:
            r["refused"] = str(e)
        return r
    comm.allgather_obj(None)
    view = m.resolve(expect={0, 1, 2})
    r["view"] = _view(view)
    el = ElasticMeshCommunicator(view.members, epoch=view.epoch,
                                 channel=channel, device="cpu")
    r["topology"] = (el.size, el.rank, el.stable_rank, el.members, el.epoch,
                     dist.get_world_size())
    r["allreduce"] = el.allreduce(torch.tensor([float(rank + 1)]))
    r["bcast_obj"] = el.bcast_obj({"from": rank}, root=2)
    r["allgather_obj"] = el.allgather_obj(rank)
    r["members_channel"] = (el._host_channel()._ns,
                            el._host_channel().process_id,
                            el._host_channel().num_processes)
    same = el.retuned({"bucket_mb": 1.0})    # a plan changing nothing
    r["retuned_same"] = same is el
    el.finalize()
    return r


def _worker(rank, out):
    from chainermn_tpu_torch import create_communicator
    comm = create_communicator("jax_ici", device="cpu")
    pair = comm.split(color=rank // 2, key=rank)
    solo = comm.split(color=rank, key=0)
    r = {"recommit": _recommit(comm, pair, solo)}
    solo.finalize()
    r["reseed"] = _reseed(comm, rank)
    r["dcp"] = _dcp_reshard(comm, rank, pair, out)
    pair.finalize()
    r["striped"] = _dcp_striped(comm, rank, out + "/striped")
    r["elastic"] = _elastic_world(comm, rank)
    return r


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    return spawn_ranks(tmp, _worker, world=WORLD, out=str(tmp / "run"))


def _golden_losses():
    """One process on the whole batch, 4 MomentumSGD steps: the port's
    plain optimizer and the JAX package's."""
    import chainermn_tpu as jct
    import jax.numpy as jnp
    from chainermn_tpu.core.optimizer import MomentumSGD as JMomentum
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    x, t = _data()
    model = _model()
    opt = MomentumSGD(lr=0.1, momentum=0.9).setup(model)
    port = [opt.update(model, torch.from_numpy(x),
                       torch.from_numpy(t)).item() for _ in range(4)]
    jm = jct.models.Classifier(jct.models.MLP(n_units=16, n_out=3, seed=0))
    jopt = JMomentum(lr=0.1, momentum=0.9).setup(jm)
    jax = [float(jopt.update(jm, jnp.asarray(x), jnp.asarray(t.astype(
        np.int32)))) for _ in range(4)]
    return port, jax


def test_change_communicator_recommits_sharded_state(world):
    port, jax = _golden_losses()
    for r in world:
        np.testing.assert_allclose(r["recommit"], port, rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["recommit"], jax, rtol=LOSS_RTOL)


def test_change_communicator_reseeds_and_drops(world):
    for r in world:
        s = r["reseed"]
        assert s["before"] == (True, True)
        assert s["after"] == (None, None, None, None)
        assert s["finite"] and s["residual_len"] > 0
        assert s["dropped"] and s["striped_dropped"]
        assert "striped-layout change" in s["striped"]


def test_per_rank_dcp_snapshot_resumes_at_1_and_4(world):
    written = world[0]["dcp"]["written"]
    assert np.array_equal(written[0][0], world[1]["dcp"]["written"][0][0])
    for rank, r in enumerate(world):
        d = r["dcp"]
        assert d["at1"] == d["at4"] == 3 and d["at1_iteration"] == 3
        for key in ("at1_state", "at4_state"):
            leaves, params = d[key]
            assert len(leaves) == len(written[0])
            for a, b in zip(leaves, written[0]):
                # whole vectors, each padded for its own world size
                a, b = a.reshape(-1), b.reshape(-1)
                m = min(a.size, b.size)
                assert np.array_equal(a[:m], b[:m]), (rank, key)
                assert not a[m:].any() and not b[m:].any()
            for p, v in written[1].items():
                assert torch.equal(params[p], v), (rank, key, p)
    # at 4 ranks the chunks are new: 4 of ceil(n / 4)
    n, n_pad, lo, hi = world[2]["dcp"]["at4_chunk"]
    assert n_pad % 4 == 0 and (lo, hi) == (2 * n_pad // 4, 3 * n_pad // 4)


def _same_state(got, want):
    leaves, params = got
    assert len(leaves) == len(want[0])
    for a, b in zip(leaves, want[0]):
        a, b = np.asarray(a).reshape(-1), np.asarray(b).reshape(-1)
        m = min(a.size, b.size)
        assert np.array_equal(a[:m], b[:m])
        assert not a[m:].any() and not b[m:].any()
    for p, v in want[1].items():
        assert torch.equal(params[p], v), p


def test_striped_per_rank_snapshot_resumes_at_another_split(world):
    # ranks 1 and 2 swap their fast-hop-major chunks: they read theirs
    # from the writers'; ranks 0 and 3 keep theirs
    moved = [r["striped"]["chunks22"] != r["striped"]["chunks14"]
             for r in world]
    assert moved == [False, True, True, False]
    for r in world:
        assert r["striped"]["resumed"] == 3
        _same_state(r["striped"]["state"], world[0]["striped"]["written"])


def test_membership_shrink_builds_an_elastic_world(world):
    for rank, r in enumerate(world):
        e = r["elastic"]
        assert e["boot"] == (0, (0, 1, 2, 3), "elastic")
        if rank == 3:
            assert "not in the elastic view" in e["refused"]
            continue
        assert e["view"] == (1, (0, 1, 2), "elastic")
        assert e["topology"] == (3, rank, rank, (0, 1, 2), 1, 3)
        assert torch.equal(e["allreduce"], torch.tensor([6.0]))
        assert e["bcast_obj"] == {"from": 2}
        assert e["allgather_obj"] == [0, 1, 2]
        assert e["members_channel"] == ("cmn/el1", rank, 3)
        assert e["retuned_same"]


# -- the supervisor in a world of one (in this process) -------------------------

def _one_rank_trainer(comm, out, checkpoint=True):
    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.dataset import SerialIterator, TupleDataset
    from chainermn_tpu_torch.extensions import \
        create_multi_node_orbax_checkpointer
    from chainermn_tpu_torch.training import StandardUpdater, Trainer
    x, t = _data(n=32)
    model = _model()
    adam = Adam(alpha=1e-2)
    adam.seed = 0
    opt = create_multi_node_optimizer(adam, comm,
                                      zero_sharding=True).setup(model)
    trainer = Trainer(StandardUpdater(SerialIterator(
        TupleDataset(x, t), 8, shuffle=False), opt), (12, "iteration"),
        out=out)
    cp = None
    if checkpoint:
        cp = create_multi_node_orbax_checkpointer(comm, out + "/dcp")
        trainer.extend(cp, trigger=(4, "iteration"))
    return model, trainer, cp


def test_world_of_one_rebuild_through_the_supervisor(tmp_path):
    """The CPU twin of chip_smoke.py's elastic_rebuild: a fault at the 7th
    reduce-scatter; the supervisor resolves a one-member view at epoch 1
    over the store, rebuilds onto ElasticMeshCommunicator((0,), epoch=1)
    (a new default world over the store), rolls back to iteration 4 and
    ends bitwise on the uninterrupted run."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.communicators import ElasticMeshCommunicator
    from chainermn_tpu_torch.extensions import ElasticRecovery
    comm = create_communicator("jax_ici", device="cpu")
    gold, trainer, _ = _one_rank_trainer(comm, str(tmp_path / "gold"),
                                         checkpoint=False)
    trainer.run()
    comm.finalize()
    comm = create_communicator("fault", device="cpu", fault_schedule={
        "seed": 0, "faults": [{"op": "reduce_scatter_grad", "nth": 7}]})
    model, trainer, cp = _one_rank_trainer(comm, str(tmp_path / "run"))
    membership = ElasticMembership(StoreKV(dist.HashStore()), rank=0,
                                   world=1, settle_s=0.05, poll_s=0.005)
    rec = ElasticRecovery(checkpointer=cp, comm=comm, membership=membership,
                          verbose=False)
    trainer.extend(rec)
    try:
        trainer.run()
        new = rec.comm
        assert isinstance(new, ElasticMeshCommunicator)
        assert (new.epoch, new.members, new.size) == (1, (0,), 1)
        assert dist.get_world_size() == 1 and new.group is None
        assert rec.stats["recoveries"] == 1
        assert rec.stats["resumed_iterations"] == [4]
        assert rec.stats["resizes"] == 0
        assert trainer.updater.iteration == 12
        for a, b in zip(gold.parameters(), model.parameters()):
            assert torch.equal(a, b)
    finally:
        rec.comm.finalize()
    assert not dist.is_initialized()


def _scripted(views):
    from tests.resilience_tests.test_elastic import _ScriptedMembership
    return _ScriptedMembership(views)


def _beacon_trainer(tmp_path, schedule, membership):
    """A world-of-one trainer with a per-iteration beacon and the elastic
    supervisor on a scripted membership."""
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_checkpointer,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.communicators import FaultInjectionCommunicator
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.dataset import SerialIterator, TupleDataset
    from chainermn_tpu_torch.extensions import ElasticRecovery
    from chainermn_tpu_torch.training import StandardUpdater, Trainer
    from chainermn_tpu_torch.training.trainer import Extension
    x, t = _data(n=32)
    base = create_communicator("jax_ici", device="cpu")
    comm = FaultInjectionCommunicator(base, schedule)
    model = _model()
    opt = create_multi_node_optimizer(MomentumSGD(lr=0.05, momentum=0.9),
                                      comm).setup(model)
    trainer = Trainer(StandardUpdater(SerialIterator(
        TupleDataset(x, t), 8, shuffle=False), opt), (12, "iteration"),
        out=str(tmp_path))
    cp = create_multi_node_checkpointer(comm, name="els",
                                        path=str(tmp_path))
    rec = ElasticRecovery(checkpointer=cp, comm=comm, membership=membership,
                          verbose=False)

    class Beacon(Extension):
        priority = 400

        def __call__(self, trainer):
            rec.comm.bcast_obj({"it": trainer.updater.iteration}, root=0)

    trainer.extend(Beacon())
    trainer.extend(cp, trigger=(3, "iteration"))
    trainer.extend(rec)
    return trainer, rec, base


def test_preempted_rank_fail_stops_without_rejoin(tmp_path):
    from chainermn_tpu_torch.communicators import FaultSchedule, RankPreempted
    membership = _scripted([])
    trainer, rec, base = _beacon_trainer(
        tmp_path, FaultSchedule([dict(op="bcast_obj", nth=3,
                                      action="preempt", rank=0)], seed=0),
        membership)
    try:
        with pytest.raises(RankPreempted):
            trainer.run(show_loop_exception_msg=False)
    finally:
        base.finalize()
    assert membership.left, "leave was not announced"


def test_min_world_floor_gives_up_with_view(tmp_path):
    from chainermn_tpu_torch.communicators import FaultSchedule
    trainer, rec, base = _beacon_trainer(
        tmp_path, FaultSchedule([dict(op="bcast_obj", nth=3)], seed=0),
        _scripted([(0,)]))
    rec.min_world = 2
    try:
        with pytest.raises(RecoveryGivingUp) as e:
            trainer.run(show_loop_exception_msg=False)
    finally:
        base.finalize()
    assert "members [0]" in str(e.value)
    assert e.value.membership.members == (0,)


def test_resize_rescatters_a_shard_and_keeps_the_global_batch():
    """Over a scattered shard (a per-rank batch) a resize re-slices the
    shard for the new world and sets the per-rank batch so that the
    global batch stays: a shrink from 2 ranks to 1 widens the survivor's
    half-shard to the whole order and doubles its batch; a load that
    restores an order made for the old shard starts the epoch again over
    the new one."""
    from types import SimpleNamespace

    import chainermn_tpu_torch as ct
    from chainermn_tpu_torch.dataset import SerialIterator
    from chainermn_tpu_torch.extensions import ElasticRecovery
    from chainermn_tpu_torch.extensions.elastic import _fit_iterator
    data = list(range(16))
    shard = ct.scatter_dataset(data, _Topology(2, 0), shuffle=True, seed=3)
    it = SerialIterator(shard, 4, shuffle=False)
    trainer = SimpleNamespace(updater=SimpleNamespace(
        get_iterator=lambda name: it))
    rec = ElasticRecovery(membership=_scripted([]), comm=_Topology(2, 0),
                          verbose=False)
    rec._check_batch(trainer, _Topology(1, 0))
    assert sorted(it.dataset[i] for i in range(len(it.dataset))) == data
    assert it.batch_size == 8
    it._order, it.epoch = np.arange(8), 3     # a load from the old shard
    _fit_iterator(trainer)
    assert len(it._order) == 16 and it.epoch == 3
    # a global batch of 8 over 3 ranks: no plan keeps it
    with pytest.raises(ElasticConfigError, match="no feasible batch plan"):
        rec._check_batch(trainer, _Topology(3, 0), old_size=1)


def test_swap_communicator_repoints_comm_holding_iterators():
    from types import SimpleNamespace

    import chainermn_tpu_torch as ct
    from chainermn_tpu_torch.dataset import SerialIterator
    from chainermn_tpu_torch.extensions import ElasticRecovery
    boot = ct.create_communicator("jax_ici", device="cpu")
    try:
        mni = ct.create_multi_node_iterator(
            SerialIterator(list(range(8)), 4, shuffle=False), boot)
        trainer = SimpleNamespace(updater=SimpleNamespace(
            _iterators={"main": mni}, get_all_optimizers=lambda: {}))
        rec = ElasticRecovery(membership=_scripted([]), comm=boot,
                              verbose=False)
        new = _Topology(1, 0)
        rec._swap_communicator(trainer, new)
        assert mni.comm is new and rec.comm is new
    finally:
        boot.finalize()


def test_check_batch_unwraps_multi_node_iterator():
    """The plan check reaches through comm-wrapping iterators to the base
    iterator's batch: an indivisible batch fails at the resize."""
    from types import SimpleNamespace

    import chainermn_tpu_torch as ct
    from chainermn_tpu_torch.dataset import SerialIterator
    from chainermn_tpu_torch.extensions import ElasticRecovery
    boot = ct.create_communicator("jax_ici", device="cpu")
    try:
        mni = ct.create_multi_node_iterator(
            SerialIterator(list(range(12)), 12, shuffle=False), boot)
        trainer = SimpleNamespace(updater=SimpleNamespace(
            get_iterator=lambda name: mni))
        rec = ElasticRecovery(membership=_scripted([]), comm=boot,
                              verbose=False, max_per_rank_bs=2)
        with pytest.raises(ElasticConfigError) as e:
            rec._check_batch(trainer, _Topology(2, 0))
        assert e.value.plan["accum_steps"] > 1
    finally:
        boot.finalize()
