"""The port's communicators against the JAX package's, in 2-rank gloo worlds.

Each group of checks spawns two CPU processes (``spawn``, never ``fork``)
that rendezvous through a ``FileStore`` under ``tmp_path``, run one worker
function of this module and write what they saw to ``tmp_path``; the
parent compares.  The workers import torch and the port only: this module
imports no JAX at its top, and the tests import the JAX package inside
themselves, so a spawned worker never starts JAX.  Every world has hard
limits: the process group's ``timeout`` (60 s) and the parent's join
deadline, after which stragglers are killed and the test fails.

Tolerances: the gradient exchange is compared BITWISE (the 2-rank sum is
one addition per element, whatever the packing); the dataset shards are
index lists and compared exactly.
"""

import datetime
import multiprocessing
import os
import time
import traceback

import numpy as np
import pytest
import torch

from chainermn_tpu_torch import (create_communicator,
                                 create_multi_node_optimizer,
                                 get_n_iterations_for_one_epoch,
                                 scatter_dataset, scatter_index)
from chainermn_tpu_torch.communicators import (DummyCommunicator,
                                               ElasticMeshCommunicator,
                                               SignatureMismatchError)
from chainermn_tpu_torch.communicators._memory_utility import (
    plan_buckets, resolve_grad_dtype, tree_pack, tree_unpack)
from chainermn_tpu_torch.core.optimizer import SGD
from chainermn_tpu_torch.datasets import create_empty_dataset
from chainermn_tpu_torch.models import TransformerLM

WORLD = 2
JOIN_S = 120
VOCAB, T = 61, 16
KW = dict(n_vocab=VOCAB, d_model=32, n_heads=2, n_layers=2, max_len=32)
#: small enough that the tiny model's gradients split into several buckets
TINY_BUCKET_MB = 20000 / 2 ** 20


# -- the 2-rank harness ------------------------------------------------------

def _rank_main(fn, rank, world, store, out, kwargs):
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        try:
            result = fn(rank, **kwargs)
        finally:
            if dist.is_initialized():   # an elastic worker may own it
                dist.destroy_process_group()
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_ranks(tmp_path, fn, world=WORLD, join_s=JOIN_S, **kwargs):
    """Run ``fn(rank, **kwargs)`` in ``world`` spawned gloo ranks; returns
    their results in rank order.  Fails (and kills every rank) when one
    fails or the world outlives ``join_s`` seconds."""
    out = tmp_path / f"{fn.__name__}_out"
    out.mkdir()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, str(out / "store"), str(out),
                               kwargs))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + join_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = {r: (out / f"rank{r}.err").read_text() for r in range(world)
              if (out / f"rank{r}.err").exists()}
    assert not hung, f"ranks {hung} still running after {join_s} s: {errors}"
    assert not errors and all(p.exitcode == 0 for p in procs), \
        f"exit codes {[p.exitcode for p in procs]}: {errors}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _tokens(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, VOCAB, (n, T)).astype(np.int64)
    return x, np.roll(x, -1, axis=1)


# -- workers (run in the spawned ranks) --------------------------------------

def _collectives_worker(rank):
    comm = create_communicator("naive", device="cpu")
    r = {"topology": (comm.rank, comm.size, comm.intra_rank,
                      comm.intra_size, comm.inter_rank, comm.inter_size)}
    x = torch.tensor([rank + 1.0, 2.0 * rank])
    r["allreduce"] = {op: comm.allreduce(x, op=op)
                      for op in ("sum", "mean", "max", "min")}
    r["multi_node_mean"] = comm.multi_node_mean(x)
    r["x_after"] = x                               # inputs stay untouched
    r["allgather"] = comm.allgather(torch.full((2,), float(rank)))
    r["gather"] = comm.gather(torch.tensor([rank]), root=1)
    r["alltoall"] = comm.alltoall([torch.tensor([10 * rank + j])
                                   for j in range(WORLD)])
    r["bcast0"] = comm.bcast(torch.arange(3) if rank == 0 else None)
    r["bcast1"] = comm.bcast(torch.ones(2, 2) * rank, root=1)
    r["scatter"] = comm.scatter(
        torch.arange(6.0).reshape(WORLD, 3) if rank == 1 else None, root=1)
    if rank == 0:
        comm.send(torch.arange(4, dtype=torch.int32), dest=1, tag=3)
        comm.send_obj({"from": 0}, dest=1)
        r["recv"] = comm.recv(source=1, tag=4)
        r["recv_obj"] = comm.recv_obj(source=1)
    else:
        r["recv"] = comm.recv(source=0, tag=3)
        r["recv_obj"] = comm.recv_obj(source=0)
        comm.send(torch.full((2,), 7.5), dest=0, tag=4)
        comm.send_obj(("from", 1), dest=0)
    r["bcast_obj"] = comm.bcast_obj({"root": rank}, root=1)
    r["gather_obj"] = comm.gather_obj(rank * 10)
    r["allgather_obj"] = comm.allgather_obj(f"r{rank}")
    r["allreduce_obj"] = comm.allreduce_obj({"a": rank, "b": [rank, 1.5]})
    alone = comm.split(color=rank, key=0)
    r["alone"] = (alone.rank, alone.size, alone.allreduce(torch.ones(1)))
    both = comm.split(color=0, key=rank)
    r["both"] = (both.rank, both.size,
                 both.allreduce(torch.tensor([rank + 1.0])))
    try:
        comm.split(color=0, key=-rank)
        r["reversed_key"] = None
    except NotImplementedError as e:
        r["reversed_key"] = str(e)
    alone.finalize()
    both.finalize()
    r["calls"] = dict(comm.calls)
    return r


def _grad_worker(rank):
    """bcast_data, then every exchange of this rank's gradients."""
    comm = create_communicator("naive", device="cpu")
    model = TransformerLM(seed=rank, device="cpu", **KW)  # differs by rank
    comm.bcast_data(model)
    params = {p: v.detach().clone() for p, v in model.namedparams()}
    x, t = _tokens(2, seed=10 + rank)                       # rank's batch
    model(torch.from_numpy(x), torch.from_numpy(t)).backward()
    raw = {p: v.grad.clone() for p, v in model.namedparams()}
    results = {}
    for label, name, kw in [
            ("per_leaf", "naive", {}),
            ("flat", "flat", {}),
            ("bucketed", "pure_nccl", dict(batch_collectives="bucketed",
                                           bucket_mb=TINY_BUCKET_MB)),
            ("bf16", "pure_nccl", dict(allreduce_grad_dtype="bfloat16"))]:
        c = create_communicator(name, device="cpu", **kw)
        for p, v in model.namedparams():
            v.grad = raw[p].clone()
        c.multi_node_mean_grad(model)
        results[label] = {
            "grads": {p: v.grad.clone() for p, v in model.namedparams()},
            "buckets": c.grad_buckets_for(model),
            "calls": c.calls["allreduce_grad"]}
    # zero_fill: a parameter without a gradient joins as zeros
    model.cleargrads()
    model.head.W.grad = torch.full_like(model.head.W, float(rank + 1))
    comm.multi_node_mean_grad(model, zero_fill=True)
    zero_filled = {p: v.grad.clone() for p, v in model.namedparams()}
    # the debug communicator refuses ranks with different gradient sets
    dbg = create_communicator("debug", device="cpu")
    model.cleargrads()
    for i, (_, v) in enumerate(model.namedparams()):
        if i != rank:
            v.grad = torch.zeros_like(v)
    try:
        dbg.multi_node_mean_grad(model)
        mismatch = None
    except SignatureMismatchError as e:
        mismatch = str(e)
    return dict(params=params, raw=raw, results=results,
                zero_filled=zero_filled, mismatch=mismatch)


def _scatter_worker(rank):
    comm = create_communicator("naive", device="cpu")
    out = {}
    for n, kw in [(10, dict(shuffle=True, seed=3)),
                  (11, dict(shuffle=True, seed=4)),
                  (11, dict(shuffle=False)),
                  (11, dict(shuffle=True, seed=5,
                            force_equal_length=False))]:
        shard = scatter_dataset(list(range(n)), comm, **kw)
        out[(n, tuple(sorted(kw.items())))] = list(shard)
    # only the root holds the dataset: the others receive it
    shard = scatter_dataset(list(range(100, 107)) if rank == 0 else None,
                            comm, shuffle=True, seed=6)
    out["root_only"] = list(shard)
    out["empty"] = len(create_empty_dataset(list(range(9))))
    out["index"] = scatter_index(9, comm)
    out["n_iter"] = get_n_iterations_for_one_epoch(list(range(9)), 2, comm)
    return out


# -- tests --------------------------------------------------------------------

def test_every_collective_and_object_call(tmp_path):
    r0, r1 = spawn_ranks(tmp_path, _collectives_worker)
    assert r0["topology"] == (0, 2, 0, 2, 0, 1)
    assert r1["topology"] == (1, 2, 1, 2, 0, 1)
    xs = [torch.tensor([1.0, 0.0]), torch.tensor([2.0, 2.0])]
    for r, x in ((r0, xs[0]), (r1, xs[1])):
        assert torch.equal(r["allreduce"]["sum"], xs[0] + xs[1])
        assert torch.equal(r["allreduce"]["mean"], (xs[0] + xs[1]) / 2)
        assert torch.equal(r["allreduce"]["max"], torch.maximum(*xs))
        assert torch.equal(r["allreduce"]["min"], torch.minimum(*xs))
        assert torch.equal(r["multi_node_mean"], (xs[0] + xs[1]) / 2)
        assert torch.equal(r["x_after"], x)
        assert [a.tolist() for a in r["allgather"]] == [[0.0, 0.0],
                                                        [1.0, 1.0]]
        # root-symmetric, as in the JAX package: every rank gets the list
        assert [a.tolist() for a in r["gather"]] == [[0], [1]]
        assert torch.equal(r["bcast0"], torch.arange(3))
        assert torch.equal(r["bcast1"], torch.ones(2, 2))
        assert r["bcast_obj"] == {"root": 1}
        assert r["gather_obj"] == [0, 10]
        assert r["allgather_obj"] == ["r0", "r1"]
        assert r["allreduce_obj"] == {"a": 1, "b": [1, 3.0]}
        assert "key" in r["reversed_key"]
    assert [a.item() for a in r0["alltoall"]] == [0, 10]
    assert [a.item() for a in r1["alltoall"]] == [1, 11]
    assert r0["scatter"].tolist() == [0.0, 1.0, 2.0]
    assert r1["scatter"].tolist() == [3.0, 4.0, 5.0]
    assert r1["recv"].dtype == torch.int32
    assert r1["recv"].tolist() == [0, 1, 2, 3]
    assert r0["recv"].tolist() == [7.5, 7.5]
    assert r1["recv_obj"] == {"from": 0} and r0["recv_obj"] == ("from", 1)
    assert r0["alone"] == (0, 1, torch.ones(1))
    assert r1["alone"] == (0, 1, torch.ones(1))
    assert r0["both"][:2] == (0, 2) and r1["both"][:2] == (1, 2)
    assert r0["both"][2].item() == r1["both"][2].item() == 3.0
    assert r0["calls"]["allreduce"] == 5 and r0["calls"]["bcast"] == 2


def test_bcast_data_and_every_gradient_exchange(tmp_path):
    """bcast_data copies rank 0's weights; per-leaf, flat and bucketed
    exchanges give BITWISE the same mean, (g0 + g1) / 2; the bf16 wire
    gives the bf16 sum, halved, cast back; buckets follow the JAX plan."""
    import jax
    import chainermn_tpu as ct
    from chainermn_tpu.models import TransformerLM as JaxLM

    r0, r1 = spawn_ranks(tmp_path, _grad_worker)
    ref = dict(TransformerLM(seed=0, device="cpu", **KW).namedparams())
    for r in (r0, r1):
        for p, v in r["params"].items():
            assert torch.equal(v, ref[p]), p
    assert any(not torch.equal(r0["raw"][p], r1["raw"][p]) for p in ref)
    for p in ref:
        want = (r0["raw"][p] + r1["raw"][p]) / 2
        wire = (r0["raw"][p].bfloat16() + r1["raw"][p].bfloat16()) / 2
        for r in (r0, r1):
            for label in ("per_leaf", "flat", "bucketed"):
                assert torch.equal(r["results"][label]["grads"][p], want), \
                    (label, p)
            got = r["results"]["bf16"]["grads"][p]
            assert got.dtype == torch.float32
            assert torch.equal(got, wire.float()), p
    n = len(ref)
    res = r0["results"]
    assert res["per_leaf"]["buckets"] == [[i] for i in reversed(range(n))]
    assert res["flat"]["buckets"] == [list(reversed(range(n)))]
    assert [res[k]["calls"] for k in ("per_leaf", "flat", "bf16")] \
        == [n, 1, 1]
    assert 2 < len(res["bucketed"]["buckets"]) < n
    assert res["bucketed"]["calls"] == len(res["bucketed"]["buckets"])
    # the same plan as the JAX communicator's over the same model
    jcomm = ct.create_communicator(
        "jax_ici", devices=jax.devices()[:2], batch_collectives="bucketed",
        bucket_mb=TINY_BUCKET_MB)
    assert res["bucketed"]["buckets"] \
        == jcomm.grad_buckets_for(JaxLM(seed=0, **KW))
    for p, v in r0["zero_filled"].items():
        want = torch.full_like(v, 1.5) if p == "/head/W" \
            else torch.zeros_like(v)
        assert torch.equal(v, want) and torch.equal(r1["zero_filled"][p], v)
    assert "gradient exchange" in r0["mismatch"]
    assert r0["mismatch"] == r1["mismatch"]


def test_scatter_dataset_shards_are_slices_of_the_jax_order(tmp_path):
    import jax
    import chainermn_tpu as ct
    from chainermn_tpu.datasets import scatter_dataset as jax_scatter

    r0, r1 = spawn_ranks(tmp_path, _scatter_worker)
    jcomm = ct.create_communicator("jax_ici", devices=jax.devices()[:2])
    for key, shard0 in r0.items():
        if not isinstance(key, tuple):
            continue
        n, kw = key[0], dict(key[1])
        order = list(jax_scatter(list(range(n)), jcomm, **kw))
        per = len(order) // 2
        assert shard0 == order[:per] and r1[key] == order[per:], key
        assert len(shard0) == len(r1[key])
    order = list(jax_scatter(list(range(100, 107)), jcomm, shuffle=True,
                             seed=6))
    assert r0["root_only"] + r1["root_only"] == order
    assert r0["empty"] == 9
    assert (r0["index"], r1["index"]) == ((0, 5), (5, 9))
    assert r0["n_iter"] == 3


def test_gradient_packing_and_bucket_plan_match_jax():
    from chainermn_tpu.communicators import _memory_utility as jmu
    shapes = [(3, 4), (5,), (2, 2, 2), (7,)]
    dtypes = [torch.float32, torch.float32, torch.bfloat16, torch.float32]
    jdtypes = ["float32", "float32", "bfloat16", "float32"]
    for bound in (16, 40, 64, 1 << 20):
        assert plan_buckets(shapes, dtypes, bound) \
            == jmu.plan_buckets(shapes, jdtypes, bound)
    xs = [torch.arange(np.prod(s), dtype=d).reshape(s)
          for s, d in zip(shapes, dtypes)]
    flat, spec = tree_pack(xs, dtype=torch.float32)
    assert flat.shape == (sum(int(np.prod(s)) for s in shapes),)
    for a, b in zip(tree_unpack(flat, spec), xs):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert resolve_grad_dtype("bfloat16") is torch.bfloat16
    assert resolve_grad_dtype(None) is None


def test_names_not_ported_raise_and_no_card_raises():
    # autotune is ported (tests/test_torch_autotune.py); so is fault
    # injection (tests/test_torch_fault_injection.py), which needs a
    # schedule
    with pytest.raises(ValueError, match="needs fault_schedule="):
        create_communicator("fault", device="cpu")
    # the striped exchange is ported: a flat communicator has nothing to
    # stripe (tests/test_torch_striped_exchange.py runs the rest)
    with pytest.raises(ValueError, match="stripe_ratio needs"):
        create_communicator("jax_ici", device="cpu", stripe_ratio=0.25)
    # the two-level exchange and the quantized wires are ported: each
    # builds in a world of one (a 1 x 1 split; tests/test_torch_
    # hierarchical.py runs them at 2 x 2)
    for kw, want in (
            (dict(communicator_name="hierarchical"), ((1, 1), None, None)),
            (dict(communicator_name="two_dimensional"), ((1, 1), None,
                                                         None)),
            (dict(communicator_name="hierarchical",
                  allreduce_grad_dtype={"dcn": "bfloat16"}),
             ((1, 1), None, torch.bfloat16)),
            (dict(communicator_name="pure_nccl",
                  allreduce_grad_dtype="int8"), (None, torch.int8, None)),
            (dict(communicator_name="hierarchical", stripe_ratio=0.25),
             ((1, 1), None, None))):
        comm = create_communicator(device="cpu", **kw)
        try:
            split = (comm.dcn_size, comm.ici_size) if comm.hierarchy \
                else None
            assert (split, comm.allreduce_grad_dtype,
                    comm.dcn_grad_dtype) == want
        finally:
            comm.finalize()
    # ... or raise what the JAX factory raises
    for kw, match in (
            (dict(communicator_name="jax_ici", inter_size=2),
             "does not divide"),
            (dict(communicator_name="pure_nccl",
                  allreduce_grad_dtype={"dcn": "bfloat16"}), "per-hop"),
            (dict(communicator_name="hierarchical",
                  allreduce_grad_dtype={"ici": "int8"}),
             "lossless by design")):
        with pytest.raises(ValueError, match=match):
            create_communicator(device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown communicator"):
        create_communicator("mpi", device="cpu")
    with pytest.raises(ValueError, match="pure_nccl-only"):
        create_communicator("naive", device="cpu",
                            allreduce_grad_dtype="bfloat16")
    # the elastic communicator is ported (tests/test_torch_elastic.py): it
    # needs members and a host channel over the job's store
    with pytest.raises(ValueError, match=">= 1 member"):
        ElasticMeshCommunicator(members=[], device="cpu")
    with pytest.raises(ValueError, match="host channel"):
        ElasticMeshCommunicator(members=[0], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_communicator("pure_nccl")
    import torch.distributed as dist
    assert not dist.is_initialized()   # every world above was torn down
    dummy = DummyCommunicator()
    # A5's exchanges are ported (tests/test_torch_exchanges.py); the
    # striped exchange's stale variant needs a striped communicator, and
    # autotune a communicator it can tune
    for kw in (dict(exchange="reduce_scatter"), dict(zero_sharding=True),
               dict(double_buffering=True)):
        assert create_multi_node_optimizer(SGD(), dummy, **kw) is not None
    with pytest.raises(ValueError, match="stripe_ratio > 0"):
        create_multi_node_optimizer(SGD(), dummy, double_buffering="dcn")
    with pytest.raises(ValueError, match="autotune"):
        create_multi_node_optimizer(SGD(), dummy, autotune=True)
    with pytest.raises(ValueError, match="exchange"):
        create_multi_node_optimizer(SGD(), dummy, exchange="striped")


def test_dummy_communicator_is_the_size_one_identity():
    comm = DummyCommunicator()
    x = torch.arange(3.0)
    assert (comm.rank, comm.size, comm.inter_size) == (0, 1, 1)
    assert torch.equal(comm.allreduce(x), x)
    assert torch.equal(comm.bcast(x), x)
    assert [torch.equal(a, x) for a in comm.allgather(x)] == [True]
    assert comm.allgather_obj("a") == ["a"] and comm.bcast_obj(3) == 3
    comm.send_obj("m", dest=0)
    assert comm.recv_obj(0) == "m" and comm.split(0, 0) is comm
    model = TransformerLM(seed=0, device="cpu", **KW)
    assert comm.bcast_data(model) is model
    comm.multi_node_mean_grad(model)
