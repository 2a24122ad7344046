"""The two-level (intra-node x inter-node) exchange against the flat one
and the JAX package's, in one 4-rank gloo world with a forced 2 x 2 split.

The port side: ``create_communicator("hierarchical" | "two_dimensional",
device="cpu", intra_size=2, inter_size=2)`` in one spawned 4-rank world
(every flavor runs in it, as ``test_torch_exchanges.py`` does), each rank
feeding its quarter of the batch.  The JAX side:
``create_communicator("hierarchical", devices=jax.devices()[:4],
inter_size=2)``, a real 2 x 2 over 4 of ``tests/conftest.py``'s CPU
devices, on the whole batch.  Model and data are
``tests/core_tests/test_exchange_equivalence.py``'s (``Classifier(MLP(16,
4, seed=0))``, 32 examples of 8 features, MomentumSGD 0.1/0.9), and the
checks are its twins (``:110``, ``:135``, ``:166``, ``:188``, ``:419``,
``:448``), with ``tests/communicator_tests/test_multihost_simulation.py
:214-252`` (the topology) and the hop counts, which stand in for the JAX
census tests.

Tolerances: port against JAX, 1e-5 absolute (two frameworks, other
summation orders, as ``test_torch_exchanges.py``); port hierarchical
against port flat on the same 4 ranks, rtol 1e-5 / atol 1e-6 (the chained
per-hop sums reassociate the fp32 additions: the JAX test's own bound);
the bf16 wires, rtol 5e-3 on the losses (the JAX test's band: the
hierarchy reorders bf16 roundings); a resume and the chunk order,
bitwise.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from tests.test_torch_communicator import spawn_ranks

WORLD, INTRA, INTER = 4, 2, 2
N, D, K = 32, 8, 4
STEPS = 3
#: tiny bound so that the toy MLP's 1,936 gradient bytes split into three
#: buckets (the JAX test's 2,000 bytes would leave one)
TINY_BUCKET_MB = 600 / 2 ** 20
JAX_TOL = dict(rtol=0, atol=1e-5)
FLAT_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_RTOL = 5e-3
RS = dict(exchange="reduce_scatter")
DB = dict(double_buffering=True)
#: (label, communicator, create_multi_node_optimizer keywords, steps)
RUNS = [("flat", "flat", {}, STEPS),
        ("hierarchical", "hier", {}, STEPS),
        ("hierarchical_bucketed", "hier_bucketed", {}, STEPS),
        ("hierarchical_rs", "hier", RS, STEPS),
        ("two_dimensional", "two_d", {}, STEPS),
        ("db_flat", "flat", DB, 4),
        ("db_hierarchical", "hier", DB, 4),
        ("db_hierarchical_rs", "hier", {**DB, **RS}, 4),
        ("lossless5", "hier", {}, 5),
        ("bf16_flat", "flat_bf16", {}, 5),
        ("bf16_hierarchical", "hier_bf16", {}, 5),
        ("dcn_bf16", "hier_dcn_bf16", {}, 5)]
#: the quantized residual's resume runs (``test_exchange_equivalence.py:
#: 419``'s grid without the striped legs)
RESUMES = [("hierarchical", {}), ("hierarchical_rs", RS),
           ("hierarchical_rs_db", {**RS, **DB})]


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 1, (N, D)).astype(np.float32),
            rng.randint(0, K, N).astype(np.int32))


# -- worker (runs in the spawned ranks) ---------------------------------------

def _params_of(model):
    return {p: v.detach().clone() for p, v in model.namedparams()}


def _make(comm, **kw):
    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.models import MLP, Classifier
    model = Classifier(MLP(n_units=16, n_out=K, seed=0, device="cpu"))
    comm.bcast_data(model)
    opt = create_multi_node_optimizer(MomentumSGD(lr=0.1, momentum=0.9),
                                      comm, **kw).setup(model)
    return model, opt


def _hier_worker(rank, x, t, out_dir, jax_snapshot):
    from chainermn_tpu_torch import create_communicator, scatter_dataset
    from chainermn_tpu_torch.serializers import load_npz, save_npz
    rows = N // WORLD
    xs = torch.from_numpy(x[rank * rows:(rank + 1) * rows])
    ts = torch.from_numpy(t[rank * rows:(rank + 1) * rows]).long()
    split = dict(device="cpu", intra_size=INTRA, inter_size=INTER)
    comms = {
        "flat": create_communicator("jax_ici", device="cpu"),
        "hier": create_communicator("hierarchical", **split),
        "hier_bucketed": create_communicator(
            "hierarchical", batch_collectives="bucketed",
            bucket_mb=TINY_BUCKET_MB, **split),
        "two_d": create_communicator("two_dimensional", **split),
        "flat_bf16": create_communicator("jax_ici", device="cpu",
                                         allreduce_grad_dtype="bfloat16"),
        "hier_bf16": create_communicator(
            "hierarchical", allreduce_grad_dtype="bfloat16", **split),
        "hier_dcn_bf16": create_communicator(
            "hierarchical", allreduce_grad_dtype={"dcn": "bfloat16"},
            **split),
        "hier_q": create_communicator(
            "hierarchical", allreduce_grad_dtype={"dcn": "int8"}, **split),
    }
    hier = comms["hier"]
    out = {"topology": {
        k: getattr(hier, k) for k in (
            "rank", "size", "intra_rank", "intra_size", "inter_rank",
            "inter_size", "dcn_size", "ici_size", "dcn_index", "ici_index",
            "chunk_index", "hierarchy")}}
    out["topology"]["chunk_axes"] = hier.chunk_axes()
    out["shard"] = [int(i) for i in scatter_dataset(
        list(range(48)), hier, shuffle=True, seed=7)]

    def run(comm, steps, **kw):
        model, opt = _make(comms[comm], **kw)
        comms[comm].calls.clear()
        losses, params = [], []
        for _ in range(steps):
            losses.append(opt.update(model, xs, ts).item())
            params.append(_params_of(model))
        buckets = comms[comm].grad_buckets_for(model)
        return {"losses": losses, "params": params, "buckets": len(buckets),
                "calls": dict(comms[comm].calls),
                "layout": opt._flat_layout() if opt._sharded_update
                else None}

    for label, comm, kw, steps in RUNS:
        out[label] = run(comm, steps, **kw)

    # the chunk order of the chain: a reduce-scatter of known vectors
    n_pad = 24
    flat = torch.arange(n_pad, dtype=torch.float32) * (rank + 1)
    chunk = hier.reduce_scatter_grad(flat).wait()
    out["rs_chunk"] = chunk
    out["gathered"] = hier.allgather_flat(chunk)

    # the quantized residual: resume bitwise, the pre-feature zero-seed
    q = comms["hier_q"]
    for label, kw in RESUMES:
        model, opt = _make(q, **kw)
        for _ in range(2):
            opt.update(model, xs, ts)
        path = os.path.join(out_dir, f"{label}_rank{rank}.npz")
        save_npz(path, opt)
        cont_ref = [opt.update(model, xs, ts).item() for _ in range(2)]
        model_b, opt_b = _make(q, **kw)
        opt_b.update(model_b, xs, ts)
        load_npz(path, opt_b)
        had = opt_b._residual is not None
        cont = [opt_b.update(model_b, xs, ts).item() for _ in range(2)]
        out[f"resume_{label}"] = (had, cont_ref, cont, _params_of(model),
                                  _params_of(model_b),
                                  opt._residual.numel())
    model, opt = _make(hier)
    for _ in range(2):
        opt.update(model, xs, ts)
    path = os.path.join(out_dir, f"plain_rank{rank}.npz")
    save_npz(path, opt)
    model_q, opt_q = _make(q)
    for _ in range(2):
        opt_q.update(model_q, xs, ts)
    had = opt_q._residual is not None
    load_npz(path, opt_q)
    out["pre_feature"] = (had, opt_q._residual,
                          opt_q.update(model_q, xs, ts).item())

    # the JAX package's ef_residual snapshot, loaded and continued
    model_j, opt_j = _make(q)
    opt_j.update(model_j, xs, ts)
    load_npz(jax_snapshot, opt_j)
    residual = opt_j._residual.clone()
    out["jax_snapshot"] = (residual, q.chunk_index, opt_j.t, [
        opt_j.update(model_j, xs, ts).item() for _ in range(2)],
        _params_of(model_j))

    shapes = [(7,), (33,), (5, 5)]
    out["residual_len"] = {k: comms[k].grad_residual_len(
        shapes, [torch.float32] * 3) for k in ("hier_q", "hier")}
    return out


# -- the JAX references (this process) ------------------------------------------

def _jax_runs(x, t, snapshot):
    import jax
    import jax.numpy as jnp
    import chainermn_tpu as ct
    from chainermn_tpu.core.optimizer import MomentumSGD
    from chainermn_tpu.models import MLP, Classifier
    from chainermn_tpu.serializers import save_npz
    x, t = jnp.asarray(x), jnp.asarray(t)

    def run(comm, steps, save=None, **kw):
        model = Classifier(MLP(n_units=16, n_out=K, seed=0))
        if comm is None:
            opt = MomentumSGD(lr=0.1, momentum=0.9).setup(model)
        else:
            comm.bcast_data(model)
            opt = ct.create_multi_node_optimizer(
                MomentumSGD(lr=0.1, momentum=0.9), comm, **kw).setup(model)
        losses, params = [], []
        for _ in range(steps):
            losses.append(float(opt.update(model, x, t)))
            params.append({p: np.asarray(v.array)
                           for p, v in model.namedparams()})
        if save:
            save_npz(save, opt)
            return np.asarray(opt._residual)
        return {"losses": losses, "params": params}

    def hier(dtype=None, **kw):
        return ct.create_communicator(
            "hierarchical", devices=jax.devices()[:WORLD], inter_size=INTER,
            allreduce_grad_dtype=dtype, **kw)

    flat = ct.create_communicator("jax_ici", devices=jax.devices()[:WORLD])
    out = {"golden": run(None, STEPS),
           "hierarchical": run(hier(), STEPS),
           "hierarchical_bucketed": run(hier(batch_collectives="bucketed",
                                             bucket_mb=TINY_BUCKET_MB),
                                        STEPS),
           "hierarchical_rs": run(hier(), STEPS, **RS),
           "db_flat": run(flat, 4, **DB),
           "db_hierarchical": run(hier(), 4, **DB),
           "db_hierarchical_rs": run(hier(), 4, **DB, **RS),
           "bf16_hierarchical": run(hier("bfloat16"), 5),
           "dcn_bf16": run(hier({"dcn": "bfloat16"}), 5),
           "residual": run(hier({"dcn": "int8"}), 2, save=snapshot)}
    # the snapshot's continuation
    from chainermn_tpu.serializers import load_npz
    model = Classifier(MLP(n_units=16, n_out=K, seed=0))
    comm = hier({"dcn": "int8"})
    comm.bcast_data(model)
    opt = ct.create_multi_node_optimizer(
        MomentumSGD(lr=0.1, momentum=0.9), comm).setup(model)
    opt.update(model, x, t)
    load_npz(snapshot, opt)
    out["continued"] = ([float(opt.update(model, x, t)) for _ in range(2)],
                        {p: np.asarray(v.array)
                         for p, v in model.namedparams()})
    out["residual_len"] = hier({"dcn": "int8"}).grad_residual_len(
        [(7,), (33,), (5, 5)], [jnp.float32] * 3)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    x, t = _data()
    tmp = tmp_path_factory.mktemp("hierarchical")
    snapshot = str(tmp / "jax_int8.npz")
    jax_out = _jax_runs(x, t, snapshot)
    ranks = spawn_ranks(tmp, _hier_worker, world=WORLD, x=x, t=t,
                        out_dir=str(tmp), jax_snapshot=snapshot)
    return ranks, jax_out


def _close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for p in want:
        np.testing.assert_allclose(np.asarray(got[p]), np.asarray(want[p]),
                                   err_msg=p, **tol)


def _equal(a, b):
    return sorted(a) == sorted(b) and all(torch.equal(a[p], b[p]) for p in a)


# -- tests ----------------------------------------------------------------------

@pytest.mark.parametrize("exchange", ["hierarchical", "hierarchical_bucketed",
                                      "hierarchical_rs", "two_dimensional"])
def test_exchange_matches_flat_jax_and_golden(runs, exchange):
    """``test_exchange_equivalence.py:110``'s twin: each two-level flavor
    equals the flat exchange on the same ranks, the JAX 2 x 2 run and
    the single-device run on the merged batch."""
    ranks, jax_out = runs
    want = jax_out["hierarchical" if exchange == "two_dimensional"
                   else exchange]
    for r in ranks:
        got, flat = r[exchange], r["flat"]
        np.testing.assert_allclose(got["losses"], flat["losses"],
                                   **FLAT_TOL)
        for a, b in zip(got["params"], flat["params"]):
            _close(a, b, **FLAT_TOL)
        np.testing.assert_allclose(got["losses"], want["losses"], **JAX_TOL)
        for a, b in zip(got["params"], want["params"]):
            _close(a, b, **JAX_TOL)
        _close(got["params"][-1], jax_out["golden"]["params"][-1],
               **JAX_TOL)
        # every rank ends with the same parameters
        assert _equal(got["params"][-1], ranks[0][exchange]["params"][-1])


@pytest.mark.parametrize("exchange", ["db_hierarchical",
                                      "db_hierarchical_rs"])
def test_double_buffering_grid(runs, exchange):
    """``:135``'s twin: one-step-stale on the two-level exchange and its
    sharded update, equal to the flat double-buffered run and the JAX
    one; step 2's loss is step 1's (the first update applies zeros)."""
    ranks, jax_out = runs
    for r in ranks:
        got, ref = r[exchange], r["db_flat"]
        assert got["losses"][0] == got["losses"][1]
        np.testing.assert_allclose(got["losses"], ref["losses"], **FLAT_TOL)
        for a, b in zip(got["params"], ref["params"]):
            _close(a, b, **FLAT_TOL)
        want = jax_out[exchange]
        np.testing.assert_allclose(got["losses"], want["losses"], **JAX_TOL)
        for a, b in zip(got["params"], want["params"]):
            _close(a, b, **JAX_TOL)
    np.testing.assert_allclose(ranks[0]["db_flat"]["losses"],
                               jax_out["db_flat"]["losses"], **JAX_TOL)


def test_bf16_on_both_hops_and_per_hop(runs):
    """``:166``/``:188``'s twins: a scalar bf16 compresses both hops and
    stays within bf16 rounding of the flat bf16 run; ``{"dcn":
    "bfloat16"}`` (lossless intra-node hop) within bf16 rounding of the
    lossless run; both learn and track the JAX runs."""
    ranks, jax_out = runs
    for r in ranks:
        h, f = r["bf16_hierarchical"]["losses"], r["bf16_flat"]["losses"]
        np.testing.assert_allclose(h, f, rtol=BF16_RTOL)
        assert np.isfinite(h).all() and h[-1] < h[0]
        d, lossless = r["dcn_bf16"]["losses"], r["lossless5"]["losses"]
        np.testing.assert_allclose(d, lossless, rtol=BF16_RTOL)
        assert d[-1] < d[0] and d != lossless
        np.testing.assert_allclose(
            h, jax_out["bf16_hierarchical"]["losses"], rtol=BF16_RTOL)
        np.testing.assert_allclose(d, jax_out["dcn_bf16"]["losses"],
                                   rtol=BF16_RTOL)


@pytest.mark.parametrize("label", [label for label, _ in RESUMES])
def test_quantized_residual_resume_bitwise(runs, label):
    """``:419``'s twin: a same-size save, load and continue of the int8
    run carries the residual and is bitwise the uninterrupted run."""
    ranks, _ = runs
    for r in ranks:
        had, cont_ref, cont, params_ref, params, n = r[f"resume_{label}"]
        assert had and n > 0
        assert cont == cont_ref
        assert _equal(params, params_ref)


def test_pre_feature_snapshot_zero_seeds(runs):
    """``:448``'s twin: a snapshot without ``ef_residual`` leaves the
    residual to be zero-seeded; the next update is finite."""
    ranks, _ = runs
    for r in ranks:
        had, residual, loss = r["pre_feature"]
        assert had and residual is None and np.isfinite(loss)


def test_jax_ef_residual_snapshot_loads(runs):
    """A JAX 2 x 2 snapshot's ``ef_residual`` (the global vector in the
    fast-hop-major chunk layout) loads into each rank's part, and the run
    continues as the JAX run does."""
    ranks, jax_out = runs
    whole = jax_out["residual"]
    local = whole.shape[0] // WORLD
    for r in ranks:
        residual, chunk, t, losses, params = r["jax_snapshot"]
        assert t == 2
        np.testing.assert_array_equal(
            residual.numpy(), whole[chunk * local:(chunk + 1) * local])
        np.testing.assert_allclose(losses, jax_out["continued"][0],
                                   **JAX_TOL)
        _close(params, jax_out["continued"][1], **JAX_TOL)
    assert np.abs(whole).max() > 0


def test_topology_under_a_forced_split(runs):
    """``test_multihost_simulation.py:214-252``'s twin: on one host the
    forced 2 x 2 split is the device view (``dcn_size``, ``ici_size``,
    ``intra_size``) while ``inter_size`` stays the host count; the
    reference's slot arithmetic holds; ``scatter_dataset`` still deals
    every rank its own shard."""
    ranks, _ = runs
    shards = []
    for rank, r in enumerate(ranks):
        topo = r["topology"]
        assert topo["rank"] == rank and topo["size"] == WORLD
        assert topo["dcn_size"] == INTER and topo["ici_size"] == INTRA
        assert topo["intra_size"] == INTRA == topo["ici_size"]
        assert topo["inter_size"] == 1 and topo["inter_rank"] == 0
        assert (topo["dcn_index"], topo["ici_index"]) == divmod(rank, INTRA)
        assert topo["intra_rank"] == topo["ici_index"]
        assert 0 <= topo["intra_rank"] < topo["intra_size"]
        assert topo["inter_rank"] * topo["intra_size"] \
            + topo["intra_rank"] < topo["size"]
        assert topo["hierarchy"] == ("dcn", "ici")
        assert topo["chunk_axes"] == ("ici", "dcn")
        shards.append(r["shard"])
    assert all(len(s) == 12 for s in shards)
    assert sorted(sum(shards, [])) == list(range(48))


def test_chunk_order_at_two_by_two(runs):
    """Rank ``r = dcn * intra + ici`` owns chunk ``ici * inter + dcn``:
    ranks 0, 1, 2, 3 own chunks 0, 2, 1, 3, in the reduce-scatter chain,
    the sharded update's layout and the gather that rebuilds the
    vector."""
    ranks, _ = runs
    n_pad, chunk = 24, 24 // WORLD
    mean = np.arange(n_pad, dtype=np.float32) * sum(
        r + 1 for r in range(WORLD)) / WORLD
    assert [r["topology"]["chunk_index"] for r in ranks] == [0, 2, 1, 3]
    for r in ranks:
        c = r["topology"]["chunk_index"]
        np.testing.assert_array_equal(r["rs_chunk"].numpy(),
                                      mean[c * chunk:(c + 1) * chunk])
        np.testing.assert_array_equal(r["gathered"].numpy(), mean)
        n, n_pad_rs, lo, hi = r["hierarchical_rs"]["layout"]
        assert (lo, hi) == (c * n_pad_rs // WORLD, (c + 1) * n_pad_rs // WORLD)


@pytest.mark.parametrize("label,want", [
    ("hierarchical", {"ici_reduce_scatter": 1, "dcn_allreduce": 1,
                      "ici_allgather": 1}),
    ("hierarchical_rs", {"ici_reduce_scatter": 1, "dcn_reduce_scatter": 1,
                         "dcn_allgather": 1, "ici_allgather": 1}),
    ("db_hierarchical", {"ici_reduce_scatter": 1, "dcn_allreduce": 1,
                         "ici_allgather": 1}),
    ("hierarchical_bucketed", {"ici_reduce_scatter": 1, "dcn_allreduce": 1,
                               "ici_allgather": 1})])
def test_one_collective_of_each_hop_per_bucket_per_step(runs, label, want):
    """The hop counts of ``calls`` (the port's stand-in for the JAX
    census tests): one of each per bucket per step, nothing else but the
    model's broadcast and the loss's mean."""
    ranks, _ = runs
    for r in ranks:
        run = r[label]
        per = run["buckets"] if label != "hierarchical_rs" else 1
        if label == "hierarchical_bucketed":
            assert run["buckets"] > 1
        calls = {k: v for k, v in run["calls"].items()
                 if k not in ("bcast", "allreduce")}
        assert calls == {k: v * per * len(run["losses"])
                         for k, v in want.items()}


def test_residual_length_matches_jax(runs):
    ranks, jax_out = runs
    for r in ranks:
        # one flat bucket of 65 elements, padded to 66 (intra 2): 33
        assert r["residual_len"] == {"hier_q": jax_out["residual_len"],
                                     "hier": 0}
        assert r["residual_len"]["hier_q"] == 33


def test_hierarchy_flat_escape_hatch_warns_once(monkeypatch):
    """``CHAINERMN_TPU_HIERARCHY=flat``: the hierarchical names become the
    flat exchange; a per-hop dict keeps its ``dcn`` entry with one
    warning per distinct dict, a stripe ratio is dropped with one
    warning (the JAX factory's two once-only warnings)."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    import chainermn_tpu_torch.communicators as factory
    monkeypatch.setenv("CHAINERMN_TPU_HIERARCHY", "flat")
    monkeypatch.setattr(factory, "_WARNED_FLAT_DICTS", set())
    monkeypatch.setattr(factory, "_WARNED_FLAT_STRIPES", set())
    with pytest.warns(UserWarning, match="degrades per-hop"):
        comm = create_communicator("hierarchical", device="cpu",
                                   allreduce_grad_dtype={"dcn": "bfloat16"},
                                   inter_size=2)
    try:
        assert comm.hierarchy is None and comm.name == "jax_ici"
        assert comm.allreduce_grad_dtype is torch.bfloat16
    finally:
        comm.finalize()
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        create_communicator("two_dimensional", device="cpu",
                            allreduce_grad_dtype={"dcn": "bfloat16"}
                            ).finalize()
    with pytest.warns(UserWarning, match="drops stripe_ratio"):
        create_communicator("hierarchical", device="cpu",
                            stripe_ratio=0.5).finalize()
    assert not dist.is_initialized()
