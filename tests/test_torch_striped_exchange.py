"""The striped multi-path exchange against the JAX package's.

The pure functions (``stripe_plan``, ``hop_schedule(mode="striped")``,
``derived_stripe_ratio``, ``stripe_plan_from_measurement``,
``striped_exchanged_bytes``): the twins of the 14 functions of
``tests/communicator_tests/test_striped_exchange.py``, each running the
port's function and the JAX one on the same inputs, and the knob
plumbing on the port's communicators (a world of one: a 1 x 1 split).

The exchange: one spawned 4-rank gloo world with a forced 2 x 2 split
(``intra_size=2, inter_size=2``), each rank feeding its quarter of the
batch, runs every striped flavor (allreduce, bucketed, reduce-scatter,
ZeRO-1, double buffering, ``double_buffering="dcn"``, bf16 on both hops,
``{"dcn": "bfloat16"}``, ``{"dcn": "int8"}`` with error feedback) at the
JAX test's ratio 0.5 on ``tests/core_tests/test_exchange_equivalence.
py``'s model and data (``Classifier(MLP(16, 4, seed=0))``, 32 examples of 8
features, MomentumSGD 0.1/0.9); the JAX side runs the same flavors on a
real 2 x 2 over 4 of ``tests/conftest.py``'s CPU devices.  Both start from
the same seeded weights.  Then the resumes, a JAX snapshot of the striped
ZeRO state and of the stale DCN buffer, the two chunk orders and the
calls per op.

Tolerances: port against JAX, 1e-5 absolute (two frameworks, other
summation orders, as ``tests/test_torch_hierarchical.py``); port striped
against port flat on the same 4 ranks, rtol 1e-5 / atol 1e-6 (the chained
per-path sums reassociate the fp32 additions: the JAX test's bound); the
bf16 wires, rtol 5e-3 on the losses (the JAX test's band); the int8 wire,
the final loss within 5 % of the lossless run's (the JAX quantized
test's band) and the losses within 5e-3 of the JAX int8 run (a codeword
that the two frameworks' roundings put on either side of a step moves
that element by one quantization step, which feedback returns the step
after); resumes, the ratio-1 stale variant against full double
buffering and the chunk orders, bitwise.
"""

import os

import numpy as np
import pytest
import torch

import chainermn_tpu_torch.communicators as factory
from chainermn_tpu_torch.communicators import _memory_utility as mu
from tests.test_torch_communicator import spawn_ranks

WORLD, INTRA, INTER = 4, 2, 2
N, D, K = 32, 8, 4
STEPS = 3
RATIO = 0.5
#: three buckets of the toy MLP's 1,936 gradient bytes
TINY_BUCKET_MB = 600 / 2 ** 20
JAX_TOL = dict(rtol=0, atol=1e-5)
FLAT_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_RTOL = 5e-3
INT8_JAX_RTOL = 5e-3
LOSS_BAND = 0.05
RS = dict(exchange="reduce_scatter")
DB = dict(double_buffering=True)
DCN = dict(double_buffering="dcn")
#: (label, communicator, create_multi_node_optimizer keywords, steps)
RUNS = [("flat", "flat", {}, STEPS),
        ("striped", "s", {}, STEPS),
        ("striped_bucketed", "s_bucketed", {}, STEPS),
        ("striped_rs", "s", RS, STEPS),
        ("striped_zero", "s", dict(zero_sharding=True), STEPS),
        ("db_flat", "flat", DB, 4),
        ("db_striped", "s", DB, 4),
        ("db_striped_rs", "s", {**DB, **RS}, 4),
        ("fresh4", "s", {}, 4),
        ("dcn_stale", "s", DCN, 4),
        ("r1_full_stale", "s_r1", DB, 4),
        ("r1_dcn_stale", "s_r1", DCN, 4),
        ("lossless5", "s", {}, 5),
        ("flat5", "flat", {}, 5),
        ("bf16_flat", "flat_bf16", {}, 5),
        ("bf16_striped", "s_bf16", {}, 5),
        ("dcn_bf16", "s_dcn_bf16", {}, 5),
        ("int8", "s_q", {}, 5)]
#: bitwise resumes: (label, communicator, keywords)
RESUMES = [("dcn_stale", "s", DCN), ("db_striped_rs", "s", {**DB, **RS}),
           ("int8", "s_q", {}), ("int8_dcn_stale", "s_q", DCN)]
#: the striped ops of one allreduce step, per bucket
STRIPED_OPS = ("dcn_path_scatter", "ici_path_scatter", "dcn_path_exchange",
               "ici_path_exchange", "dcn_path_gather", "ici_path_gather")


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 1, (N, D)).astype(np.float32),
            rng.randint(0, K, N).astype(np.int32))


def _jmu():
    from chainermn_tpu.communicators import _memory_utility as jmu
    return jmu


# -- the pure functions, port against JAX ----------------------------------------

def test_every_element_in_exactly_one_slice():
    rng = np.random.RandomState(0)
    for _ in range(50):
        n = int(rng.randint(0, 1 << 20))
        ratio = float(rng.uniform(0, 1))
        n_i, n_d = mu.stripe_plan(n, ratio)
        assert n_i >= 0 and n_d >= 0 and n_i + n_d == n
        assert (n_i, n_d) == _jmu().stripe_plan(n, ratio)


def test_ratio_respected():
    rng = np.random.RandomState(1)
    for _ in range(50):
        n = int(rng.randint(1, 1 << 20))
        ratio = float(rng.uniform(0, 1))
        _, n_d = mu.stripe_plan(n, ratio)
        assert n_d == int(round(ratio * n))
        assert abs(n_d - ratio * n) <= 0.5


def test_degenerate_ratios_collapse_to_single_path():
    for n in (0, 1, 17, 4096):
        assert mu.stripe_plan(n, 0.0) == (n, 0) == _jmu().stripe_plan(n, 0.0)
        assert mu.stripe_plan(n, 1.0) == (0, n) == _jmu().stripe_plan(n, 1.0)


def test_cross_process_determinism():
    for n in (7, 1000, 999999):
        for ratio in (0.1, 0.25, 1 / 3, 0.5, 0.75):
            assert mu.stripe_plan(n, ratio) == mu.stripe_plan(n, ratio) \
                == _jmu().stripe_plan(n, ratio)


def test_stripe_plan_rejects_bad_inputs():
    for args, match in (((10, -0.1), "ratio"), ((10, 1.1), "ratio"),
                        ((-1, 0.5), "n_elems")):
        with pytest.raises(ValueError, match=match):
            mu.stripe_plan(*args)
        with pytest.raises(ValueError, match=match):
            _jmu().stripe_plan(*args)


def test_striped_hop_schedule_ordering():
    assert mu.hop_schedule(0, mode="striped") == []
    for k in (1, 2, 5):
        sched = mu.hop_schedule(k, mode="striped")
        assert sched == _jmu().hop_schedule(k, mode="striped")
        assert len(sched) == 6 * k
        pos = {pair: i for i, pair in enumerate(sched)}
        for b in range(k):
            for path in ("dcn", "ici"):
                assert pos[(f"{path}_path_scatter", b)] \
                    < pos[(f"{path}_path_exchange", b)] \
                    < pos[(f"{path}_path_gather", b)]
            assert pos[("dcn_path_scatter", b)] \
                < pos[("ici_path_scatter", b)]
            assert pos[("dcn_path_gather", b)] < pos[("ici_path_gather", b)]
        last_phase1 = max(pos[(f"{p}_path_{op}", b)] for b in range(k)
                          for p in ("dcn", "ici")
                          for op in ("scatter", "exchange"))
        first_gather = min(pos[(f"{p}_path_gather", b)] for b in range(k)
                           for p in ("dcn", "ici"))
        assert last_phase1 < first_gather
    with pytest.raises(ValueError, match="mode"):
        mu.hop_schedule(1, mode="diagonal")


def test_striped_bytes_conservation_and_share():
    for n, intra, inter, ratio in ((3200, 4, 2, 0.25), (3200, 4, 2, 0.5),
                                   (1 << 20, 8, 4, 0.75)):
        paths = mu.striped_exchanged_bytes(n, intra, inter, ratio)
        assert paths == _jmu().striped_exchanged_bytes(n, intra, inter,
                                                       ratio)
        total = paths["ici_path"]["total"] + paths["dcn_path"]["total"]
        assert total == mu.exchanged_bytes(n, intra * inter, "psum")
        assert paths["dcn_path"]["total"] / total == ratio
        assert paths["ici_path"]["ici"] > paths["ici_path"]["dcn"] \
            or ratio == 1.0
        assert paths["dcn_path"]["dcn"] > paths["dcn_path"]["ici"]


def test_striped_bytes_degenerate_ratios():
    flat = mu.exchanged_bytes(3200, 8, "psum")
    r0 = mu.striped_exchanged_bytes(3200, 4, 2, 0.0)
    assert r0["dcn_path"]["total"] == 0 and r0["ici_path"]["total"] == flat
    r1 = mu.striped_exchanged_bytes(3200, 4, 2, 1.0)
    assert r1["ici_path"]["total"] == 0 and r1["dcn_path"]["total"] == flat
    for ratio in (0.0, 1.0):
        assert mu.striped_exchanged_bytes(3200, 4, 2, ratio) \
            == _jmu().striped_exchanged_bytes(3200, 4, 2, ratio)


def test_striped_bytes_dcn_dtype_halves_only_dcn_fabric():
    f32 = mu.striped_exchanged_bytes(3200, 4, 2, 0.5)
    bf16 = mu.striped_exchanged_bytes(3200, 4, 2, 0.5, dcn_itemsize=2)
    assert bf16 == _jmu().striped_exchanged_bytes(3200, 4, 2, 0.5,
                                                  dcn_itemsize=2)
    assert bf16["ici_path"]["ici"] == f32["ici_path"]["ici"]
    assert bf16["dcn_path"]["ici"] == f32["dcn_path"]["ici"]
    assert bf16["ici_path"]["dcn"] * 2 == f32["ici_path"]["dcn"]
    assert bf16["dcn_path"]["dcn"] * 2 == f32["dcn_path"]["dcn"]


def test_derived_stripe_ratio_matches_jax():
    """``derived_stripe_ratio`` and ``stripe_plan_from_measurement`` (the
    JAX ``test_autotune.py`` properties): the 1:3 seed ratio gives the
    default, the ratio is clamped open, bad bandwidths raise."""
    jmu = _jmu()
    assert mu.derived_stripe_ratio(3.0, 1.0) == mu.DEFAULT_STRIPE_RATIO
    for b_ici, b_dcn in ((3.0, 1.0), (100.0, 1e-9), (1e-9, 100.0),
                         (25.0, 12.5), (1, 1)):
        assert mu.derived_stripe_ratio(b_ici, b_dcn) \
            == jmu.derived_stripe_ratio(b_ici, b_dcn)
        assert 0 < mu.derived_stripe_ratio(b_ici, b_dcn) < 1
        assert mu.stripe_plan_from_measurement(1000, b_ici, b_dcn) \
            == jmu.stripe_plan_from_measurement(1000, b_ici, b_dcn)
    for bad in ((0, 1), (1, -1), (float("inf"), 1), (float("nan"), 1)):
        with pytest.raises(ValueError, match="bandwidths"):
            mu.derived_stripe_ratio(*bad)


# -- the knobs (a world of one) ---------------------------------------------------

def _make_comm(*args, **kw):
    return factory.create_communicator(*args, device="cpu", **kw)


def test_communicator_stripe_knobs():
    comm = _make_comm("hierarchical", stripe_ratio=0.25)
    try:
        assert comm.striped and comm.stripe_ratio == 0.25
        assert comm.topology == "striped"
        assert "stripe_ratio=0.25" in repr(comm)
        assert comm._hand_knobs["stripe_ratio"]
        assert len(comm._path_groups) == 2   # the DCN path's own pair
    finally:
        comm.finalize()
    comm = _make_comm("hierarchical", stripe_ratio=0.0)
    try:
        assert not comm.striped and comm.topology == "hierarchical"
        assert comm._path_groups == ()
    finally:
        comm.finalize()
    for kw in (dict(communicator_name="hierarchical", stripe_ratio=1.5),
               dict(communicator_name="jax_ici", stripe_ratio=0.5)):
        with pytest.raises(ValueError, match="stripe_ratio"):
            _make_comm(**kw)
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_stripe_ratio_env_knob(monkeypatch):
    monkeypatch.setenv("CHAINERMN_TPU_STRIPE_RATIO", "0.5")
    for kw, want in ((dict(), 0.5), (dict(stripe_ratio=0.25), 0.25)):
        comm = _make_comm("hierarchical", **kw)
        try:
            assert comm.striped and comm.stripe_ratio == want
            assert comm._hand_knobs["stripe_ratio"]
        finally:
            comm.finalize()
    flat = _make_comm("jax_ici")
    try:
        assert not flat.striped and flat.stripe_ratio == 0.0
    finally:
        flat.finalize()


def test_hierarchy_flat_hatch_drops_striping(monkeypatch):
    monkeypatch.setenv("CHAINERMN_TPU_HIERARCHY", "flat")
    monkeypatch.setattr(factory, "_WARNED_FLAT_STRIPES", set())
    with pytest.warns(UserWarning, match="stripe_ratio"):
        comm = _make_comm("hierarchical", stripe_ratio=0.25)
    try:
        assert comm.hierarchy is None and not comm.striped
        assert comm.topology == "flat"
    finally:
        comm.finalize()


def test_exchange_vocabulary_and_knobs():
    assert "striped" in factory.EXCHANGES and "striped_rs" in factory.EXCHANGES
    assert factory.exchange_knobs("striped") \
        == ("hierarchical", True, "allreduce")
    assert factory.exchange_knobs("striped_rs") \
        == ("hierarchical", True, "reduce_scatter")
    assert mu.DEFAULT_STRIPE_RATIO == _jmu().DEFAULT_STRIPE_RATIO == 0.25


def test_the_jax_refusals():
    """A quantized wire with the striped sharded update; ``"dcn"`` without
    a stripe or with the reduce-scatter exchange; ZeRO with double
    buffering: refused as in the JAX package."""
    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    q = _make_comm("hierarchical", stripe_ratio=0.5,
                   allreduce_grad_dtype={"dcn": "int8"})
    try:
        for kw in (RS, dict(zero_sharding=True)):
            with pytest.raises(ValueError, match="STRIPED sharded"):
                create_multi_node_optimizer(MomentumSGD(lr=0.1), q, **kw)
        # the allreduce striped exchange takes the quantized wire
        assert create_multi_node_optimizer(MomentumSGD(lr=0.1), q, **DCN)
        with pytest.raises(ValueError, match="reduce_scatter"):
            create_multi_node_optimizer(MomentumSGD(lr=0.1), q, **DCN, **RS)
        with pytest.raises(ValueError, match="zero_sharding"):
            create_multi_node_optimizer(MomentumSGD(lr=0.1), q, **DCN,
                                        zero_sharding=True)
    finally:
        q.finalize()
    plain = _make_comm("hierarchical")
    try:
        with pytest.raises(ValueError, match="stripe_ratio > 0"):
            create_multi_node_optimizer(MomentumSGD(lr=0.1), plain, **DCN)
    finally:
        plain.finalize()


# -- the 4-rank world (the worker runs in the spawned ranks) -----------------------

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


def _striped_worker(rank, x, t, out_dir, jax_snapshots):
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.serializers import load_npz, save_npz
    rows = N // WORLD
    xs = torch.from_numpy(x[rank * rows:(rank + 1) * rows])
    ts = torch.from_numpy(t[rank * rows:(rank + 1) * rows]).long()
    split = dict(device="cpu", intra_size=INTRA, inter_size=INTER)

    def striped(ratio=RATIO, **kw):
        return create_communicator("hierarchical", stripe_ratio=ratio,
                                   **split, **kw)

    comms = {
        "flat": create_communicator("jax_ici", device="cpu"),
        "flat_bf16": create_communicator("jax_ici", device="cpu",
                                         allreduce_grad_dtype="bfloat16"),
        "s": striped(),
        "s_bucketed": striped(batch_collectives="bucketed",
                              bucket_mb=TINY_BUCKET_MB),
        "s_r1": striped(1.0),
        "s_bf16": striped(allreduce_grad_dtype="bfloat16"),
        "s_dcn_bf16": striped(allreduce_grad_dtype={"dcn": "bfloat16"}),
        "s_q": striped(allreduce_grad_dtype={"dcn": "int8"}),
    }
    s = comms["s"]
    out = {"index": s.striped_chunk_specs()}

    def run(comm, steps, **kw):
        model, opt = _make(comms[comm], **kw)
        comms[comm].calls.clear()
        losses, params = [], []
        for _ in range(steps):
            losses.append(opt.update(model, xs, ts).item())
            params.append(_params_of(model))
        r = {"losses": losses, "params": params,
             "buckets": len(comms[comm].grad_buckets_for(model)),
             "calls": dict(comms[comm].calls),
             "grad": [p.grad for _, p in sorted(model.namedparams())]}
        if opt._sharded_update:
            r["segments"] = opt._segments()
            r["state"] = {k: {slot: v.clone() for slot, v in st.items()
                              if isinstance(v, torch.Tensor)}
                          for k, st in opt.actual_optimizer._state.items()}
        if opt._db_dcn:
            r["stale_len"] = (opt._stale_dcn.wait().numel(),
                              comms[comm].grad_dcn_stale_len_for(model))
        return r

    for label, comm, kw, steps in RUNS:
        out[label] = run(comm, steps, **kw)

    # the two chunk orders of the striped reduce-scatter, and the gather
    pair = {k: torch.arange(24, dtype=torch.float32) * (rank + 1)
            + (0 if k == "ici" else 100) for k in ("dcn", "ici")}
    out["rs_pair"] = s.reduce_scatter_grad(pair).wait()
    out["gathered"] = s.allgather_flat(out["rs_pair"])

    # bitwise resumes
    for label, comm, kw in RESUMES:
        model, opt = _make(comms[comm], **kw)
        for _ in range(2):
            opt.update(model, xs, ts)
        path = os.path.join(out_dir, f"{label}_rank{rank}.npz")
        save_npz(path, opt)
        cont_ref = [opt.update(model, xs, ts).item() for _ in range(2)]
        model_b, opt_b = _make(comms[comm], **kw)
        opt_b.update(model_b, xs, ts)
        load_npz(path, opt_b)
        cont = [opt_b.update(model_b, xs, ts).item() for _ in range(2)]
        out[f"resume_{label}"] = (cont_ref, cont, _params_of(model),
                                  _params_of(model_b))

    # the JAX package's snapshots, loaded and continued
    for label, kw in (("zero", dict(zero_sharding=True)), ("dcn_stale", DCN)):
        model, opt = _make(s, **kw)
        opt.update(model, xs, ts)
        load_npz(jax_snapshots[label], opt)
        out[f"jax_{label}"] = (opt.t, [opt.update(model, xs, ts).item()
                                       for _ in range(2)], _params_of(model))
    # a split of a striped communicator is flat (the JAX package's rule)
    half = s.split(rank // INTRA, rank)
    out["split"] = (half.name, half.hierarchy, half.size,
                    half.allreduce(torch.tensor([float(rank)]))[0].item())
    half.finalize()
    shapes = [(7,), (33,), (5, 5)]
    out["lengths"] = (comms["s_q"].grad_residual_len(
        shapes, [torch.float32] * 3), s.grad_dcn_stale_len(
        shapes, [torch.float32] * 3))
    return out


# -- the JAX references (this process) ------------------------------------------

def _jax_runs(x, t, tmp):
    import jax
    import jax.numpy as jnp
    import chainermn_tpu as ct
    from chainermn_tpu.core.optimizer import MomentumSGD
    from chainermn_tpu.models import MLP, Classifier
    from chainermn_tpu.serializers import save_npz
    x, t = jnp.asarray(x), jnp.asarray(t)

    def comm_(ratio=RATIO, dtype=None, **kw):
        return ct.create_communicator(
            "hierarchical", devices=jax.devices()[:WORLD], inter_size=INTER,
            stripe_ratio=ratio, allreduce_grad_dtype=dtype, **kw)

    def make(comm, **kw):
        model = Classifier(MLP(n_units=16, n_out=K, seed=0))
        comm.bcast_data(model)
        return model, ct.create_multi_node_optimizer(
            MomentumSGD(lr=0.1, momentum=0.9), comm, **kw).setup(model)

    def params_of(model):
        return {p: np.asarray(v.array) for p, v in model.namedparams()}

    def run(comm, steps, **kw):
        model, opt = make(comm, **kw)
        losses, params = [], []
        for _ in range(steps):
            losses.append(float(opt.update(model, x, t)))
            params.append(params_of(model))
        return {"losses": losses, "params": params}

    out = {"striped": run(comm_(), STEPS),
           "striped_bucketed": run(comm_(batch_collectives="bucketed",
                                         bucket_mb=TINY_BUCKET_MB), STEPS),
           "striped_rs": run(comm_(), STEPS, **RS),
           "striped_zero": run(comm_(), STEPS, zero_sharding=True),
           "db_striped": run(comm_(), 4, **DB),
           "db_striped_rs": run(comm_(), 4, **DB, **RS),
           "dcn_stale": run(comm_(), 4, **DCN),
           "bf16_striped": run(comm_(dtype="bfloat16"), 5),
           "dcn_bf16": run(comm_(dtype={"dcn": "bfloat16"}), 5),
           "int8": run(comm_(dtype={"dcn": "int8"}), 5)}
    snapshots = {}
    for label, kw in (("zero", dict(zero_sharding=True)), ("dcn_stale", DCN)):
        model, opt = make(comm_(), **kw)
        for _ in range(2):
            opt.update(model, x, t)
        snapshots[label] = str(tmp / f"jax_{label}.npz")
        save_npz(snapshots[label], opt)
        out[f"continued_{label}"] = (
            [float(opt.update(model, x, t)) for _ in range(2)],
            params_of(model))
    q = comm_(dtype={"dcn": "int8"})
    shapes = [(7,), (33,), (5, 5)]
    stripes = comm_()
    model, _ = make(stripes)
    model(x, t)   # the lazy parameters
    out["lengths"] = (q.grad_residual_len(shapes, [jnp.float32] * 3),
                      stripes.grad_dcn_stale_len_for(model))
    out["stale_len_shapes"] = sum(
        mu.stripe_plan(sum(int(np.prod(shapes[i])) for i in idx), RATIO)[1]
        for idx in comm_().grad_buckets(shapes, [jnp.float32] * 3))
    return out, snapshots


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    x, t = _data()
    tmp = tmp_path_factory.mktemp("striped")
    jax_out, snapshots = _jax_runs(x, t, tmp)
    ranks = spawn_ranks(tmp, _striped_worker, world=WORLD, x=x, t=t,
                        out_dir=str(tmp), jax_snapshots=snapshots)
    return ranks, jax_out


def _close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for p in want:
        np.testing.assert_allclose(np.asarray(got[p]), np.asarray(want[p]),
                                   err_msg=p, **tol)


def _equal(a, b):
    return sorted(a) == sorted(b) and all(torch.equal(a[p], b[p]) for p in a)


def _matches(got, ref, tol):
    np.testing.assert_allclose(got["losses"], ref["losses"], **tol)
    for a, b in zip(got["params"], ref["params"]):
        _close(a, b, **tol)


# -- the exchange ----------------------------------------------------------------

@pytest.mark.parametrize("flavor,flat", [
    ("striped", "flat"), ("striped_bucketed", "flat"),
    ("striped_rs", "flat"), ("striped_zero", "flat"),
    ("db_striped", "db_flat"), ("db_striped_rs", "db_flat")])
def test_flavor_matches_flat_and_jax(runs, flavor, flat):
    """``test_exchange_equivalence.py:110``'s and ``:135``'s striped
    twins: each flavor equals the flat exchange (or the flat
    double-buffered one) on the same ranks and the JAX 2 x 2 run; every
    rank ends with the same parameters."""
    ranks, jax_out = runs
    for r in ranks:
        _matches(r[flavor], r[flat], FLAT_TOL)
        _matches(r[flavor], jax_out[flavor], JAX_TOL)
        assert _equal(r[flavor]["params"][-1],
                      ranks[0][flavor]["params"][-1])
    if flavor.startswith("db_"):
        assert ranks[0][flavor]["losses"][0] == ranks[0][flavor]["losses"][1]


def test_striped_bf16_composes(runs):
    """``:200``'s twin: bf16 on both hops within bf16 rounding of the flat
    bf16 run; ``{"dcn": "bfloat16"}`` within it of the lossless striped
    run; both learn and track the JAX runs."""
    ranks, jax_out = runs
    for r in ranks:
        h = r["bf16_striped"]["losses"]
        np.testing.assert_allclose(h, r["bf16_flat"]["losses"],
                                   rtol=BF16_RTOL)
        assert np.isfinite(h).all() and h[-1] < h[0]
        _matches(r["lossless5"], r["flat5"], FLAT_TOL)
        d = r["dcn_bf16"]["losses"]
        np.testing.assert_allclose(d, r["lossless5"]["losses"],
                                   rtol=BF16_RTOL)
        np.testing.assert_allclose(d, r["flat5"]["losses"], rtol=BF16_RTOL)
        assert d[-1] < d[0] and d != r["lossless5"]["losses"]
        for label in ("bf16_striped", "dcn_bf16"):
            np.testing.assert_allclose(r[label]["losses"],
                                       jax_out[label]["losses"],
                                       rtol=BF16_RTOL)


def test_int8_with_feedback(runs):
    """``{"dcn": "int8"}`` on both paths' DCN crossings, error feedback
    on: within the quantized band of the lossless run, and tracking the
    JAX int8 striped run."""
    ranks, jax_out = runs
    for r in ranks:
        q = r["int8"]["losses"]
        for lossless in (r["lossless5"]["losses"], r["flat5"]["losses"]):
            assert q != lossless and q[-1] < q[0]
            assert abs(q[-1] - lossless[-1]) <= LOSS_BAND * abs(lossless[-1])
        np.testing.assert_allclose(q, jax_out["int8"]["losses"],
                                   rtol=INT8_JAX_RTOL)


def test_striped_dcn_only_stale_degenerates(runs):
    """``:218``'s twin: at ratio 1 ``double_buffering="dcn"`` is full
    double buffering; at 0.5 it is a third trajectory that learns; its
    stale buffer is the DCN-path slices only; it tracks the JAX run."""
    ranks, jax_out = runs
    for r in ranks:
        assert r["r1_dcn_stale"]["losses"] == r["r1_full_stale"]["losses"]
        assert all(_equal(a, b) for a, b in zip(
            r["r1_dcn_stale"]["params"], r["r1_full_stale"]["params"]))
        _matches(r["r1_dcn_stale"], r["db_flat"], FLAT_TOL)
        mid = r["dcn_stale"]["losses"]
        assert np.isfinite(mid).all() and mid[-1] < mid[0]
        assert mid != r["fresh4"]["losses"]
        assert mid != r["db_striped"]["losses"]
        n, want = r["dcn_stale"]["stale_len"]
        assert n == want > 0
        _matches(r["dcn_stale"], jax_out["dcn_stale"], JAX_TOL)


@pytest.mark.parametrize("label", [label for label, _, _ in RESUMES])
def test_resume_bitwise(runs, label):
    """``:253``, ``:272`` and ``:419``'s twins: the stale DCN buffer, the
    striped sharded update's stale pair and state, and the int8 residual
    (plain and with the stale DCN buffer) survive a save, load and
    continue bitwise."""
    ranks, _ = runs
    for r in ranks:
        cont_ref, cont, params_ref, params = r[f"resume_{label}"]
        assert cont == cont_ref
        assert _equal(params, params_ref)


@pytest.mark.parametrize("label", ["zero", "dcn_stale"])
def test_jax_snapshot_resumes(runs, label):
    """A JAX 2 x 2 snapshot of the striped ZeRO state (the ``{"ici",
    "dcn"}`` pair) and of the stale DCN buffer loads into each rank and
    continues as the JAX run does."""
    ranks, jax_out = runs
    want_losses, want_params = jax_out[f"continued_{label}"]
    for r in ranks:
        t, losses, params = r[f"jax_{label}"]
        assert t == 2
        np.testing.assert_allclose(losses, want_losses, **JAX_TOL)
        _close(params, want_params, **JAX_TOL)


def test_two_chunk_orders_at_two_by_two(runs):
    """The ICI-path slice's chunks land fast-hop-major (ranks 0-3 own 0,
    2, 1, 3), the DCN-path slice's slow-hop-major (0, 1, 2, 3), in the
    reduce-scatter, the sharded layout and the gather that rebuilds each
    slice."""
    ranks, _ = runs
    total = sum(r + 1 for r in range(WORLD))
    mean = {k: (np.arange(24, dtype=np.float32) * total
                + WORLD * (0 if k == "ici" else 100)) / WORLD
            for k in ("dcn", "ici")}
    assert [r["index"] for r in ranks] == [(0, 0), (2, 1), (1, 2), (3, 3)]
    for r in ranks:
        fast, slow = r["index"]
        for k, c in (("ici", fast), ("dcn", slow)):
            np.testing.assert_array_equal(r["rs_pair"][k].numpy(),
                                          mean[k][c * 6:(c + 1) * 6])
            np.testing.assert_array_equal(r["gathered"][k].numpy(), mean[k])
        segments = {seg[0]: seg for seg in r["striped_rs"]["segments"]}
        for k, c in (("ici", fast), ("dcn", slow)):
            _, _, _, n_pad, lo, hi = segments[k]
            assert (lo, hi) == (c * n_pad // WORLD, (c + 1) * n_pad // WORLD)
        assert sorted(r["striped_rs"]["state"]) == ["dcn", "ici"]


def test_one_of_each_striped_op_per_bucket_per_step(runs):
    """The calls per op (the port's stand-in for the JAX census): the six
    ops of the schedule once per bucket per step (the quantized DCN path
    needs no gather), the sharded update's scatters and gathers once per
    step."""
    ranks, _ = runs
    for r in ranks:
        for label in ("striped", "striped_bucketed", "int8"):
            run = r[label]
            ops = [op for op in STRIPED_OPS
                   if not (label == "int8" and op == "dcn_path_gather")]
            calls = {k: v for k, v in run["calls"].items()
                     if k not in ("bcast", "allreduce")}
            assert calls == {op: run["buckets"] * len(run["losses"])
                             for op in ops}, label
        assert r["striped_bucketed"]["buckets"] > 1
        calls = {k: v for k, v in r["striped_rs"]["calls"].items()
                 if k not in ("bcast", "allreduce")}
        assert calls == {op: STEPS for op in STRIPED_OPS}


def test_split_of_a_striped_communicator_is_flat(runs):
    """``split`` by node gives a flat communicator over the node's ranks
    (a hierarchical name there would try to split the color's ranks
    again), as the JAX ``split`` does."""
    ranks, _ = runs
    for rank, r in enumerate(ranks):
        node = rank // INTRA
        assert r["split"] == ("jax_ici", None, INTRA,
                              float(sum(range(node * INTRA,
                                              (node + 1) * INTRA))))


def test_grad_not_populated_and_lengths_match_jax(runs):
    """``:309``'s twin (the striped sharded update leaves
    ``Parameter.grad`` unset), and the residual and stale-buffer lengths
    of the JAX communicator (``test_grad_dcn_stale_len_matches_plan``)."""
    ranks, jax_out = runs
    for r in ranks:
        assert all(g is None for g in r["striped_rs"]["grad"])
        assert r["lengths"][0] == jax_out["lengths"][0]
        assert r["lengths"][1] == jax_out["stale_len_shapes"] > 0
        assert r["dcn_stale"]["stale_len"][1] == jax_out["lengths"][1]
