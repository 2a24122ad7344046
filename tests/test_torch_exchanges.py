"""The double-buffered, reduce-scatter and ZeRO-1 exchanges against the
plain data-parallel step and the JAX package's, in one 2-rank gloo world.

The model and data are ``tests/core_tests/test_zero_sharding.py``'s: a
``Classifier(MLP(n_units=16, n_out=3, seed=0))`` on a numpy-seeded batch
of 16 examples of 12 features, each rank feeding its half; the JAX runs
use ``create_communicator("jax_ici")`` over 2 of the CPU devices of
``tests/conftest.py`` on the whole batch.  The checks mirror
``tests/core_tests/test_zero_sharding.py`` and
``tests/integration_tests/test_mnist_dp.py:92-186``.

Tolerances: the port's exchanges against each other BITWISE (at 2 ranks
the reduce-scatter's sum, cast and halving give the allreduce's bits,
and the rule is the same fp32 elementwise code on a flat view); against
the JAX runs 1e-5 absolute (two frameworks, other summation orders, as
``test_torch_multi_node_optimizer.py``); the ZeRO ``GradientClipping``
against the plain one 1e-6 relative (the sharded clip scales by
``threshold / norm`` where the plain one computes ``g / norm *
threshold``, the JAX package's two formulas); a resume in a world of one
from a 2-rank snapshot 1e-5 (one rank sums the batch in another order).
"""

import os

import numpy as np
import pytest
import torch

from tests.test_torch_communicator import spawn_ranks

STEPS = 4
N, D, K = 16, 12, 3
SGD_KW = dict(lr=0.1, momentum=0.9)
ADAM_KW = dict(alpha=1e-2)
JAX_TOL = dict(rtol=0, atol=1e-5)
#: the runs of the worker: (label, optimizer, create_multi_node_optimizer
#: keywords, hooks)
RUNS = [(f"{flavor}_{opt}", opt, kw, ())
        for opt in ("momentum", "adam")
        for flavor, kw in (("plain", {}),
                           ("rs", dict(exchange="reduce_scatter")),
                           ("zero", dict(zero_sharding=True)))] + [
    ("db_sgd", "sgd", dict(double_buffering=True), ()),
    ("plain_sgd", "sgd", {}, ()),
    ("db_rs_sgd", "sgd", dict(double_buffering=True,
                              exchange="reduce_scatter"), ()),
    ("plain_clip", "momentum", {}, ("clip",)),
    ("zero_clip", "momentum", dict(zero_sharding=True), ("clip",)),
]


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 1, (N, D)).astype(np.float32),
            rng.randint(0, K, N).astype(np.int32))


def _params_of(model):
    return {p: v.detach().clone() for p, v in model.namedparams()}


# -- worker (runs in the spawned ranks) ---------------------------------------

def _make(opt_name, comm, hooks=(), **kw):
    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.core.optimizer import (SGD, Adam,
                                                    GradientClipping,
                                                    MomentumSGD)
    from chainermn_tpu_torch.models import MLP, Classifier
    model = Classifier(MLP(n_units=16, n_out=K, seed=0, device="cpu"))
    comm.bcast_data(model)
    actual = {"momentum": lambda: MomentumSGD(**SGD_KW),
              "adam": lambda: Adam(**ADAM_KW),
              "sgd": lambda: SGD(lr=0.1)}[opt_name]()
    opt = create_multi_node_optimizer(actual, comm, **kw).setup(model)
    for hook in hooks:
        opt.add_hook({"clip": lambda: GradientClipping(0.05)}[hook]())
    return model, opt


def _exchanges_worker(rank, x, t, out_dir):
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.core.optimizer import GradientClipping, _Hook
    from chainermn_tpu_torch.serializers import load_npz, save_npz
    half = N // 2
    xs = torch.from_numpy(x[rank * half:(rank + 1) * half])
    ts = torch.from_numpy(t[rank * half:(rank + 1) * half]).long()
    comm = create_communicator("pure_nccl", device="cpu")
    out = {}

    for label, opt_name, kw, hooks in RUNS:
        model, opt = _make(opt_name, comm, hooks, **kw)
        comm.calls.clear()
        losses, params = [], []
        for _ in range(STEPS):
            losses.append(opt.update(model, xs, ts).item())
            params.append(_params_of(model))
        out[label] = {"losses": losses, "params": params, "t": opt.t}
        if label == "zero_momentum":
            st = opt.actual_optimizer._state
            out["zero_state"] = (sorted(st), st["flat"]["trace"].numel(),
                                 opt._flat_layout())
            out["zero_grads"] = [p.grad for p in model.parameters()]
            out["zero_calls"] = dict(comm.calls)

    # the bf16 wire: the ZeRO step against the plain one on that wire
    bf16 = create_communicator("pure_nccl", device="cpu",
                               allreduce_grad_dtype="bfloat16")
    for label, kw in (("bf16_plain", {}),
                      ("bf16_zero", dict(zero_sharding=True))):
        model, opt = _make("momentum", bf16, **kw)
        out[label] = [opt.update(model, xs, ts).item() for _ in range(6)]
        out[label + "_params"] = _params_of(model)

    # a hook that is neither chunk_local nor sharded-aware
    class CustomGlobalHook(_Hook):
        name = "CustomGlobalHook"

        def __call__(self, params, grads):
            return grads

    model, opt = _make("momentum", comm, zero_sharding=True)
    opt.add_hook(CustomGlobalHook())
    try:
        opt.update(model, xs, ts)
        out["unmarked_hook"] = None
    except ValueError as e:
        out["unmarked_hook"] = str(e)

    # add_hook under double buffering starts again from zeros
    model, opt = _make("sgd", comm, double_buffering=True)
    for _ in range(3):
        opt.update(model, xs, ts)
    opt.add_hook(GradientClipping(1.0))
    before = _params_of(model)
    opt.update(model, xs, ts)
    out["db_add_hook_moved"] = any(
        not torch.equal(before[p], v) for p, v in _params_of(model).items())

    # resume: save after 3 steps, continue 2; a fresh pair loads and
    # continues 2 (every rank writes: the sharded state is gathered)
    for label, opt_name, kw in (
            ("db", "sgd", dict(double_buffering=True)),
            ("db_rs", "adam", dict(double_buffering=True,
                                   exchange="reduce_scatter")),
            ("zero_sgd", "momentum", dict(zero_sharding=True)),
            ("zero_adam", "adam", dict(zero_sharding=True))):
        model, opt = _make(opt_name, comm, **kw)
        for _ in range(3):
            opt.update(model, xs, ts)
        path = os.path.join(out_dir, f"{label}_rank{rank}.npz")
        save_npz(path, opt)
        for _ in range(2):
            opt.update(model, xs, ts)
        model_b, opt_b = _make(opt_name, comm, **kw)
        load_npz(path, opt_b)
        t_loaded = opt_b.t
        for _ in range(2):
            opt_b.update(model_b, xs, ts)
        out[f"resume_{label}"] = (
            t_loaded, _params_of(model), _params_of(model_b))
        if label == "zero_adam":
            out["zero_adam_path"] = path
            out["zero_adam_continued"] = _params_of(model)

    # a 2-rank ZeRO snapshot resumed in a world of one (this rank alone,
    # the whole batch)
    alone = comm.split(color=rank, key=0)
    model_c, opt_c = _make("adam", alone, zero_sharding=True)
    load_npz(out["zero_adam_path"], opt_c)
    for _ in range(2):
        opt_c.update(model_c, torch.from_numpy(x),
                     torch.from_numpy(t).long())
    out["resume_world_of_one"] = (opt_c.t, opt_c._flat_layout(),
                                  _params_of(model_c))
    return out


# -- the JAX references (this process) ------------------------------------------

def _jax_runs(x, t):
    import jax
    import jax.numpy as jnp
    import chainermn_tpu as ct
    from chainermn_tpu.core.optimizer import (SGD, Adam, GradientClipping,
                                              MomentumSGD)
    from chainermn_tpu.models import MLP, Classifier
    make = {"momentum": lambda: MomentumSGD(**SGD_KW),
            "adam": lambda: Adam(**ADAM_KW), "sgd": lambda: SGD(lr=0.1)}
    out = {}
    for label, opt_name, kw, hooks in RUNS:
        comm = ct.create_communicator("jax_ici", devices=jax.devices()[:2])
        model = Classifier(MLP(n_units=16, n_out=K, seed=0))
        comm.bcast_data(model)
        opt = ct.create_multi_node_optimizer(make[opt_name](), comm,
                                             **kw).setup(model)
        for hook in hooks:
            opt.add_hook(GradientClipping(0.05))
        losses, params = [], []
        for _ in range(STEPS):
            losses.append(float(opt.update(model, jnp.asarray(x),
                                           jnp.asarray(t))))
            params.append({p: np.asarray(v.array)
                           for p, v in model.namedparams()})
        out[label] = {"losses": losses, "params": params}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    x, t = _data()
    tmp = tmp_path_factory.mktemp("exchanges")
    ranks = spawn_ranks(tmp, _exchanges_worker, x=x, t=t, out_dir=str(tmp))
    return ranks, _jax_runs(x, t)


def _equal(a, b):
    return sorted(a) == sorted(b) and all(torch.equal(a[p], b[p]) for p in a)


def _close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for p in want:
        np.testing.assert_allclose(np.asarray(got[p]), np.asarray(want[p]),
                                   err_msg=p, **tol)


# -- tests ----------------------------------------------------------------------

@pytest.mark.parametrize("opt", ["momentum", "adam"])
@pytest.mark.parametrize("flavor", ["rs", "zero"])
def test_sharded_update_equals_plain_dp_and_the_jax_run(runs, flavor, opt):
    ranks, jax_out = runs
    plain = ranks[0][f"plain_{opt}"]
    for r in ranks:
        got = r[f"{flavor}_{opt}"]
        assert got["losses"] == plain["losses"]
        assert all(_equal(a, b) for a, b in zip(got["params"],
                                                plain["params"]))
        assert got["t"] == STEPS
    want = jax_out[f"{flavor}_{opt}"]
    np.testing.assert_allclose(plain["losses"], want["losses"], **JAX_TOL)
    for got_p, want_p in zip(plain["params"], want["params"]):
        _close(got_p, want_p, **JAX_TOL)


def test_plain_runs_equal_the_jax_plain_runs(runs):
    ranks, jax_out = runs
    for opt in ("momentum", "adam", "sgd"):
        got, want = ranks[0][f"plain_{opt}"], jax_out[f"plain_{opt}"]
        np.testing.assert_allclose(got["losses"], want["losses"], **JAX_TOL)
        _close(got["params"][-1], want["params"][-1], **JAX_TOL)


@pytest.mark.parametrize("label", ["db_sgd", "db_rs_sgd"])
def test_double_buffering_is_one_step_stale(runs, label):
    """Update 1 applies zeros; update 2 applies step 1's mean gradient,
    taken at the initial weights, so the parameters after update 2 are
    the plain run's after update 1 (bitwise: the same mean gradient, the
    same rule)."""
    ranks, jax_out = runs
    start = ranks[0]["plain_sgd"]
    for r in ranks:
        db = r[label]
        plain = r["plain_sgd"]
        # SGD without momentum: step 1 moves nothing
        model_init = _params_of_jax_init(jax_out)
        _close(db["params"][0], model_init, rtol=0, atol=0)
        assert _equal(db["params"][1], plain["params"][0])
        assert db["losses"][:2] == [start["losses"][0]] * 2


def _params_of_jax_init(jax_out):
    """The shared initial weights: the JAX plain SGD run's step 1 minus
    its update is not exact, so rebuild them from the seed."""
    from chainermn_tpu_torch.models import MLP, Classifier
    model = Classifier(MLP(n_units=16, n_out=K, seed=0, device="cpu"))
    model(torch.zeros(1, D), torch.zeros(1, dtype=torch.long))
    return _params_of(model)


def test_double_buffering_equals_the_jax_one_step_stale_run(runs):
    ranks, jax_out = runs
    for label in ("db_sgd", "db_rs_sgd"):
        got, want = ranks[0][label], jax_out["db_sgd"]
        np.testing.assert_allclose(got["losses"], want["losses"], **JAX_TOL)
        for got_p, want_p in zip(got["params"], want["params"]):
            _close(got_p, want_p, **JAX_TOL)


def test_zero_state_is_one_chunk_per_rank(runs):
    ranks, _ = runs
    n = sum(v.numel() for v in ranks[0]["plain_momentum"]["params"][0]
            .values())
    for rank, r in enumerate(ranks):
        keys, numel, layout = r["zero_state"]
        n_flat, n_pad, start, stop = layout
        assert keys == ["flat"] and n_flat == n
        assert n_pad == -(-n // 2) * 2 and numel == n_pad // 2
        assert (start, stop) == (rank * n_pad // 2, (rank + 1) * n_pad // 2)
        assert r["zero_calls"]["reduce_scatter_grad"] == STEPS
        assert r["zero_calls"]["allgather_flat"] == STEPS


def test_zero_leaves_parameter_grad_unset(runs):
    ranks, _ = runs
    for r in ranks:
        assert all(g is None for g in r["zero_grads"])


def test_zero_on_the_bf16_wire_equals_the_plain_bf16_step(runs):
    ranks, _ = runs
    for r in ranks:
        assert r["bf16_zero"] == r["bf16_plain"]
        assert _equal(r["bf16_zero_params"], r["bf16_plain_params"])
        assert np.isfinite(r["bf16_zero"]).all()
        assert r["bf16_zero"][-1] < r["bf16_zero"][0]


def test_zero_gradient_clipping_takes_the_global_norm(runs):
    ranks, jax_out = runs
    for r in ranks:
        np.testing.assert_allclose(r["zero_clip"]["losses"],
                                   r["plain_clip"]["losses"], rtol=1e-6)
        _close(r["zero_clip"]["params"][-1], r["plain_clip"]["params"][-1],
               rtol=1e-6, atol=1e-7)
    got, want = ranks[0]["zero_clip"], jax_out["zero_clip"]
    np.testing.assert_allclose(got["losses"], want["losses"], **JAX_TOL)
    _close(got["params"][-1], want["params"][-1], **JAX_TOL)
    # the clip engaged: the run differs from the unclipped one
    assert got["losses"][-1] != ranks[0]["plain_momentum"]["losses"][-1]


def test_zero_refuses_an_unmarked_global_hook(runs):
    ranks, _ = runs
    for r in ranks:
        assert r["unmarked_hook"] is not None
        assert "chunk_local" in r["unmarked_hook"]


def test_add_hook_restarts_double_buffering_from_zeros(runs):
    ranks, _ = runs
    assert not any(r["db_add_hook_moved"] for r in ranks)


@pytest.mark.parametrize("label", ["db", "db_rs", "zero_sgd", "zero_adam"])
def test_resume_is_bitwise(runs, label):
    ranks, _ = runs
    for r in ranks:
        t_loaded, uninterrupted, resumed = r[f"resume_{label}"]
        assert t_loaded == 3
        assert _equal(uninterrupted, resumed)


def test_zero_resume_from_two_ranks_in_a_world_of_one(runs):
    ranks, _ = runs
    for r in ranks:
        t, layout, params = r["resume_world_of_one"]
        assert t == 5
        assert layout[1] == layout[0]      # size 1: no padding
        _close({p: v.numpy() for p, v in params.items()},
               {p: v.numpy() for p, v in r["zero_adam_continued"].items()},
               rtol=0, atol=1e-5)


def test_refusals_without_a_world():
    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.communicators import DummyCommunicator
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    comm = DummyCommunicator()
    with pytest.raises(ValueError, match="zero_sharding"):
        create_multi_node_optimizer(MomentumSGD(), comm,
                                    double_buffering=True,
                                    zero_sharding=True)
    with pytest.raises(ValueError, match="redundancy"):
        create_multi_node_optimizer(MomentumSGD(), comm, zero_sharding=True,
                                    exchange="reduce_scatter")
    # the striped exchange's stale variant needs a striped communicator
    # (tests/test_torch_striped_exchange.py runs it); autotune needs a
    # communicator it can tune (tests/test_torch_autotune.py runs it)
    with pytest.raises(ValueError, match="stripe_ratio > 0"):
        create_multi_node_optimizer(MomentumSGD(), comm,
                                    double_buffering="dcn")
    with pytest.raises(ValueError, match="autotune"):
        create_multi_node_optimizer(MomentumSGD(), comm, autotune=True)
    comm.name = "naive"
    with pytest.raises(ValueError, match="fused-bucket"):
        create_multi_node_optimizer(MomentumSGD(), comm,
                                    double_buffering=True)
