"""The port's differentiable collectives against the JAX package's.

One 2-rank gloo world (the harness of ``test_torch_communicator.py``)
runs every function forward and backward on numpy-seeded inputs, each
rank computing its own copy of a loss, and writes its outputs and
gradients; the JAX functions run the same per-rank bodies under a
2-device CPU ``shard_map`` (``run_spmd``), ``jax.grad`` inside the body,
as ``tests/functions_tests/test_collective_communication.py`` runs them.
This pins the port's gradient scaling to the JAX package's (there the
transpose of a sum over ranks hands each rank ``size`` cotangent copies;
here each rank's backward runs the transposed collective).

Tolerance 1e-6 (fp32: a sum of two terms, summed in another order at
most).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_communicator import spawn_ranks

WORLD = 2
TOL = dict(rtol=1e-6, atol=1e-6)
CASES = ["allreduce_sum", "allreduce_mean", "allgather", "gather",
         "alltoall", "bcast", "scatter", "psum_gradient"]


def _inputs():
    """Per-rank inputs (leading axis: the rank) and per-rank weights of
    each loss, numpy seed 0."""
    rng = np.random.RandomState(0)
    return {
        "x": rng.normal(0, 1, (WORLD, 3)).astype(np.float32),
        "w": rng.normal(0, 1, (WORLD, 3)).astype(np.float32),
        # alltoall / scatter: one (WORLD, 3) block per rank
        "xs": rng.normal(0, 1, (WORLD, WORLD, 3)).astype(np.float32),
        "ws": rng.normal(0, 1, (WORLD, WORLD, 3)).astype(np.float32),
    }


def _losses(F, comm, x, w, xs, ws, stack, total):
    """Each case's per-rank loss as a function of its input: the same
    expressions for both packages (``F`` their functions, ``stack`` and
    ``total`` their stack and sum)."""
    return {
        "allreduce_sum": (x, lambda a: total(F.allreduce(comm, a) * w)),
        "allreduce_mean": (x, lambda a: total(
            F.allreduce(comm, a, op="mean") * w)),
        "allgather": (x, lambda a: total(
            stack(F.allgather(comm, a)) * ws)),
        "gather": (x, lambda a: total(stack(F.gather(comm, a)) * ws)),
        "alltoall": (xs, lambda a: total(stack(F.alltoall(comm, a)) * ws)),
        "bcast": (x, lambda a: total(F.bcast(comm, a, root=1) ** 2 * w)),
        "scatter": (xs, lambda a: total(F.scatter(comm, a, root=0) * w)),
        "psum_gradient": (x, lambda a: total(
            F.psum_gradient(comm, a) * w)),
    }


# -- worker (runs in the spawned ranks) ---------------------------------------

def _functions_worker(rank, data):
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch import functions as F
    comm = create_communicator("naive", device="cpu")
    mine = {k: torch.from_numpy(v[rank]) for k, v in data.items()}
    out = {}
    for name, (inp, loss_of) in _losses(
            F, comm, mine["x"], mine["w"], mine["xs"], mine["ws"],
            torch.stack, torch.sum).items():
        a = inp.clone().requires_grad_(True)
        loss = loss_of(a)
        loss.backward()
        g = a.grad
        out[name] = (loss.item(), None if g is None else g.numpy())
    return out


# -- the JAX reference (this process) ------------------------------------------

def _jax_run(data):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    import chainermn_tpu as ct
    from chainermn_tpu import functions as JF
    comm = ct.create_communicator("jax_ici", devices=jax.devices()[:WORLD])
    out = {}
    for name in CASES:
        def body(x, w, xs, ws, name=name):
            inp, loss_of = _losses(JF, comm, x[0], w[0], xs[0], ws[0],
                                   jnp.stack, jnp.sum)[name]
            val, grad = jax.value_and_grad(loss_of)(inp)
            return val.reshape(1), grad[None]
        vals, grads = comm.run_spmd(
            body, *(jnp.asarray(data[k]) for k in ("x", "w", "xs", "ws")),
            out_specs=(P(comm.axis_name), P(comm.axis_name)))
        out[name] = (np.asarray(vals), np.asarray(grads))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data = _inputs()
    ranks = spawn_ranks(tmp_path_factory.mktemp("collectives"),
                        _functions_worker, data=data)
    return ranks, _jax_run(data)


@pytest.mark.parametrize("name", CASES)
def test_forward_and_gradient_equal_the_jax_function(runs, name):
    ranks, jax_out = runs
    vals, grads = jax_out[name]
    for rank, got in enumerate(ranks):
        loss, grad = got[name]
        np.testing.assert_allclose(loss, vals[rank], err_msg=name, **TOL)
        if grad is None:     # no gradient reaches a non-root's input
            np.testing.assert_array_equal(grads[rank], 0, err_msg=name)
        else:
            np.testing.assert_allclose(grad, grads[rank], err_msg=name,
                                       **TOL)


def test_scaling_follows_the_jax_contract(runs):
    """The numbers behind the contract: each rank's gradient of its own
    copy of ``sum(allreduce(x) * w)`` is the sum of every rank's ``w``
    (``size`` cotangent copies summed), and ``psum_gradient`` gives
    their mean."""
    ranks, _ = runs
    w = _inputs()["w"]
    for got in ranks:
        np.testing.assert_allclose(got["allreduce_sum"][1], w.sum(0), **TOL)
        np.testing.assert_allclose(got["allreduce_mean"][1], w.mean(0),
                                   **TOL)
        np.testing.assert_allclose(got["psum_gradient"][1], w.mean(0),
                                   **TOL)
