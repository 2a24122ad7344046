"""The port's data-parallel step against the golden rule and the JAX package.

The golden rule of ``tests/core_tests/test_exchange_equivalence.py``: a
data-parallel run equals the single-process run on the merged batch.  Here
on a tiny fp32 ``TransformerLM`` with Adam for 3 steps, in 2-rank gloo
worlds (the harness of ``test_torch_communicator.py``), each rank feeding
its half of the batch; and against the JAX package's own data-parallel
step (``create_communicator("jax_ici")`` over 2 of the 8 CPU devices of
``tests/conftest.py``) from the same npz weights.

Tolerances: data-parallel against the merged-batch run, rtol 1e-5 (as the
JAX test: the mean of two half-batch means sums in another order than one
full-batch mean); against the JAX package, 1e-5 absolute (as
``tests/test_torch_training.py``: two frameworks, other summation
orders).  The exchange flavors are compared BITWISE with each other.
Adam takes eps = 1e-3, as in ``test_torch_training.py``, so that a
gradient that is 0 up to float noise does not become a full step on one
side only.
"""

import numpy as np
import torch

from chainermn_tpu_torch import (create_communicator,
                                 create_multi_node_iterator,
                                 create_multi_node_optimizer,
                                 create_synchronized_iterator,
                                 scatter_dataset)
from chainermn_tpu_torch.core.optimizer import Adam
from chainermn_tpu_torch.dataset import SerialIterator, concat_examples
from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.serializers import load_npz
from chainermn_tpu_torch.training import StandardUpdater, Trainer
from tests.test_torch_communicator import KW, TINY_BUCKET_MB, _tokens, \
    spawn_ranks

STEPS = 3
ADAM = dict(alpha=3e-3, eps=1e-3)
EXCHANGES = [("per_leaf", "naive", {}),
             ("flat", "flat", {}),
             ("bucketed", "pure_nccl", dict(batch_collectives="bucketed",
                                            bucket_mb=TINY_BUCKET_MB))]


def _params(model):
    return {p: v.detach().clone() for p, v in model.namedparams()}


# -- workers (run in the spawned ranks) --------------------------------------

def _dp_worker(rank, npz, x, t):
    """Each exchange flavor for STEPS steps on this rank's half batch
    (rank 0 loads the weights, bcast_data hands them on), and the eager
    ``update()`` after a hand-made backward."""
    half = len(x) // 2
    xs = torch.from_numpy(x[rank * half:(rank + 1) * half])
    ts = torch.from_numpy(t[rank * half:(rank + 1) * half])
    out = {}
    for label, name, kw in EXCHANGES + [("eager", "flat", {})]:
        comm = create_communicator(name, device="cpu", **kw)
        model = TransformerLM(seed=7 + rank, device="cpu", **KW)
        if rank == 0:
            load_npz(npz, model)
        comm.bcast_data(model)
        opt = create_multi_node_optimizer(Adam(**ADAM), comm).setup(model)
        losses = []
        for _ in range(STEPS):
            if label == "eager":
                model.cleargrads()
                model(xs, ts).backward()
                opt.update()
            else:
                losses.append(opt.update(model, xs, ts).item())
        out[label] = (losses, _params(model), opt.t,
                      comm.calls["allreduce_grad"])
    return out


def _trainer_worker(rank, x, t, out_dir):
    """Trainer -> StandardUpdater -> the multi-node Adam over this rank's
    scatter_dataset shard, iterated in an order synchronized from rank 0;
    then a multi-node iterator that hands every rank rank 0's batches."""
    comm = create_communicator("jax_ici", device="cpu")
    model = TransformerLM(seed=0, device="cpu", **KW)
    comm.bcast_data(model)
    opt = create_multi_node_optimizer(Adam(**ADAM), comm).setup(model)
    shard = scatter_dataset(list(zip(x, t)), comm, shuffle=True, seed=0)
    it = create_synchronized_iterator(
        SerialIterator(shard, 2, shuffle=True, seed=rank), comm)
    seen = []

    def converter(batch, device):
        seen.append(np.stack([row for row, _ in batch]))
        return concat_examples(batch, device)

    trainer = Trainer(StandardUpdater(it, opt, converter=converter),
                      (STEPS, "iteration"), out=f"{out_dir}/rank{rank}")
    losses = []
    trainer.extend(lambda tr: losses.append(
        float(tr.observation["main/loss"])), name="record")
    trainer.run()
    mit = create_multi_node_iterator(
        SerialIterator(list(range(10)), 3, shuffle=True, seed=rank), comm)
    batches = []
    for _ in range(5):
        batch = mit.next()
        batches.append((batch, mit.epoch, mit.is_new_epoch,
                        mit.epoch_detail, mit.previous_epoch_detail))
    return dict(losses=losses, seen=seen, params=_params(model),
                order=it._order.tolist(), batches=batches)


# -- references (this process) -----------------------------------------------

def _single_process(npz, batches):
    model = load_npz(npz, TransformerLM(seed=1, device="cpu", **KW))
    opt = Adam(**ADAM).setup(model)
    losses = [opt.update(model, torch.from_numpy(x),
                         torch.from_numpy(t)).item() for x, t in batches]
    return losses, _params(model)


def _jax_run(x, t, npz):
    """The JAX package's data-parallel step over 2 CPU devices; saves
    its initial weights to ``npz`` first."""
    import jax
    import jax.numpy as jnp
    import chainermn_tpu as ct
    from chainermn_tpu.core import optimizer as JO
    from chainermn_tpu.models import TransformerLM as JaxLM
    from chainermn_tpu.serializers.npz import save_npz

    model = JaxLM(seed=0, **KW)
    save_npz(npz, model)
    comm = ct.create_communicator("jax_ici", devices=jax.devices()[:2])
    comm.bcast_data(model)
    opt = ct.create_multi_node_optimizer(JO.Adam(**ADAM), comm).setup(model)
    losses = [float(opt.update(model, jnp.asarray(x), jnp.asarray(t)))
              for _ in range(STEPS)]
    return losses, {p: np.asarray(v.array) for p, v in model.namedparams()}


def _close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for p in want:
        np.testing.assert_allclose(np.asarray(got[p]), np.asarray(want[p]),
                                   err_msg=p, **tol)


# -- tests --------------------------------------------------------------------

def test_dp_equals_merged_batch_and_the_jax_dp_run(tmp_path):
    x, t = _tokens(4, seed=1)
    npz = str(tmp_path / "init.npz")
    jlosses, jparams = _jax_run(x, t, npz)
    r0, r1 = spawn_ranks(tmp_path, _dp_worker, npz=npz, x=x, t=t)
    glosses, gparams = _single_process(npz, [(x, t)] * STEPS)
    ref_losses, ref_params, ref_t, _ = r0["per_leaf"]
    for label, _, _ in EXCHANGES:
        for r in (r0, r1):
            losses, params, t_, calls = r[label]
            # the exchange flavors: bitwise one trajectory, on both ranks
            assert losses == ref_losses, label
            for p in ref_params:
                assert torch.equal(params[p], ref_params[p]), (label, p)
            assert t_ == ref_t == STEPS
    assert [r0[k][3] for k in ("per_leaf", "flat")] \
        == [STEPS * len(ref_params), STEPS]
    # golden rule: the single-process run on the merged batch
    np.testing.assert_allclose(ref_losses, glosses, rtol=1e-5, atol=1e-7)
    _close(ref_params, gparams, rtol=1e-5, atol=1e-6)
    # the JAX package's data-parallel step from the same weights
    np.testing.assert_allclose(ref_losses, jlosses, rtol=0, atol=1e-5)
    _close(ref_params, jparams, rtol=0, atol=1e-5)
    # update() after a hand-made backward: the same step
    for p in ref_params:
        assert torch.equal(r0["eager"][1][p], ref_params[p]), p
    assert r0["eager"][3] == STEPS


def test_trainer_over_scattered_shards_and_multi_node_iterators(tmp_path):
    x, t = _tokens(12, seed=2)
    r0, r1 = spawn_ranks(tmp_path, _trainer_worker, x=x, t=t,
                         out_dir=str(tmp_path))
    assert r0["order"] == r1["order"]          # synchronized shuffles
    assert r0["losses"] == r1["losses"]        # the global mean, reported
    merged = [(np.concatenate([a, b]), np.roll(np.concatenate([a, b]), -1,
                                               axis=1))
              for a, b in zip(r0["seen"], r1["seen"])]
    assert len(merged) == STEPS
    model = TransformerLM(seed=0, device="cpu", **KW)
    opt = Adam(**ADAM).setup(model)
    losses = [opt.update(model, torch.from_numpy(a),
                         torch.from_numpy(b)).item() for a, b in merged]
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5, atol=1e-7)
    _close(r0["params"], _params(model), rtol=1e-5, atol=1e-6)
    own = SerialIterator(list(range(10)), 3, shuffle=True, seed=0)
    for got0, got1 in zip(r0["batches"], r1["batches"]):
        assert got0 == got1
        assert got0[0] == own.next()
        assert got0[1:] == (own.epoch, own.is_new_epoch, own.epoch_detail,
                            own.previous_epoch_detail)
