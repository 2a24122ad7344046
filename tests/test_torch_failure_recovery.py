"""Inject, detect, recover, converge: the port's ``FailureRecovery`` under
``Trainer.run``'s supervisor loop, twins of
``tests/resilience_tests/test_failure_recovery.py`` (a world of one on the
CPU, gloo).

A trainer with a per-iteration control-plane beacon (``bcast_obj``) is
driven into injected faults.  The recovered run must equal the port's
uninterrupted run BITWISE (the rollback restores parameters, SGD state,
the iterator, the iteration and the triggers exactly, and the replayed
steps are the same float operations), and its final parameters must match
the JAX ``FailureRecovery`` run (the JAX test's own trainer, its schedule,
its data, its initial weights copied into the port) within the JAX test's
rtol 1e-6 / atol 1e-7: 12 SGD steps of a 784-16-10 MLP, where the two
frameworks' float32 matmuls sum in different orders.
"""

import os

import numpy as np
import pytest
import torch

from chainermn_tpu_torch import (F, L, create_communicator,
                                 create_multi_node_checkpointer,
                                 create_multi_node_optimizer)
from chainermn_tpu_torch.communicators import (FaultInjectionCommunicator,
                                               FaultSchedule, InjectedFault,
                                               PeerLostError)
from chainermn_tpu_torch.core.link import Chain
from chainermn_tpu_torch.core.optimizer import SGD
from chainermn_tpu_torch.dataset import SerialIterator, TupleDataset
from chainermn_tpu_torch.extensions import FailureRecovery, RecoveryGivingUp
from chainermn_tpu_torch.serializers.npz import load_params
from chainermn_tpu_torch.training import StandardUpdater, Trainer
from chainermn_tpu_torch.training.trainer import Extension

JAX_TOL = dict(rtol=1e-6, atol=1e-7)


def _jax_reference():
    """The JAX test's initial weights (by path) and data, as numpy."""
    from chainermn_tpu.dataset import get_mnist
    from tests.resilience_tests.test_failure_recovery import _MLP
    params = {p: np.asarray(v.array) for p, v in _MLP().namedparams()}
    train, _ = get_mnist(n_train=64, n_test=8)
    x = np.stack([np.asarray(train[i][0]) for i in range(len(train))])
    t = np.asarray([int(train[i][1]) for i in range(len(train))])
    return params, x.astype(np.float32), t.astype(np.int64)


@pytest.fixture(scope="module")
def reference():
    return _jax_reference()


class _MLP(Chain):
    def __init__(self, params):
        super().__init__()
        with self.init_scope():
            self.l1 = L.Linear(784, 16, seed=7, device="cpu")
            self.l2 = L.Linear(16, 10, seed=8, device="cpu")
        load_params(self, params)

    def forward(self, x, t):
        return F.softmax_cross_entropy(self.l2(F.relu(self.l1(x))), t)


class _Beacon(Extension):
    """Per-iteration host control-plane op (what the multi-node iterator
    does for every batch): the fault-injection site."""

    trigger = (1, "iteration")
    priority = 400

    def __init__(self, comm):
        self.comm = comm
        self.errors = []

    def __call__(self, trainer):
        self.comm.bcast_obj({"iteration": trainer.updater.iteration})

    def on_error(self, trainer, exc, tb):
        self.errors.append(type(exc).__name__)


def _make_trainer(out, reference, schedule=None, iters=12,
                  cp_trigger=(3, "iteration"), max_recoveries=3, batch=8):
    params, x, t = reference
    model = _MLP(params)
    comm = create_communicator("jax_ici", device="cpu")
    if schedule is not None:
        comm = FaultInjectionCommunicator(comm, schedule)
    opt = create_multi_node_optimizer(SGD(lr=0.05), comm).setup(model)
    it = SerialIterator(TupleDataset(x, t), batch, shuffle=False)
    trainer = Trainer(StandardUpdater(it, opt), (iters, "iteration"),
                      out=out)
    beacon = _Beacon(comm)
    trainer.extend(beacon)
    cp = create_multi_node_checkpointer(comm, name="rec")
    trainer.extend(cp, trigger=cp_trigger)
    recovery = FailureRecovery(checkpointer=cp,
                               max_recoveries=max_recoveries, verbose=False)
    trainer.extend(recovery)
    return model, trainer, beacon, cp, recovery, comm


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


def test_recovers_from_injected_collective_fault(tmp_path, reference):
    from tests.resilience_tests.test_failure_recovery import \
        _make_trainer as jax_make_trainer
    from chainermn_tpu.communicators import FaultSchedule as JaxSchedule
    # the JAX run: its trainer, its schedule; its batch sets ours
    j_model, j_trainer, _, _, j_rec = jax_make_trainer(
        str(tmp_path / "jax"),
        schedule=JaxSchedule([dict(op="bcast_obj", nth=8)], seed=5))
    j_trainer.run()
    batch = j_trainer.updater.get_iterator("main").batch_size
    assert j_rec.stats["resumed_iterations"] == [6]

    gold_model, gold_trainer, *_, gold_comm = _make_trainer(
        str(tmp_path / "gold"), reference, batch=batch)
    gold_trainer.run()
    gold_comm.finalize()
    assert gold_trainer.updater.iteration == 12

    sched = FaultSchedule([dict(op="bcast_obj", nth=8)], seed=5)
    model, trainer, beacon, cp, recovery, comm = _make_trainer(
        str(tmp_path / "run"), reference, schedule=sched, batch=batch)
    trainer.run()
    comm.finalize()
    assert recovery.stats["recoveries"] == 1
    assert beacon.errors == ["InjectedFault"]
    # beacon call #8 faults right after update 8: snapshots 3 and 6 exist
    assert recovery.stats["resumed_iterations"] == [6]
    assert recovery.stats["generation_bumps"] == 0   # no host channel
    assert trainer.updater.iteration == 12
    for a, b in zip(_params(gold_model), _params(model)):
        assert torch.equal(a, b), "recovered run differs from the gold"
    mine = dict(model.namedparams())
    for path, p in j_model.namedparams():
        np.testing.assert_allclose(mine[path].detach().numpy(),
                                   np.asarray(p.array), **JAX_TOL)


def test_recovers_from_fault_during_checkpoint_write(tmp_path, reference):
    model, trainer, beacon, cp, recovery, comm = _make_trainer(
        str(tmp_path / "run"), reference)
    fired = []

    def write_fault(tmp, fname):
        if fname.startswith("rec.6.") and not fired:
            fired.append(fname)
            raise InjectedFault("checkpoint.save", 1, "torn write")

    cp._write_fault_hook = write_fault
    trainer.run()
    comm.finalize()
    assert fired
    assert recovery.stats["recoveries"] == 1
    assert recovery.stats["resumed_iterations"] == [3]
    assert trainer.updater.iteration == 12
    out = str(tmp_path / "run")
    files = [f for f in os.listdir(out) if f.startswith("rec.")]
    assert "rec.6.0" in files
    assert cp._verify(os.path.join(out, "rec.6.0"))


def test_unrecoverable_exception_still_fail_stops(tmp_path, reference):
    sched = FaultSchedule([dict(op="bcast_obj", nth=4, exc=ValueError)],
                          seed=0)
    model, trainer, beacon, cp, recovery, comm = _make_trainer(
        str(tmp_path / "run"), reference, schedule=sched)
    try:
        with pytest.raises(ValueError):
            trainer.run(show_loop_exception_msg=False)
    finally:
        comm.finalize()
    assert recovery.stats["recoveries"] == 0
    assert beacon.errors == ["ValueError"]


def test_recovery_budget_exhaustion(tmp_path, reference):
    sched = FaultSchedule([dict(op="bcast_obj", nth=5),
                           dict(op="bcast_obj", nth=6),
                           dict(op="bcast_obj", nth=7)], seed=0)
    model, trainer, beacon, cp, recovery, comm = _make_trainer(
        str(tmp_path / "run"), reference, schedule=sched, max_recoveries=2)
    try:
        with pytest.raises(RecoveryGivingUp) as ei:
            trainer.run(show_loop_exception_msg=False)
    finally:
        comm.finalize()
    assert isinstance(ei.value.__cause__, InjectedFault)
    assert recovery.stats["recoveries"] == 2


def test_peer_lost_fail_stops_by_default(tmp_path, reference):
    model, trainer, beacon, cp, recovery, comm = _make_trainer(
        str(tmp_path / "run"), reference)
    comm.finalize()
    assert not recovery.can_recover(PeerLostError(1, 12.0))
    assert recovery.can_recover(InjectedFault("bcast_obj", 1))
    opt_in = FailureRecovery(checkpointer=cp, unrecoverable=())
    assert opt_in.can_recover(PeerLostError(1, 12.0))


def test_fault_schedule_rejected_for_non_fault_communicator():
    for name in ("jax_ici", "dummy"):
        with pytest.raises(ValueError, match="only honored by the 'fault'"):
            create_communicator(name, device="cpu",
                                fault_schedule=FaultSchedule([], seed=0))


def test_recovery_without_checkpointer_restarts_live(tmp_path, reference):
    params, x, t = reference
    sched = FaultSchedule([dict(op="bcast_obj", nth=5)], seed=1)
    model = _MLP(params)
    comm = FaultInjectionCommunicator(
        create_communicator("jax_ici", device="cpu"), sched)
    opt = create_multi_node_optimizer(SGD(lr=0.05), comm).setup(model)
    it = SerialIterator(TupleDataset(x, t), 8, shuffle=False)
    trainer = Trainer(StandardUpdater(it, opt), (8, "iteration"),
                      out=str(tmp_path / "run"))
    trainer.extend(_Beacon(comm))
    recovery = FailureRecovery(comm=comm, verbose=False)
    trainer.extend(recovery)
    trainer.run()
    comm.finalize()
    assert recovery.stats["recoveries"] == 1
    assert recovery.stats["resumed_iterations"] == [None]
    assert trainer.updater.iteration == 8


def test_recovery_rolls_back_adam_in_place_bitwise(tmp_path, reference):
    """A fault at the gradient exchange itself, Adam, double buffering
    and the per-rank DCP checkpointer: the rollback writes the parameters
    and the moments into the tensors the model and the rule already hold,
    drops the exchange in flight, and the run ends bitwise on the
    uninterrupted one."""
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.extensions import \
        create_multi_node_orbax_checkpointer
    params, x, t = reference

    def run(out, faults):
        model = _MLP(params)
        comm = create_communicator("fault", device="cpu", fault_schedule={
            "seed": 3, "faults": faults})
        adam = Adam(alpha=1e-3)
        adam.seed = 11          # the per-step key, from a seed
        opt = create_multi_node_optimizer(
            adam, comm, double_buffering=True).setup(model)
        it = SerialIterator(TupleDataset(x, t), 8, shuffle=True, seed=4)
        trainer = Trainer(StandardUpdater(it, opt), (12, "iteration"),
                          out=out)
        cp = create_multi_node_orbax_checkpointer(comm, out + "/dcp")
        trainer.extend(cp, trigger=(4, "iteration"))
        rec = FailureRecovery(checkpointer=cp, verbose=False)
        trainer.extend(rec)
        held = [id(p) for p in model.parameters()]
        trainer.run()
        comm.finalize()
        assert held == [id(p) for p in model.parameters()]
        return model, opt, rec

    gold, gold_opt, _ = run(str(tmp_path / "gold"), [])
    model, opt, rec = run(str(tmp_path / "run"), [
        {"op": "allreduce_grad_async", "nth": 7}])
    assert rec.stats["recoveries"] == 1
    assert rec.stats["resumed_iterations"] == [4]
    for a, b in zip(gold.parameters(), model.parameters()):
        assert torch.equal(a, b)
    for (pa, sa), (pb, sb) in zip(sorted(gold_opt._state.items()),
                                  sorted(opt._state.items())):
        assert pa == pb and sa["count"] == sb["count"]
        assert all(torch.equal(sa[k], sb[k]) for k in ("mu", "nu"))
    assert np.array_equal(gold_opt._rng_key, opt._rng_key)
