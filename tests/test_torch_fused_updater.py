"""``FusedUpdater`` and the multi-node optimizer's ``update_scan``, on the
CPU.

K fused steps are bitwise K ``StandardUpdater`` steps in the port (a
deterministic model: the fused steps draw their randomness from other
keys), in-process on the dummy communicator and in a 2-rank gloo world
through the real exchange; the trajectory of ``update_scan`` against the
JAX ``update_scan`` (the twin of ``tests/integration_tests/
test_mnist_dp.py::test_update_scan_equals_sequential_updates``; losses
and parameters 1e-5 relative, fp32 across two frameworks); and the
updater's bookkeeping: ``iteration`` by K, one ``new_epoch`` per epoch
boundary crossed inside the K pulls, and what it refuses.
"""

import numpy as np
import pytest
import torch

from chainermn_tpu_torch import create_communicator, create_multi_node_optimizer
from chainermn_tpu_torch.communicators import DummyCommunicator
from chainermn_tpu_torch.core.optimizer import SGD, MomentumSGD
from chainermn_tpu_torch.dataset import SerialIterator, TupleDataset
from chainermn_tpu_torch.models import MLP, Classifier
from chainermn_tpu_torch.training import FusedUpdater, StandardUpdater
from tests.test_torch_communicator import spawn_ranks

K = 4


def _data(n=32, seed=0):
    r = np.random.RandomState(seed)
    return TupleDataset(r.normal(0, 1, (n, 12)).astype(np.float32),
                        r.randint(0, 5, n).astype(np.int32))


def _model():
    return Classifier(MLP(16, 5, seed=0, device="cpu"))


def _run(comm, fused, updates, n=32, batch=4):
    model = _model()
    opt = create_multi_node_optimizer(MomentumSGD(lr=0.1, momentum=0.9),
                                      comm).setup(model)
    it = SerialIterator(_data(n), batch, shuffle=True, seed=1)
    if fused:
        upd = FusedUpdater(it, opt, n_fused=K)
        for _ in range(updates):
            upd.update()
    else:
        upd = StandardUpdater(it, opt)
        for _ in range(updates * K):
            upd.update()
    return upd, opt, {p: v.detach().clone() for p, v in model.namedparams()}


def _bitwise(a, b):
    assert sorted(a) == sorted(b)
    return all(torch.equal(a[p], b[p]) for p in a)


def test_fused_steps_are_bitwise_the_standard_steps():
    fu, fopt, fp = _run(DummyCommunicator(), True, 3)
    su, sopt, sp = _run(DummyCommunicator(), False, 3)
    assert _bitwise(fp, sp)
    assert fu.iteration == su.iteration == 3 * K
    assert fopt.t == sopt.t == 3 * K
    assert fopt.epoch == sopt.epoch == fu.epoch


def _gloo_worker(rank):
    comm = create_communicator("pure_nccl", device="cpu")
    out = {fused: _run(comm, fused, 2)[2] for fused in (True, False)}
    comm.finalize()
    return out


def test_two_ranks_fused_steps_are_bitwise_the_standard_steps(tmp_path):
    results = spawn_ranks(tmp_path, _gloo_worker)
    for out in results:
        assert _bitwise(out[True], out[False])
    assert _bitwise(results[0][True], results[1][True])


def test_update_scan_matches_the_jax_update_scan(tmp_path):
    import jax
    import jax.numpy as jnp

    import chainermn_tpu as ct
    from chainermn_tpu.core.optimizer import SGD as JSGD
    from chainermn_tpu.models import MLP as JMLP
    from chainermn_tpu.models import Classifier as JClassifier
    from chainermn_tpu.serializers import save_npz
    from chainermn_tpu_torch.serializers import load_npz

    r = np.random.RandomState(3)
    xs = r.normal(0, 1, (3, 8, 12)).astype(np.float32)
    ts = r.randint(0, 5, (3, 8)).astype(np.int32)
    jmodel = JClassifier(JMLP(16, 5, seed=0))
    jmodel(jnp.asarray(xs[0]), jnp.asarray(ts[0]))   # the lazy layers
    npz = str(tmp_path / "mlp.npz")
    save_npz(npz, jmodel)
    comm = ct.create_communicator("jax_ici", devices=jax.devices()[:1])
    jopt = ct.create_multi_node_optimizer(JSGD(lr=0.1), comm).setup(jmodel)
    jlosses = np.asarray(jopt.update_scan(jmodel, jnp.asarray(xs),
                                          jnp.asarray(ts)))

    model = load_npz(npz, _model())
    opt = create_multi_node_optimizer(SGD(lr=0.1),
                                      DummyCommunicator()).setup(model)
    losses = opt.update_scan(model, torch.from_numpy(xs),
                             torch.from_numpy(ts))
    assert losses.shape == (3,) and opt.t == jopt.t == 3
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-5)
    want = {p: np.asarray(v.array) for p, v in jmodel.namedparams()}
    for p, v in model.namedparams():
        np.testing.assert_allclose(v.detach().numpy(), want[p], rtol=1e-5,
                                   atol=1e-6, err_msg=p)


@pytest.mark.parametrize("n,batch,epochs", [(10, 3, [1, 2, 3]),
                                            (4, 3, [3, 6, 9])])
def test_iteration_and_epoch_boundaries(n, batch, epochs):
    """Each update pulls K batches: the iteration moves by K and
    ``new_epoch`` fires once per boundary the K pulls cross (10 examples:
    one an update; 4: three)."""
    opt = create_multi_node_optimizer(SGD(), DummyCommunicator()).setup(
        _model())
    upd = FusedUpdater(SerialIterator(_data(n), batch), opt, n_fused=K)
    for i, want in enumerate(epochs):
        upd.update()
        assert upd.iteration == (i + 1) * K
        assert upd.epoch == opt.epoch == want


def test_what_fused_updates_refuse():
    model = _model()
    plain = SGD().setup(model)
    with pytest.raises(TypeError, match="multi-node optimizer"):
        FusedUpdater(SerialIterator(_data(), 4), plain).update()
    with pytest.raises(ValueError, match="n_fused"):
        FusedUpdater(SerialIterator(_data(), 4), plain, n_fused=0)
    db = create_multi_node_optimizer(SGD(), DummyCommunicator(),
                                     double_buffering=True).setup(model)
    x, t = torch.zeros(2, 3, 12), torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="double buffering"):
        db.update_scan(model, x, t)
    opt = create_multi_node_optimizer(SGD(), DummyCommunicator()).setup(model)
    with pytest.raises(ValueError, match="same leading"):
        opt.update_scan(model, x, t[:1])
    with pytest.raises(ValueError, match="leading"):
        opt.update_scan(model, torch.zeros(3))
