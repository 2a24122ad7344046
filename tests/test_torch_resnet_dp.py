"""The port's data-parallel ResNet step against the JAX package's, and the
golden rule for sync batch normalization.

2-rank gloo worlds (the harness of ``test_torch_communicator.py``), each
rank training ``Classifier(ResNet([1, 1, 1, 1]))`` (NHWC, fp32, 16 x 16,
8 images per rank, so that every channel's batch statistics see at least
8 values on a rank) on its half of the batch for 3 ``MomentumSGD`` steps
through ``create_multi_node_optimizer``; rank 0 loads a JAX snapshot and
``bcast_data`` hands it on.  The references:

* the JAX package's data-parallel step over 2 of the 8 CPU devices of
  ``tests/conftest.py`` from the same snapshot, with plain batch norm
  (each rank normalizes with its own batch; the running statistics are
  averaged over the ranks after each step) and with
  ``create_mnbn_model`` (the moments averaged over the ranks);
* the golden rule: sync batch norm makes the data-parallel run equal the
  single-process run on the merged batch.

Tolerances.  Against the JAX package: losses 1e-4 relative, running
statistics and parameters 1e-3 absolute.  A ReLU or max-pool kink may be
crossed on one side only (``test_torch_resnet.py``); on this data the
JAX sync-BN run crosses one that its own merged-batch run does not (one
of res3's 512 channels, whose gradients move by 23 % of their largest
value: ``tools/resnet_kink_probe.py``), so the steps take lr 1e-3 and the
tolerances admit such a crossing.  The golden rule compares the port with
itself, where the two runs differ only in how the batch means are summed:
losses 1e-5 relative, statistics and parameters 1e-5 absolute.  Both ranks
must hold bitwise the same parameters and running statistics.
"""

import numpy as np
import torch

from chainermn_tpu_torch import create_communicator, create_multi_node_optimizer
from chainermn_tpu_torch.core.optimizer import MomentumSGD
from chainermn_tpu_torch.links import (MultiNodeBatchNormalization,
                                       create_mnbn_model)
from chainermn_tpu_torch.models import Classifier, ResNet
from chainermn_tpu_torch.nn.links import BatchNormalization
from chainermn_tpu_torch.serializers import load_npz
from tests.test_torch_communicator import spawn_ranks

BLOCKS = [1, 1, 1, 1]
N_CLASSES = 10
BATCH, SIZE = 16, 16
STEPS = 3
SGD = dict(lr=1e-3, momentum=0.9)
RTOL_LOSS_JAX, ATOL_JAX = 1e-4, 1e-3
RTOL_LOSS, ATOL = 1e-5, 1e-5


def _batches():
    rng = np.random.RandomState(4)
    return [(rng.normal(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32),
             rng.randint(0, N_CLASSES, BATCH).astype(np.int32))
            for _ in range(STEPS)]


def _state(model):
    out = {p: v.detach().clone() for p, v in model.namedparams()}
    out.update((p, v.clone()) for p, v in model.namedpersistent())
    return out


def _model(seed=1):
    return Classifier(ResNet(BLOCKS, n_classes=N_CLASSES, seed=seed,
                             layout="NHWC", device="cpu"))


# -- workers (run in the spawned ranks) --------------------------------------

def _dp_worker(rank, npz, batches, sync_bn):
    comm = create_communicator("flat", device="cpu")
    model = _model(seed=1 + rank)
    if rank == 0:
        load_npz(npz, model)
    comm.bcast_data(model)
    if sync_bn:
        model = create_mnbn_model(model, comm)
    opt = create_multi_node_optimizer(MomentumSGD(**SGD), comm).setup(model)
    half = BATCH // 2
    losses = []
    for x, t in batches:
        losses.append(opt.update(
            model, torch.from_numpy(x[rank * half:(rank + 1) * half]),
            torch.from_numpy(t[rank * half:(rank + 1) * half])).item())
    n_mnbn = sum(isinstance(m, MultiNodeBatchNormalization)
                 for m in model.modules())
    return dict(losses=losses, state=_state(model), calls=dict(comm.calls),
                n_mnbn=n_mnbn)


# -- references (this process) -----------------------------------------------

def _jax_dp_run(npz, batches, sync_bn):
    """The JAX package's data-parallel step over 2 CPU devices; saves its
    initial weights to ``npz`` first."""
    import jax
    import jax.numpy as jnp
    import chainermn_tpu as ct
    from chainermn_tpu.core import optimizer as JO
    from chainermn_tpu.links import create_mnbn_model as jcreate_mnbn_model
    from chainermn_tpu.models import Classifier as JClassifier
    from chainermn_tpu.models.resnet import ResNet as JResNet
    from chainermn_tpu.serializers.npz import save_npz

    model = JClassifier(JResNet(BLOCKS, n_classes=N_CLASSES, seed=0,
                                layout="NHWC"))
    save_npz(npz, model)
    comm = ct.create_communicator("jax_ici", devices=jax.devices()[:2])
    comm.bcast_data(model)
    if sync_bn:
        model = jcreate_mnbn_model(model, comm)
    opt = ct.create_multi_node_optimizer(JO.MomentumSGD(**SGD), comm)
    opt.setup(model)
    losses = [float(opt.update(model, jnp.asarray(x), jnp.asarray(t)))
              for x, t in batches]
    state = {p: np.asarray(v.array) for p, v in model.namedparams()}
    state.update((p, np.asarray(v)) for p, v in model.namedpersistent())
    return losses, state


def _merged_batch_run(npz, batches):
    model = load_npz(npz, _model())
    opt = MomentumSGD(**SGD).setup(model)
    losses = [opt.update(model, torch.from_numpy(x),
                         torch.from_numpy(t)).item() for x, t in batches]
    return losses, _state(model)


def _close_states(got, want, atol):
    assert sorted(got) == sorted(want)
    for p in want:
        np.testing.assert_allclose(np.asarray(got[p]), np.asarray(want[p]),
                                   rtol=0, atol=atol, err_msg=p)


def _check_ranks(r0, r1):
    """Both ranks: one trajectory, bitwise; one gradient allreduce per
    step and one allreduce of the running statistics."""
    assert r0["losses"] == r1["losses"]
    for p, v in r0["state"].items():
        assert torch.equal(v, r1["state"][p]), p
    assert r0["calls"]["allreduce_grad"] == STEPS


# -- tests --------------------------------------------------------------------

def test_dp_plain_bn_matches_the_jax_dp_run(tmp_path):
    """Plain BN: each rank normalizes with its half batch, and the step
    averages the running statistics over the ranks (the JAX step's
    ``pmean`` of its persistent state); ``N`` stays per rank."""
    batches = _batches()
    npz = str(tmp_path / "init.npz")
    jlosses, jstate = _jax_dp_run(npz, batches, sync_bn=False)
    r0, r1 = spawn_ranks(tmp_path, _dp_worker, npz=npz, batches=batches,
                         sync_bn=False)
    _check_ranks(r0, r1)
    assert r0["n_mnbn"] == 0
    # the loss mean and the statistics mean: one allreduce each per step
    assert r0["calls"]["allreduce"] == 2 * STEPS
    np.testing.assert_allclose(r0["losses"], jlosses, rtol=RTOL_LOSS_JAX)
    _close_states(r0["state"], jstate, ATOL_JAX)
    # the half-batch statistics are not the merged batch's
    _, single = _merged_batch_run(npz, batches)
    key = "/predictor/res5/0/c/bn/avg_var"
    assert not np.allclose(r0["state"][key], single[key], atol=ATOL_JAX)


def test_dp_sync_bn_matches_jax_and_the_merged_batch(tmp_path):
    """``create_mnbn_model``: the moments of every BN averaged over the
    ranks in one allreduce forward and one backward; the run equals the
    JAX sync-BN run and the single-process run on the merged batch."""
    batches = _batches()
    npz = str(tmp_path / "init.npz")
    jlosses, jstate = _jax_dp_run(npz, batches, sync_bn=True)
    r0, r1 = spawn_ranks(tmp_path, _dp_worker, npz=npz, batches=batches,
                         sync_bn=True)
    _check_ranks(r0, r1)
    n_bn = r0["n_mnbn"]
    assert n_bn == 1 + 4 * len(BLOCKS)
    # per step: one per BN forward and backward, the loss, the statistics
    assert r0["calls"]["allreduce"] == STEPS * (2 * n_bn + 2)
    np.testing.assert_allclose(r0["losses"], jlosses, rtol=RTOL_LOSS_JAX)
    _close_states(r0["state"], jstate, ATOL_JAX)
    # the golden rule
    losses, single = _merged_batch_run(npz, batches)
    np.testing.assert_allclose(r0["losses"], losses, rtol=RTOL_LOSS)
    _close_states(r0["state"], single, ATOL)


class _Comm:
    size = 2


def test_create_mnbn_model_replaces_every_bn_and_keeps_its_values():
    model = _model()
    with torch.no_grad():
        for path, v in (*model.namedparams(), *model.namedpersistent()):
            if "/bn/" in path:
                v.add_(torch.arange(v.numel()).reshape(v.shape).to(v.dtype))
    for m in model.modules():
        if isinstance(m, BatchNormalization):
            m.decay, m.eps = 0.8, 1e-3
    comm = _Comm()
    mn = create_mnbn_model(model, comm)
    bns = [(p, m) for p, m in model.namedlinks()
           if isinstance(m, BatchNormalization)]
    mnbns = dict(mn.namedlinks())
    assert len(bns) == 1 + 4 * len(BLOCKS)
    for path, bn in bns:
        new = mnbns[path]
        assert type(new) is MultiNodeBatchNormalization and new.comm is comm
        assert (new.decay, new.eps, new.axis, new.size) \
            == (0.8, 1e-3, (0, 1, 2), bn.size)
    assert not any(isinstance(m, MultiNodeBatchNormalization)
                   for m in model.modules())    # the original is untouched
    want, got = _state(model), _state(mn)
    assert sorted(got) == sorted(want)
    for p in want:
        assert torch.equal(got[p], want[p]), p
