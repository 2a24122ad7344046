"""``ResNet(remat=True)`` against ``remat=False`` in the port, on the CPU.

The twin of ``tests/models_tests/test_models.py::
test_resnet_remat_matches_no_remat``: ``ResNet50`` (10 classes, 64 x 64,
batch 4, fp32) with and without per-stage rematerialization, 2 SGD
steps, the losses and the running statistics within 1e-5 relative (the
recompute runs the same kernels on the same inputs; the tolerance only
admits a reordered sum), and ``N`` equal.  A batch norm called with
``finetune=True`` under :func:`checkpoint_link` shows that ``N`` and the
statistics move once a step, not twice.  A 2-rank gloo world runs the
small ``ResNet([1, 1, 1, 1])`` with sync batch norm
(``create_mnbn_model``) both ways: the recompute runs the allreduces
again on every rank, and the steps still agree.

This module imports no JAX (its ranks import it).
"""

import numpy as np
import torch

from chainermn_tpu_torch import (create_communicator,
                                 create_multi_node_optimizer, links)
from chainermn_tpu_torch.core.config import using_config
from chainermn_tpu_torch.core.link import Chain
from chainermn_tpu_torch.core.optimizer import SGD, MomentumSGD
from chainermn_tpu_torch.models import Classifier, ResNet, ResNet50
from chainermn_tpu_torch.models.resnet import checkpoint_link
from chainermn_tpu_torch.nn import functions as F
from chainermn_tpu_torch.nn import links as L
from tests.test_torch_communicator import spawn_ranks

RTOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _persistent(model):
    return {p: v.clone() for p, v in model.namedpersistent()}


def _check_same(on, off):
    assert sorted(on) == sorted(off)
    for p, v in off.items():
        if v.is_floating_point():
            assert _rel(on[p], v) <= RTOL, p
        else:
            assert torch.equal(on[p], v), p


def test_resnet50_remat_matches_no_remat():
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.normal(0, 1, (4, 3, 64, 64)).astype(np.float32))
    t = torch.from_numpy(rng.randint(0, 10, 4).astype(np.int32))
    losses, stats, params = {}, {}, {}
    for remat in (False, True):
        m = Classifier(ResNet50(n_classes=10, remat=remat, seed=0,
                                device="cpu"))
        opt = SGD(lr=0.01).setup(m)
        losses[remat] = [opt.update(m, x, t).item() for _ in range(2)]
        stats[remat] = _persistent(m)
        params[remat] = {p: v.detach().clone() for p, v in m.namedparams()}
    assert _rel(losses[True], losses[False]) <= RTOL
    _check_same(stats[True], stats[False])
    _check_same(params[True], params[False])
    assert stats[True]["/predictor/res2/0/a/bn/avg_mean"].abs().sum() > 0


class _FinetuneBN(Chain):
    """Two convolution + finetune batch norm pairs: the recompute runs
    the first batch norm's update whole before it reaches the second
    convolution (it may stop early after the last saved tensor)."""

    def __init__(self):
        super().__init__()
        self.conv = L.Convolution2D(3, 8, 3, pad=1, seed=1, device="cpu")
        self.bn = L.BatchNormalization(8, device="cpu")
        self.conv2 = L.Convolution2D(8, 8, 3, pad=1, seed=2, device="cpu")
        self.bn2 = L.BatchNormalization(8, device="cpu")

    def forward(self, x):
        h = F.relu(self.bn(self.conv(x), finetune=True))
        return self.bn2(self.conv2(h), finetune=True)


def test_checkpoint_moves_the_statistics_once_a_step():
    rng = np.random.RandomState(0)
    xs = [torch.from_numpy(rng.normal(0, 1, (4, 3, 6, 6)).astype(np.float32))
          for _ in range(3)]
    runs = {}
    for remat in (False, True):
        link = _FinetuneBN()
        opt = SGD(lr=0.1).setup(link)
        for x in xs:
            opt.update(lambda a: (checkpoint_link(link, a) if remat
                                  else link(a)).square().mean(), x)
        runs[remat] = link
    for link in runs.values():
        assert int(link.bn.N) == int(link.bn2.N) == len(xs)
    _check_same(_persistent(runs[True]), _persistent(runs[False]))
    _check_same({p: v.detach() for p, v in runs[True].namedparams()},
                {p: v.detach() for p, v in runs[False].namedparams()})


def test_remat_outside_autograd_runs_plainly():
    model = ResNet([1, 1, 1, 1], n_classes=10, seed=0, remat=True,
                   device="cpu")
    plain = ResNet([1, 1, 1, 1], n_classes=10, seed=0, device="cpu")
    x = torch.from_numpy(np.random.RandomState(1).normal(
        0, 1, (2, 3, 16, 16)).astype(np.float32))
    with using_config("train", False):
        assert torch.equal(model(x), plain(x))
    with torch.no_grad():
        assert torch.equal(model(x), plain(x))
    _check_same(_persistent(model), _persistent(plain))


# -- 2 ranks, sync batch norm ----------------------------------------------------

def _mnbn_worker(rank):
    comm = create_communicator("pure_nccl", device="cpu")
    rng = np.random.RandomState(10 + rank)
    batches = [(torch.from_numpy(rng.normal(0, 1, (4, 16, 16, 3))
                                 .astype(np.float32)),
                torch.from_numpy(rng.randint(0, 10, 4)))
               for _ in range(2)]
    out = {}
    for remat in (False, True):
        model = links.create_mnbn_model(Classifier(ResNet(
            [1, 1, 1, 1], n_classes=10, seed=0, layout="NHWC", remat=remat,
            device="cpu")), comm)
        opt = create_multi_node_optimizer(
            MomentumSGD(lr=0.01, momentum=0.9), comm).setup(model)
        losses = [opt.update(model, x, t).item() for x, t in batches]
        out[remat] = (losses, _persistent(model),
                      {p: v.detach().clone() for p, v in model.namedparams()})
    comm.finalize()
    return out


def test_two_ranks_sync_bn_remat_matches_no_remat(tmp_path):
    results = spawn_ranks(tmp_path, _mnbn_worker)
    for out in results:
        assert _rel(out[True][0], out[False][0]) <= RTOL
        _check_same(out[True][1], out[False][1])
        _check_same(out[True][2], out[False][2])
    # the ranks agree on the parameters (the data-parallel invariant)
    _check_same(results[1][True][2], results[0][True][2])
