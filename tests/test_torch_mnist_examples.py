"""The example twins against the JAX package's example scripts.

``chainermn_tpu_torch.examples.train_mnist`` against ``examples/
train_mnist.py`` and ``train_mnist_dp`` against ``examples/
train_mnist_dp.py``: the JAX example's model, optimizer, iterators and
extensions, built as its ``main`` builds them, beside the twin's
``make_trainer``, on the same small synthetic MNIST (``get_mnist`` with
``ndim=1`` and ``ndim=3``; the second runs through ``linear``'s flatten
rule) from the same weights (the JAX model's first weights, through an
npz).  The twin's per-epoch ``LogReport`` entries -- training loss and
accuracy, validation loss and accuracy -- must match the JAX example's.

Two differences in the feed, both of the harness: the training
iterators are seeded (the examples shuffle unseeded), and the DP twin's
2 gloo ranks are handed the halves of the JAX run's global batches in
its order (the JAX example on 2 CPU devices feeds a global batch of 2 b
whose halves ``shard_map`` gives its devices; a rank of the twin
iterates its own shard of b per step), without shuffling on either side.

Tolerance 1e-5 absolute, fp32 (two frameworks, other summation orders).
"""

import importlib.util
import os

import numpy as np
import pytest

from tests.test_torch_communicator import spawn_ranks

TOL = dict(rtol=0, atol=1e-5)
METRICS = ("main/loss", "main/accuracy", "validation/main/loss",
           "validation/main/accuracy")
UNIT, EPOCHS = 16, 2
N_TRAIN, N_TEST = 160, 80
BATCH = 20          # the single twin's batch; the DP twin's per rank
DP_VARIANTS = [("plain", 1, {}), ("plain", 3, {}),
               ("zero", 1, dict(zero_sharding=True)),
               ("db", 1, dict(double_buffering=True))]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example(name):
    """The JAX package's example script as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _materialized(module, example_x, npz):
    """The JAX example's lazy ``Classifier(MLP(UNIT, 10))``: loaded from
    ``npz`` when it exists, else created by one forward on
    ``example_x`` and saved there."""
    from chainermn_tpu.serializers import load_npz, save_npz
    model = module.Classifier(module.MLP(UNIT, 10))
    if os.path.exists(npz):
        return load_npz(npz, model) or model
    model(example_x[None], np.zeros(1, np.int32))
    save_npz(npz, model)
    return model


def _port_model(npz):
    from chainermn_tpu_torch.models import MLP, Classifier
    from chainermn_tpu_torch.serializers import load_npz
    return load_npz(npz, Classifier(MLP(UNIT, 10, seed=None, device="cpu")))


def _metrics_close(got, want):
    assert [e["epoch"] for e in got] == [e["epoch"] for e in want] \
        == list(range(1, EPOCHS + 1))
    for g, w in zip(got, want):
        for key in METRICS:
            np.testing.assert_allclose(g[key], w[key], err_msg=key, **TOL)


# -- the single-process twin -----------------------------------------------------

@pytest.mark.parametrize("ndim", [1, 3])
def test_train_mnist_twin_matches_the_jax_example(tmp_path, ndim):
    from chainermn_tpu.core.optimizer import Adam
    from chainermn_tpu.dataset import SerialIterator, get_mnist
    from chainermn_tpu.training import StandardUpdater, Trainer, extensions
    from chainermn_tpu_torch.dataset import get_mnist as tget_mnist
    from chainermn_tpu_torch.examples import train_mnist as twin

    ex = _jax_example("train_mnist")
    npz = str(tmp_path / "init.npz")
    train, test = get_mnist(ndim=ndim, n_train=N_TRAIN, n_test=N_TEST)
    model = _materialized(ex, train[0][0], npz)
    # the JAX example's main(), at this size
    optimizer = Adam().setup(model)
    trainer = Trainer(
        StandardUpdater(SerialIterator(train, BATCH, seed=0), optimizer),
        (EPOCHS, "epoch"), out=str(tmp_path / "jax"))
    trainer.extend(extensions.Evaluator(
        SerialIterator(test, BATCH, repeat=False, shuffle=False), model))
    trainer.extend(extensions.LogReport())
    trainer.extend(extensions.PrintReport(twin.REPORT))
    trainer.extend(extensions.snapshot(), trigger=(EPOCHS, "epoch"))
    trainer.run()
    want = trainer.get_extension("LogReport").log

    args = twin.parse_args(["-b", str(BATCH), "-e", str(EPOCHS), "-u",
                            str(UNIT), "-o", str(tmp_path / "port"),
                            "--device", "cpu"])
    ported = twin.make_trainer(
        args, data=tget_mnist(ndim=ndim, n_train=N_TRAIN, n_test=N_TEST),
        model=_port_model(npz), seed=0)
    ported.run()
    got = ported.get_extension("LogReport").log
    _metrics_close(got, want)
    assert got[-1]["main/loss"] < got[0]["main/loss"]
    steps = EPOCHS * N_TRAIN // BATCH
    assert sorted(os.listdir(tmp_path / "port")) == [
        "log", f"snapshot_iter_{steps}"]

    # -r: the twin resumes from its snapshot (one epoch more)
    more = twin.parse_args(["-b", str(BATCH), "-e", str(EPOCHS + 1), "-u",
                            str(UNIT), "-o", str(tmp_path / "port"),
                            "--device", "cpu", "-r",
                            str(tmp_path / "port" / f"snapshot_iter_{steps}")])
    resumed = twin.make_trainer(
        more, data=tget_mnist(ndim=ndim, n_train=N_TRAIN, n_test=N_TEST),
        seed=0)
    from chainermn_tpu_torch.serializers import load_npz
    load_npz(more.resume, resumed)
    resumed.run()
    log = resumed.get_extension("LogReport").log
    assert log[:EPOCHS] == got and len(log) == EPOCHS + 1


def test_train_mnist_twin_main_runs_on_the_cpu(tmp_path):
    from chainermn_tpu_torch.examples import train_mnist as twin
    assert twin.parse_args([]).device == "cuda"      # the card by default
    trainer = twin.main(["-e", "1", "-b", "500", "-u", "8", "-o",
                         str(tmp_path), "--device", "cpu"])
    assert list(trainer._extensions) == [
        "validation", "LogReport", "PrintReport", "_snapshot"]
    assert trainer.get_extension("LogReport").log[0]["epoch"] == 1
    assert sorted(os.listdir(tmp_path)) == ["log", "snapshot_iter_12"]


# -- the data-parallel twin ------------------------------------------------------

def _halves(dataset, batch, rank):
    """Rank ``rank``'s half of each consecutive global batch of
    ``2 * batch`` examples, as arrays."""
    n = len(dataset)
    idx = [k * 2 * batch + rank * batch + j
           for k in range(n // (2 * batch)) for j in range(batch)]
    xs, ts = zip(*(dataset[i] for i in idx))
    return np.stack(xs), np.asarray(ts)


def _dp_worker(rank, npz, data, argv):
    from chainermn_tpu_torch.dataset import TupleDataset
    from chainermn_tpu_torch.examples import train_mnist_dp as twin
    out = {}
    for (label, ndim, _), flags in zip(DP_VARIANTS, argv):
        args = twin.parse_args(flags)
        train, test = (TupleDataset(*data[ndim][part][rank])
                       for part in ("train", "test"))
        trainer, comm = twin.make_trainer(
            args, data=(train, test), model=_port_model(npz[ndim]),
            shuffle=False)
        trainer.run()
        names = list(trainer._extensions)
        out[(label, ndim)] = (
            trainer.get_extension("LogReport").log if rank == 0 else None,
            names, comm.size)
    return out


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    import jax
    import chainermn_tpu as ct
    from chainermn_tpu.core.optimizer import Adam
    from chainermn_tpu.dataset import SerialIterator, get_mnist
    from chainermn_tpu.training import StandardUpdater, Trainer, extensions

    tmp = tmp_path_factory.mktemp("mnist_dp")
    ex = _jax_example("train_mnist_dp")
    data, npz, want = {}, {}, {}
    for label, ndim, kw in DP_VARIANTS:
        comm = ct.create_communicator("jax_ici", devices=jax.devices()[:2])
        train, test = get_mnist(ndim=ndim, n_train=N_TRAIN, n_test=N_TEST)
        npz.setdefault(ndim, str(tmp / f"init{ndim}.npz"))
        # the JAX example's main() on 2 devices, at this size
        model = _materialized(ex, train[0][0], npz[ndim])
        comm.bcast_data(model)
        optimizer = ct.create_multi_node_optimizer(Adam(), comm,
                                                   **kw).setup(model)
        train = ct.scatter_dataset(train, comm, shuffle=True, seed=0)
        test = ct.scatter_dataset(test, comm, shuffle=False)
        data[ndim] = {part: [_halves(ds, BATCH, r) for r in range(2)]
                      for part, ds in (("train", train), ("test", test))}
        trainer = Trainer(StandardUpdater(
            SerialIterator(train, BATCH * comm.size, shuffle=False),
            optimizer), (EPOCHS, "epoch"), out=str(tmp / f"jax_{label}"))
        trainer.extend(ct.create_multi_node_evaluator(extensions.Evaluator(
            SerialIterator(test, BATCH * comm.size, repeat=False,
                           shuffle=False), model), comm))
        trainer.extend(extensions.LogReport())
        trainer.run()
        want[(label, ndim)] = trainer.get_extension("LogReport").log
    argv = [["-b", str(BATCH), "-e", str(EPOCHS), "-u", str(UNIT), "-o",
             str(tmp / f"port_{label}{ndim}"), "--device", "cpu"]
            + {"zero": ["--zero"], "db": ["--double-buffering"]}.get(label,
                                                                     [])
            for label, ndim, _ in DP_VARIANTS]
    ranks = spawn_ranks(tmp, _dp_worker, npz=npz, data=data, argv=argv)
    return ranks, want


@pytest.mark.parametrize("label,ndim", [(v[0], v[1]) for v in DP_VARIANTS])
def test_train_mnist_dp_twin_matches_the_jax_example(dp_runs, label, ndim):
    ranks, want = dp_runs
    log, names, size = ranks[0][(label, ndim)]
    assert size == 2
    _metrics_close(log, want[(label, ndim)])
    # LogReport and PrintReport on rank 0 only, the evaluator everywhere
    assert names == ["validation", "LogReport", "PrintReport"]
    assert ranks[1][(label, ndim)][1] == ["validation"]


def test_train_mnist_dp_twin_defaults():
    from chainermn_tpu_torch.examples import train_mnist_dp as twin
    args = twin.parse_args([])
    assert (args.batchsize, args.epoch, args.unit, args.communicator,
            args.out, args.zero, args.double_buffering, args.grad_dtype,
            args.device) == (32, 3, 100, "jax_ici", "result_dp", False,
                             False, None, "cuda")
