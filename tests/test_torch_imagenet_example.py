"""The ImageNet twin against the JAX package's ``examples/
train_imagenet.py``.

``chainermn_tpu_torch.examples.train_imagenet.make_trainer`` for
``--arch nin`` (no dropout, no batch norm: a deterministic trajectory)
at ``--size 67``, batch 4, 20 iterations over 32 synthetic images,
beside the JAX example's ``main`` wiring built as its ``main`` builds it:
the communicator, ``Classifier(NIN)``, ``bcast_data``,
``create_multi_node_optimizer(MomentumSGD(0.01, 0.9))`` with
``WeightDecay(1e-4)``, the scattered ``get_synthetic_imagenet``, a
``MultithreadIterator`` under the device-feed stage, ``StandardUpdater``
with the identity converter and ``LogReport`` every 10 iterations.  Both
start from the JAX model's weights (an npz).  The logged loss and
accuracy must match within 1e-4 relative (fp32 over 20 steps: the two
frameworks sum the convolutions in other orders, and the difference grows
a little with each update).

Harness choices, the same on both sides: the iterators are seeded (the
JAX example leaves the thread loader unseeded), and the gradient wire is
fp32 (the example's default bf16 wire would round the two frameworks'
gradients at different points near a rounding boundary).  The port runs
in a spawned world of one gloo process: this module imports no JAX at
its top, so that its ranks do not.
"""

import os

import numpy as np
import pytest

from tests.test_torch_communicator import spawn_ranks

SIZE, BATCH, N_TRAIN, ITERS = 67, 4, 32, 20
FLAGS = ["--arch", "nin", "--size", str(SIZE), "-b", str(BATCH),
         "--n-train", str(N_TRAIN), "--iterations", str(ITERS),
         "--grad-dtype", "float32", "--device", "cpu"]
KEYS = ("main/loss", "main/accuracy")


def _port_worker(rank, npz, out):
    from chainermn_tpu_torch.examples import train_imagenet as twin
    from chainermn_tpu_torch.models import NIN, Classifier
    from chainermn_tpu_torch.serializers import load_npz
    args = twin.parse_args(FLAGS + ["-o", out])
    model = load_npz(npz, Classifier(NIN(seed=1, device="cpu")))
    trainer, comm = twin.make_trainer(args, model=model, seed=0)
    trainer.run()
    result = {"log": trainer.get_extension("LogReport").log,
              "iterator": type(trainer.updater.get_iterator()).__name__,
              "comm": (comm.name, comm.size,
                       str(comm.allreduce_grad_dtype))}
    # the other archs and loaders run through the same trainer: GoogLeNet
    # leaves its auxiliary heads' lazy layers unmade under a Classifier
    for flags in (["--arch", "googlenet", "--size", "64", "--loader",
                   "native", "--uint8-input"],
                  ["--arch", "nin", "--loader", "multiprocess",
                   "--loader-workers", "2", "--fused", "2"],
                  ["--arch", "resnet50", "--size", "32", "--remat",
                   "--mnbn", "--device-prefetch", "0"]):
        args = twin.parse_args(
            ["-b", "2", "--n-train", "8", "--iterations", "2", "--size",
             str(SIZE), "--device", "cpu", "-o", out] + flags)
        tr, _ = twin.make_trainer(args, comm=comm, seed=0)
        tr.run()
        result[args.arch] = (tr.updater.iteration, type(tr.updater).__name__)
    comm.finalize()
    return result


def _jax_log(npz, out):
    import jax

    import chainermn_tpu as ct
    from chainermn_tpu.core.optimizer import MomentumSGD
    from chainermn_tpu.dataset import (DevicePrefetchIterator,
                                       MultithreadIterator, concat_examples,
                                       identity_converter)
    from chainermn_tpu.dataset.datasets import get_synthetic_imagenet
    from chainermn_tpu.models import NIN, Classifier
    from chainermn_tpu.serializers import save_npz
    from chainermn_tpu.training import StandardUpdater, Trainer, extensions

    comm = ct.create_communicator("pure_nccl", allreduce_grad_dtype="float32",
                                  devices=jax.devices()[:1])
    model = Classifier(NIN())
    train = get_synthetic_imagenet(n=N_TRAIN, size=SIZE)
    model(train[0][0][None], np.zeros(1, np.int32))   # no lazy layer: check
    save_npz(npz, model)
    comm.bcast_data(model)
    optimizer = ct.create_multi_node_optimizer(
        MomentumSGD(lr=0.01, momentum=0.9), comm).setup(model)
    optimizer.add_hook(ct.core.WeightDecay(1e-4))
    train = ct.scatter_dataset(train, comm, shuffle=True, seed=0)
    it = DevicePrefetchIterator(MultithreadIterator(train, BATCH, seed=0),
                                size=2, converter=concat_examples)
    trainer = Trainer(StandardUpdater(it, optimizer,
                                      converter=identity_converter),
                      (ITERS, "iteration"), out=out)
    trainer.extend(extensions.LogReport(trigger=(10, "iteration")))
    trainer.run()
    return trainer.get_extension("LogReport").log


def test_twin_matches_the_jax_example(tmp_path):
    npz = str(tmp_path / "nin.npz")
    want = _jax_log(npz, str(tmp_path / "jax"))
    (got,) = spawn_ranks(tmp_path, _port_worker, world=1, npz=npz,
                         out=str(tmp_path / "port"))
    assert got["comm"] == ("pure_nccl", 1, "torch.float32")
    assert got["iterator"] == "DevicePrefetchIterator"
    log = got["log"]
    assert [e["iteration"] for e in log] == [e["iteration"] for e in want] \
        == [10, 20]
    for g, w in zip(log, want):
        for key in KEYS:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                       err_msg=key)
    assert got["googlenet"] == (2, "StandardUpdater")
    assert got["nin"] == (2, "FusedUpdater")
    assert got["resnet50"] == (2, "StandardUpdater")


def test_flags():
    from chainermn_tpu_torch.examples import train_imagenet as twin
    args = twin.parse_args([])
    assert (args.device, args.loader, args.batchsize, args.arch,
            args.communicator, args.grad_dtype, args.device_prefetch) == (
        "cuda", "thread", 32, "resnet50", "pure_nccl", "bfloat16", 2)
    assert twin.parse_args(["--native-loader"]).loader == "native"
    with pytest.raises(SystemExit):
        twin.parse_args(["--native-loader", "--loader", "thread"])
    with pytest.raises(SystemExit):
        twin.parse_args(["--platform", "cpu"])   # JAX-only, left out
    assert set(twin.ARCHS) == {"resnet50", "alex", "nin", "vgg16",
                               "googlenet"}
    assert os.path.basename(twin.__file__) == "train_imagenet.py"


def test_the_port_and_chip_smoke_import_no_jax():
    """No module of the port, and not ``chip_smoke.py``, imports ``jax``
    or the JAX package (``chainermn_tpu``), not even a host module: the
    port must run where neither is installed."""
    import re
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|chainermn_tpu)(\.|\s|$)")
    files = [os.path.join(root, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(root, "chainermn_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 50
    offenders = [f"{path}:{i}" for path in files
                 for i, line in enumerate(open(path), 1)
                 if pattern.match(line)
                 or re.search(r"import_module\(\s*[\"'](jax|chainermn_tpu)"
                              r"[\"'.]", line)]
    assert not offenders, offenders
