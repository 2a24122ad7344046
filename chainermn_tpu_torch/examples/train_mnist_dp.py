"""Data-parallel MNIST: the twin of the JAX package's
``examples/train_mnist_dp.py`` (reference: ``examples/mnist/
train_mnist.py`` under ``mpiexec``; BASELINE config #1).

    python -m chainermn_tpu_torch.examples.train_mnist_dp --device cpu
    torchrun --nproc_per_node=2 -m chainermn_tpu_torch.examples.train_mnist_dp --device cpu
    torchrun --nproc_per_node=4 -m chainermn_tpu_torch.examples.train_mnist_dp -c hierarchical --grad-dtype int8

The reference's flow, one process per device: ``create_communicator`` ->
``scatter_dataset`` -> ``bcast_data`` -> ``create_multi_node_optimizer``
(forward, backward, gradient exchange, update) ->
``create_multi_node_evaluator``, with ``LogReport`` and ``PrintReport``
on rank 0 only.  Under ``torchrun`` the ranks form a world of
``--nproc_per_node``; run plainly, a world of one.  ``-b`` is the batch
of each rank.
"""

import argparse

from .. import (create_communicator, create_multi_node_evaluator,
                create_multi_node_optimizer, scatter_dataset)
from ..core.optimizer import Adam
from ..dataset import SerialIterator, get_mnist
from ..models import MLP, Classifier
from ..training import StandardUpdater, Trainer, extensions
from .train_mnist import REPORT


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch: MNIST DP")
    parser.add_argument("--batchsize", "-b", type=int, default=32,
                        help="per-rank batch size")
    parser.add_argument("--epoch", "-e", type=int, default=3)
    parser.add_argument("--unit", "-u", type=int, default=100)
    parser.add_argument("--communicator", "-c", default="jax_ici")
    parser.add_argument("--out", "-o", default="result_dp")
    parser.add_argument("--zero", action="store_true",
                        help="ZeRO-1: shard optimizer state over the ranks "
                             "(reduce-scatter grads, 1/n-chunk update, "
                             "all-gather params)")
    parser.add_argument("--double-buffering", action="store_true",
                        help="apply each step the previous step's mean "
                             "gradient, whose allreduce ran under this "
                             "step's forward and backward")
    parser.add_argument("--grad-dtype", default=None,
                        help="gradient wire dtype: bfloat16 (cast) or "
                             "int8/float8_e4m3/float8_e5m2 (quantized; "
                             "on -c hierarchical compresses the "
                             "inter-node hop only)")
    parser.add_argument("--no-error-feedback", action="store_true",
                        help="ablation: drop the quantization residual "
                             "instead of carrying it")
    parser.add_argument("--device", default="cuda",
                        help="where this rank's model runs: cuda (the "
                             "default; NCCL, fails without a card) or cpu "
                             "(gloo)")
    return parser.parse_args(argv)


def make_trainer(args, comm=None, data=None, model=None, seed=None,
                 shuffle=True):
    """The example's trainer on ``comm`` (created from the flags when
    ``None``).  ``data``: this rank's ``(train, test)`` shards (the
    scattered ``get_mnist()`` when ``None``); ``model``: the
    ``Classifier`` (a new lazy ``MLP(args.unit, 10)`` when ``None``);
    ``seed`` and ``shuffle``: the training iterator's.  Returns
    ``(trainer, comm)``."""
    if comm is None:
        comm = create_communicator(
            args.communicator, device=args.device,
            allreduce_grad_dtype=args.grad_dtype,
            error_feedback=not args.no_error_feedback)
    if model is None:
        model = Classifier(MLP(args.unit, 10, seed=None, device=args.device))
    comm.bcast_data(model)
    optimizer = create_multi_node_optimizer(
        Adam(), comm, zero_sharding=args.zero,
        double_buffering=args.double_buffering).setup(model)
    if data is None:
        train, test = get_mnist()
        train = scatter_dataset(train, comm, shuffle=True, seed=0)
        test = scatter_dataset(test, comm, shuffle=False)
    else:
        train, test = data
    train_iter = SerialIterator(train, args.batchsize, shuffle=shuffle,
                                seed=seed)
    test_iter = SerialIterator(test, args.batchsize, repeat=False,
                               shuffle=False)
    updater = StandardUpdater(train_iter, optimizer)
    trainer = Trainer(updater, (args.epoch, "epoch"), out=args.out)
    trainer.extend(create_multi_node_evaluator(
        extensions.Evaluator(test_iter, model), comm))
    if comm.rank == 0:  # rank-0-only extension attachment (reference)
        trainer.extend(extensions.LogReport())
        trainer.extend(extensions.PrintReport(REPORT))
    return trainer, comm


def main(argv=None):
    args = parse_args(argv)
    trainer, comm = make_trainer(args)
    try:
        trainer.run()
    finally:
        comm.finalize()
    return trainer


if __name__ == "__main__":
    main()
