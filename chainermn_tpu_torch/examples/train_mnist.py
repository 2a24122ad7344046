"""MNIST MLP training, one process: the twin of the JAX package's
``examples/train_mnist.py`` (reference: ``examples/mnist/train_mnist.py``).

    python -m chainermn_tpu_torch.examples.train_mnist [-e 5] [--device cpu]

Trains ``Classifier(MLP(unit, 10))`` with ``Adam`` on the synthetic
``get_mnist`` through ``Trainer`` -> ``StandardUpdater``, with the
``Evaluator``, ``LogReport``, ``PrintReport`` and a snapshot at the last
epoch; ``-r <out>/snapshot_iter_<N>`` resumes from a snapshot (the JAX
example's snapshots load too).  The data-parallel twin is
:mod:`.train_mnist_dp`.
"""

import argparse

from ..core.optimizer import Adam
from ..dataset import SerialIterator, get_mnist
from ..models import MLP, Classifier
from ..serializers import load_npz
from ..training import StandardUpdater, Trainer, extensions

#: what PrintReport shows, as in the JAX example
REPORT = ["epoch", "main/loss", "validation/main/loss", "main/accuracy",
          "validation/main/accuracy", "elapsed_time"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="chainermn_tpu_torch: MNIST")
    parser.add_argument("--batchsize", "-b", type=int, default=100)
    parser.add_argument("--epoch", "-e", type=int, default=5)
    parser.add_argument("--unit", "-u", type=int, default=100)
    parser.add_argument("--out", "-o", default="result")
    parser.add_argument("--resume", "-r", default="")
    parser.add_argument("--device", default="cuda",
                        help="where the model runs: cuda (the default; "
                             "fails without a card) or cpu")
    return parser.parse_args(argv)


def make_trainer(args, data=None, model=None, seed=None):
    """The example's trainer.  ``data``: ``(train, test)`` datasets
    (``get_mnist()`` when ``None``); ``model``: the ``Classifier`` (a new
    lazy ``MLP(args.unit, 10)`` when ``None``); ``seed``: the training
    iterator's shuffle seed (unseeded, as the JAX example, when
    ``None``)."""
    if model is None:
        model = Classifier(MLP(args.unit, 10, seed=None, device=args.device))
    optimizer = Adam().setup(model)
    train, test = get_mnist() if data is None else data
    train_iter = SerialIterator(train, args.batchsize, seed=seed)
    test_iter = SerialIterator(test, args.batchsize, repeat=False,
                               shuffle=False)
    updater = StandardUpdater(train_iter, optimizer)
    trainer = Trainer(updater, (args.epoch, "epoch"), out=args.out)
    trainer.extend(extensions.Evaluator(test_iter, model))
    trainer.extend(extensions.LogReport())
    trainer.extend(extensions.PrintReport(REPORT))
    trainer.extend(extensions.snapshot(), trigger=(args.epoch, "epoch"))
    return trainer


def main(argv=None):
    args = parse_args(argv)
    trainer = make_trainer(args)
    if args.resume:
        load_npz(args.resume, trainer)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
