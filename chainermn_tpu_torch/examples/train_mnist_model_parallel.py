"""Model-parallel MNIST: the twin of the JAX package's
``examples/train_mnist_model_parallel.py`` (reference: ``examples/mnist/
train_mnist_model_parallel.py``): the MLP split across two ranks by
``MultiNodeChainList``.

    torchrun --nproc_per_node=2 -m chainermn_tpu_torch.examples.train_mnist_model_parallel --device cpu

Rank 0 runs ``l1`` and ``l2`` and sends the hidden activations to rank
1, which runs ``l3`` and the loss (it reads the labels from its own copy
of the batch, ``pass_inputs``); the loss comes back to every rank.  Each
rank's plain ``Adam`` trains the layers it owns.  Run plainly it is a
world of one, and both components sit on rank 0 (the edge a local
hand-off).
"""

import argparse

from .. import F, L, create_communicator, report
from ..core.link import Chain
from ..core.optimizer import Adam
from ..dataset import SerialIterator, get_mnist
from ..links import MultiNodeChainList
from ..training import StandardUpdater, Trainer, extensions


def _seed(seed, k):
    return None if seed is None else seed + k


class MLP0(Chain):
    def __init__(self, n_units, seed=None, device=None):
        super().__init__()
        self.l1 = L.Linear(784, n_units, seed=_seed(seed, 0), device=device)
        self.l2 = L.Linear(n_units, n_units, seed=_seed(seed, 1),
                           device=device)

    def forward(self, x, t):
        return F.relu(self.l2(F.relu(self.l1(x))))


class MLP1(Chain):
    def __init__(self, n_units, n_out, seed=None, device=None):
        super().__init__()
        self.l3 = L.Linear(n_units, n_out, seed=_seed(seed, 2),
                           device=device)

    def forward(self, h, x, t):
        return F.softmax_cross_entropy(self.l3(h), t)


class SplitMLP(MultiNodeChainList):
    """``MLP0`` on rank 0, ``MLP1`` on rank 1 (rank 0 when the world has
    one rank)."""

    def __init__(self, comm, n_units, n_out, seed=None, device=None):
        super().__init__(comm)
        second = 1 if comm.size > 1 else 0
        self.add_link(MLP0(n_units, seed=seed, device=device), rank_in=None,
                      rank_out=second, rank=0)
        self.add_link(MLP1(n_units, n_out, seed=seed, device=device),
                      rank_in=0, rank_out=None, rank=second,
                      pass_inputs=True)

    def forward(self, x, t):
        loss = super().forward(x, t)
        report({"loss": loss.detach()}, self)
        return loss


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch: model-parallel MNIST")
    parser.add_argument("--batchsize", "-b", type=int, default=100)
    parser.add_argument("--epoch", "-e", type=int, default=3)
    parser.add_argument("--unit", "-u", type=int, default=100)
    parser.add_argument("--out", "-o", default="result_mp")
    parser.add_argument("--device", default="cuda",
                        help="where this rank's components run: cuda (the "
                             "default; NCCL, fails without a card) or cpu "
                             "(gloo)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    comm = create_communicator("jax_ici", device=args.device)
    try:
        model = SplitMLP(comm, args.unit, 10, device=args.device)
        optimizer = Adam().setup(model)
        train, _ = get_mnist()
        # every rank reads the same batches (rank 1 needs the labels)
        train_iter = SerialIterator(train, args.batchsize, seed=0)
        updater = StandardUpdater(train_iter, optimizer)
        trainer = Trainer(updater, (args.epoch, "epoch"), out=args.out)
        if comm.rank == 0:
            trainer.extend(extensions.LogReport())
            trainer.extend(extensions.PrintReport(
                ["epoch", "main/loss", "elapsed_time"]))
        trainer.run()
    finally:
        comm.finalize()
    return trainer


if __name__ == "__main__":
    main()
