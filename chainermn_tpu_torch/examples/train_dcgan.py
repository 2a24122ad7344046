"""Data-parallel CIFAR DCGAN: the twin of the JAX package's
``examples/train_dcgan.py`` (reference: ``examples/dcgan/train_dcgan.py``
under ``mpiexec``; BASELINE config #5).

    python -m chainermn_tpu_torch.examples.train_dcgan --device cpu
    torchrun --nproc_per_node=2 -m chainermn_tpu_torch.examples.train_dcgan --device cpu

The reference's flow, one process per device: ``create_communicator`` ->
``bcast_data`` of both networks -> ``create_multi_node_optimizer(Adam(
alpha=2e-4, beta1=0.5))`` for each -> ``scatter_dataset`` of the synthetic
CIFAR-10 images -> ``DCGANUpdater``, with the multi-node checkpointer
every epoch (run again into the same ``-o``, every rank resumes from the
newest snapshot all of them hold, and rank 0 prints ``resumed from
iteration N``), and ``LogReport``/``PrintReport`` on rank 0.  ``-b`` is
the batch of each rank (the JAX script's iterator takes ``-b`` times the
world size, one global batch for its one controller).
"""

import argparse

from .. import (create_communicator, create_multi_node_checkpointer,
                create_multi_node_optimizer, scatter_dataset)
from ..core.optimizer import Adam
from ..dataset import SerialIterator, get_cifar10
from ..models import DCGANUpdater, Discriminator, Generator
from ..training import Trainer, extensions

REPORT = ["epoch", "iteration", "gen/loss", "dis/loss", "elapsed_time"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch: DCGAN")
    parser.add_argument("--batchsize", "-b", type=int, default=16,
                        help="per-rank batch size")
    parser.add_argument("--epoch", "-e", type=int, default=2)
    parser.add_argument("--n-hidden", type=int, default=64)
    parser.add_argument("--ch", type=int, default=64)
    parser.add_argument("--communicator", "-c", default="pure_nccl")
    parser.add_argument("--out", "-o", default="result_dcgan")
    parser.add_argument("--device", default="cuda",
                        help="where this rank's networks run: cuda (the "
                             "default; NCCL, fails without a card) or cpu "
                             "(gloo)")
    return parser.parse_args(argv)


def make_trainer(args, comm=None):
    """The example's trainer on ``comm`` (created from the flags when
    ``None``), its checkpointer extended and consensus-loaded.  Returns
    ``(trainer, comm, resumed)``: ``resumed`` is the iteration a snapshot
    resumed from, or None."""
    if comm is None:
        comm = create_communicator(args.communicator, device=args.device)
    gen = Generator(n_hidden=args.n_hidden, ch=args.ch, device=args.device)
    dis = Discriminator(ch=args.ch, device=args.device)
    comm.bcast_data(gen)
    comm.bcast_data(dis)
    opt_gen = create_multi_node_optimizer(
        Adam(alpha=2e-4, beta1=0.5), comm).setup(gen)
    opt_dis = create_multi_node_optimizer(
        Adam(alpha=2e-4, beta1=0.5), comm).setup(dis)
    train, _ = get_cifar10(withlabel=False, n_train=512)
    train = scatter_dataset(train, comm, shuffle=True, seed=0)
    train_iter = SerialIterator(train, args.batchsize)
    updater = DCGANUpdater(train_iter, opt_gen, opt_dis)
    trainer = Trainer(updater, (args.epoch, "epoch"), out=args.out)
    checkpointer = create_multi_node_checkpointer(comm, name="dcgan")
    trainer.extend(checkpointer, trigger=(1, "epoch"))
    resumed = checkpointer.maybe_load(trainer, path=args.out)
    if comm.rank == 0:
        trainer.extend(extensions.LogReport(trigger=(10, "iteration")))
        trainer.extend(extensions.PrintReport(REPORT))
    return trainer, comm, resumed


def main(argv=None):
    args = parse_args(argv)
    trainer, comm, resumed = make_trainer(args)
    if resumed and comm.rank == 0:
        print(f"resumed from iteration {resumed}", flush=True)
    try:
        trainer.run()
    finally:
        comm.finalize()
    return trainer


if __name__ == "__main__":
    main()
