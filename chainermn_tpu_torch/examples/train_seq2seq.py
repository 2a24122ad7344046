"""Seq2seq NMT: the twin of the JAX package's ``examples/train_seq2seq.py``
(reference: ``examples/seq2seq/seq2seq.py``).

    python -m chainermn_tpu_torch.examples.train_seq2seq --device cpu
    torchrun --nproc_per_node=2 -m chainermn_tpu_torch.examples.train_seq2seq --device cpu
    torchrun --nproc_per_node=2 -m chainermn_tpu_torch.examples.train_seq2seq --model-parallel --device cpu

BASELINE config #3 is the default: ``Seq2seq`` data-parallel through
``create_multi_node_optimizer(Adam(), comm, double_buffering=True)``
(``--no-double-buffering`` for the plain exchange), each rank on its
shard of the synthetic translation data.  ``--model-parallel`` is config
#4: ``ModelParallelSeq2seq``, the encoder on rank 0 and the decoder on
rank 1 (both on rank 0 in a world of one), every rank reading the same
batches and training, with a plain ``Adam``, the component it owns.
``-b`` is the batch of each rank.
"""

import argparse

from .. import (create_communicator, create_multi_node_optimizer,
                scatter_dataset)
from ..core.optimizer import Adam
from ..dataset import SerialIterator
from ..dataset.datasets import TupleDataset
from ..models import (ModelParallelSeq2seq, Seq2seq,
                      make_synthetic_translation_data)
from ..training import StandardUpdater, Trainer, extensions


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch: seq2seq")
    parser.add_argument("--batchsize", "-b", type=int, default=16)
    parser.add_argument("--epoch", "-e", type=int, default=5)
    parser.add_argument("--unit", "-u", type=int, default=64)
    parser.add_argument("--layers", "-l", type=int, default=2)
    parser.add_argument("--communicator", "-c", default="pure_nccl")
    parser.add_argument("--model-parallel", action="store_true")
    parser.add_argument("--no-double-buffering", action="store_true")
    parser.add_argument("--out", "-o", default="result_seq2seq")
    parser.add_argument("--device", default="cuda",
                        help="where this rank's model runs: cuda (the "
                             "default; NCCL, fails without a card) or cpu "
                             "(gloo)")
    return parser.parse_args(argv)


def make_trainer(args, comm):
    """The example's trainer on ``comm``."""
    xs, ys_in, ys_out = make_synthetic_translation_data(n=512)
    dataset = TupleDataset(xs, ys_in, ys_out)
    if args.model_parallel:
        model = ModelParallelSeq2seq(
            comm, 40, 40, args.unit, n_layers=args.layers,
            rank_decoder=1 if comm.size > 1 else 0, device=args.device)
        optimizer = Adam().setup(model)
        train = dataset
    else:
        model = Seq2seq(40, 40, args.unit, n_layers=args.layers,
                        device=args.device)
        comm.bcast_data(model)
        optimizer = create_multi_node_optimizer(
            Adam(), comm,
            double_buffering=not args.no_double_buffering).setup(model)
        train = scatter_dataset(dataset, comm, shuffle=True, seed=0)
    train_iter = SerialIterator(train, args.batchsize, seed=0)
    updater = StandardUpdater(train_iter, optimizer)
    trainer = Trainer(updater, (args.epoch, "epoch"), out=args.out)
    if comm.rank == 0:
        trainer.extend(extensions.LogReport())
        trainer.extend(extensions.PrintReport(
            ["epoch", "main/loss", "elapsed_time"]))
    return trainer


def main(argv=None):
    args = parse_args(argv)
    comm = create_communicator(args.communicator, device=args.device)
    try:
        trainer = make_trainer(args, comm)
        trainer.run()
    finally:
        comm.finalize()
    return trainer


if __name__ == "__main__":
    main()
