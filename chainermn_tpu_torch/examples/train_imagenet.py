"""Data-parallel ImageNet training: the twin of the JAX package's
``examples/train_imagenet.py`` (reference: ``examples/imagenet/
train_imagenet.py``; BASELINE config #2).

    python -m chainermn_tpu_torch.examples.train_imagenet --device cpu --size 64 --iterations 4
    torchrun --nproc_per_node=2 -m chainermn_tpu_torch.examples.train_imagenet --arch nin
    torchrun --nnodes=2 --nproc_per_node=8 --rdzv-backend=c10d --rdzv-endpoint=HOST:29500 -m chainermn_tpu_torch.examples.train_imagenet -c hierarchical

The reference's flow, one process per device: ``create_communicator`` ->
``Classifier`` -> (``--mnbn``) ``create_mnbn_model`` -> ``bcast_data`` ->
``create_multi_node_optimizer(MomentumSGD(lr, 0.9))`` with
``WeightDecay(1e-4)`` -> ``scatter_dataset`` of synthetic ImageNet-shaped
data -> a host iterator (``--loader``) -> (``--device-prefetch``) the
device-feed stage -> ``StandardUpdater`` or (``--fused K``)
``FusedUpdater`` -> ``Trainer``, with ``LogReport`` every 10 iterations
and ``PrintReport`` on rank 0.  ``-b`` is each rank's batch.  The JAX
script's flags are kept, but for ``--platform`` and
``--simulate-devices`` (JAX platform selection and simulated devices,
which have no counterpart: a rank is a process with its card, and
``torchrun`` makes the world); ``--device`` (default ``cuda``) is added.
"""

import argparse

import torch

from .. import (create_communicator, create_multi_node_optimizer, links,
                scatter_dataset)
from ..core.optimizer import MomentumSGD, WeightDecay
from ..dataset import (DevicePrefetchIterator, MultiprocessIterator,
                       MultithreadIterator, NativeBatchIterator,
                       TransformDataset, concat_examples,
                       get_synthetic_imagenet, identity_converter)
from ..models import NIN, VGG16, AlexNet, Classifier, GoogLeNet, ResNet50
from ..training import FusedUpdater, StandardUpdater, Trainer, extensions

ARCHS = ("resnet50", "alex", "nin", "vgg16", "googlenet")
REPORT = ["epoch", "iteration", "main/loss", "main/accuracy",
          "elapsed_time"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch: ImageNet DP")
    parser.add_argument("--batchsize", "-b", type=int, default=32,
                        help="per-rank batch size")
    parser.add_argument("--arch", "-a", default="resnet50", choices=ARCHS)
    parser.add_argument("--epoch", "-e", type=int, default=1)
    parser.add_argument("--iterations", type=int, default=0,
                        help="stop after N iterations (overrides --epoch)")
    parser.add_argument("--size", type=int, default=224)
    parser.add_argument("--n-train", type=int, default=512)
    parser.add_argument("--communicator", "-c", default="pure_nccl")
    parser.add_argument("--grad-dtype", default="bfloat16",
                        help="gradient wire dtype: a cast (bfloat16, which "
                             "on -c hierarchical compresses both hops) or "
                             "int8/float8_e4m3/float8_e5m2 (quantized with "
                             "error feedback; on -c hierarchical the "
                             "inter-node hop only)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute each ResNet stage in the backward "
                             "instead of keeping its activations")
    parser.add_argument("--layout", default="NHWC",
                        choices=["NHWC", "NCHW"],
                        help="activation layout (resnet50 only)")
    parser.add_argument("--device-prefetch", type=int, default=2,
                        help="batches kept on the card ahead of the step, "
                             "copied from pinned memory on a side stream "
                             "(0 disables the device-feed stage)")
    parser.add_argument("--out", "-o", default="result_imagenet")
    parser.add_argument("--mnbn", action="store_true",
                        help="rewrite BatchNormalization links to the "
                             "multi-node (sync) variant")
    parser.add_argument("--lr", type=float, default=None,
                        help="initial lr (default: 0.1 for resnet50, "
                             "0.01 for the archs without batch norm)")
    parser.add_argument("--fused", type=int, default=0,
                        help="K optimizer steps per update "
                             "(FusedUpdater/update_scan; 0 = per step)")
    parser.add_argument("--zero", action="store_true",
                        help="ZeRO-1: shard optimizer state over the ranks")
    parser.add_argument("--uint8-input", action="store_true",
                        help="ship raw uint8 pixels and normalize on the "
                             "device (a quarter of the fp32 copy)")
    parser.add_argument("--native-loader", action="store_true",
                        help="deprecated alias for --loader native")
    parser.add_argument("--loader", default=None,
                        choices=["thread", "native", "multiprocess"],
                        help="host batch assembly: thread "
                             "(MultithreadIterator), native (the C++ "
                             "gather engine over plain arrays), "
                             "multiprocess (process pool and "
                             "shared-memory slots)")
    parser.add_argument("--loader-workers", type=int, default=4,
                        help="worker processes for --loader multiprocess")
    parser.add_argument("--device", default="cuda",
                        help="where this rank's model runs: cuda (the "
                             "default; NCCL, fails without a card) or cpu "
                             "(gloo)")
    args = parser.parse_args(argv)
    if args.native_loader and args.loader not in (None, "native"):
        parser.error(f"--native-loader conflicts with --loader "
                     f"{args.loader}")
    args.loader = args.loader or ("native" if args.native_loader
                                  else "thread")
    return args


def _to_nhwc(example):
    """An (image CHW, label) example as (image HWC, label); module-level
    so that spawned loader workers can unpickle it."""
    return example[0].transpose(1, 2, 0), example[1]


def make_model(args):
    inorm = "imagenet" if args.uint8_input else None
    kw = dict(input_norm=inorm, device=args.device)
    if args.arch == "resnet50":
        return ResNet50(compute_dtype=torch.bfloat16, remat=args.remat,
                        layout=args.layout, **kw)
    return {"alex": AlexNet, "nin": NIN, "vgg16": VGG16,
            "googlenet": GoogLeNet}[args.arch](**kw)


def make_trainer(args, comm=None, data=None, model=None, seed=None):
    """The example's trainer on ``comm`` (created from the flags when
    ``None``).  ``data``: this rank's training shard (the scattered
    ``get_synthetic_imagenet`` when ``None``); ``model``: the
    ``Classifier`` (built from the flags when ``None``).  ``seed`` seeds
    the iterator's shuffle and the optimizer's per-step key (the JAX
    example seeds the native and multiprocess loaders with 0 and leaves
    the rest unseeded).  Returns ``(trainer, comm)``."""
    if comm is None:
        comm = create_communicator(args.communicator, device=args.device,
                                   allreduce_grad_dtype=args.grad_dtype)
    if model is None:
        model = Classifier(make_model(args))
    if args.mnbn:
        model = links.create_mnbn_model(model, comm)
    comm.bcast_data(model)
    lr = args.lr if args.lr is not None \
        else (0.1 if args.arch == "resnet50" else 0.01)
    actual = MomentumSGD(lr=lr, momentum=0.9)
    if seed is not None:
        actual.seed = seed
    optimizer = create_multi_node_optimizer(
        actual, comm, zero_sharding=args.zero).setup(model)
    optimizer.add_hook(WeightDecay(1e-4))

    if data is None:
        train = get_synthetic_imagenet(
            n=args.n_train, size=args.size,
            dtype="uint8" if args.uint8_input else "float32")
        if args.arch == "resnet50" and args.layout == "NHWC":
            train = TransformDataset(train, _to_nhwc)
        data = scatter_dataset(train, comm, shuffle=True, seed=0)
    train = data

    converter = concat_examples
    if args.loader == "native":
        # the C++ gather engine over the materialized local shard: batches
        # arrive as stacked (x, t) arrays
        xs, ys = concat_examples([train[i] for i in range(len(train))])
        train_iter = NativeBatchIterator(
            (xs, ys), args.batchsize, seed=0 if seed is None else seed)
        converter = identity_converter
    elif args.loader == "multiprocess":
        train_iter = MultiprocessIterator(
            train, args.batchsize, n_processes=args.loader_workers,
            as_arrays=True, seed=0 if seed is None else seed)
        converter = identity_converter
    else:
        train_iter = MultithreadIterator(train, args.batchsize, seed=seed)

    if args.device_prefetch and not args.fused:
        # the device-feed stage: a feeder thread converts the next batches
        # into pinned memory and copies them on a side stream (the fused
        # updater stacks K batches itself)
        train_iter = DevicePrefetchIterator(
            train_iter, size=args.device_prefetch, device=args.device,
            converter=concat_examples if args.loader == "thread" else None)
        converter = identity_converter

    if args.fused:
        updater = FusedUpdater(train_iter, optimizer, n_fused=args.fused,
                               converter=converter)
    else:
        updater = StandardUpdater(train_iter, optimizer, converter=converter)
    stop = (args.iterations, "iteration") if args.iterations \
        else (args.epoch, "epoch")
    trainer = Trainer(updater, stop, out=args.out)
    if comm.rank == 0:
        trainer.extend(extensions.LogReport(trigger=(10, "iteration")))
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
