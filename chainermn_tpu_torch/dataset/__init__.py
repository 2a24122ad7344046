"""Batches for the training loop: the datasets, the iterators (serial,
thread, process pool, the native gather engine, and the device-feed
stage over any of them) and the converters."""

from .convert import concat_examples, identity_converter, to_device
from .datasets import (ConcatenatedDataset, DatasetMixin, DictDataset,
                       SubDataset, TransformDataset, TupleDataset,
                       get_cifar10, get_mnist, get_synthetic_imagenet,
                       split_dataset, split_dataset_random)
from .iterators import (DevicePrefetchIterator, IteratorError,
                        IteratorWorkerCrashed, IteratorWorkerError, Iterator,
                        MultiprocessIterator, MultithreadIterator,
                        SerialIterator)
from .native_iterator import NativeBatchIterator

__all__ = ["DatasetMixin", "TupleDataset", "DictDataset", "SubDataset",
           "TransformDataset", "ConcatenatedDataset", "split_dataset",
           "split_dataset_random", "get_mnist", "get_cifar10",
           "get_synthetic_imagenet", "Iterator", "SerialIterator",
           "MultiprocessIterator", "MultithreadIterator",
           "DevicePrefetchIterator", "NativeBatchIterator", "IteratorError",
           "IteratorWorkerError", "IteratorWorkerCrashed",
           "concat_examples", "to_device", "identity_converter"]
