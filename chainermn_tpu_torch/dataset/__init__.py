"""Batches for the training loop: ``SerialIterator``, ``concat_examples``,
``TupleDataset``, the ``SubDataset`` view that ``scatter_dataset``
returns, and the synthetic ``get_mnist`` and ``get_synthetic_imagenet``."""

from .convert import concat_examples, to_device
from .datasets import (DatasetMixin, SubDataset, TupleDataset, get_mnist,
                       get_synthetic_imagenet)
from .iterators import Iterator, SerialIterator

__all__ = ["DatasetMixin", "Iterator", "SerialIterator", "SubDataset",
           "TupleDataset", "concat_examples", "get_mnist",
           "get_synthetic_imagenet", "to_device"]
