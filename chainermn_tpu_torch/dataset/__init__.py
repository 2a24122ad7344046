"""Batches for the training loop: ``SerialIterator``, ``concat_examples``
and the ``SubDataset`` view that ``scatter_dataset`` returns."""

from .convert import concat_examples, to_device
from .datasets import DatasetMixin, SubDataset
from .iterators import Iterator, SerialIterator

__all__ = ["DatasetMixin", "Iterator", "SerialIterator", "SubDataset",
           "concat_examples", "to_device"]
