"""Batches for the training loop: ``SerialIterator`` and
``concat_examples``."""

from .convert import concat_examples, to_device
from .iterators import Iterator, SerialIterator

__all__ = ["Iterator", "SerialIterator", "concat_examples", "to_device"]
