"""Datasets (consumed-Chainer surface: ``chainer.datasets``).

The port of ``DatasetMixin`` and ``SubDataset`` from
``chainermn_tpu.dataset.datasets`` (pure host code, copied).
``SubDataset`` is what ``scatter_dataset`` returns: an index-remapped
view, so scattering ships index specs, never copies, and every shard has
the same length (the lock-step invariant that keeps collectives from
deadlocking).  The other datasets wait for ROADMAP A4.
"""

from __future__ import annotations

import numpy as np

__all__ = ["DatasetMixin", "SubDataset"]


class DatasetMixin:
    """Minimal dataset protocol: ``__len__`` + ``get_example``."""

    def __getitem__(self, index):
        if isinstance(index, slice):
            start, stop, step = index.indices(len(self))
            return [self.get_example(i) for i in range(start, stop, step)]
        if isinstance(index, (list, np.ndarray)):
            return [self.get_example(int(i)) for i in index]
        return self.get_example(int(index))

    def __len__(self):
        raise NotImplementedError

    def get_example(self, i):
        raise NotImplementedError


class SubDataset(DatasetMixin):
    """View of ``dataset[start:finish]`` through an optional index ``order``
    (reference: ``chainer/datasets/sub_dataset.py · SubDataset``)."""

    def __init__(self, dataset, start, finish, order=None):
        if start < 0 or finish > (len(order) if order is not None
                                  else len(dataset)):
            raise ValueError("subset overruns the base dataset")
        self._dataset = dataset
        self._start = start
        self._finish = finish
        self._size = finish - start
        self._order = order

    def __len__(self):
        return self._size

    def get_example(self, i):
        if i < 0 or i >= self._size:
            raise IndexError("dataset index out of range")
        index = self._start + i
        if self._order is not None:
            index = self._order[index]
        return self._dataset[int(index)]
