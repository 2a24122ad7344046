"""Datasets (consumed-Chainer surface: ``chainer.datasets``).

The port of ``DatasetMixin``, ``TupleDataset``, ``SubDataset`` and the
synthetic ``get_mnist`` and ``get_synthetic_imagenet`` from
``chainermn_tpu.dataset.datasets`` (pure host code, copied: the same seed
gives the same arrays).  ``SubDataset`` is what ``scatter_dataset``
returns: an index-remapped view, so scattering ships index specs, never
copies, and every shard has the same length (the lock-step invariant that
keeps collectives from deadlocking).  The other datasets wait for ROADMAP
A4.
"""

from __future__ import annotations

import numpy as np

__all__ = ["DatasetMixin", "TupleDataset", "SubDataset", "get_mnist",
           "get_synthetic_imagenet"]


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


class TupleDataset:
    """Examples ``(a[i], b[i], ...)`` zipped from equal-length datasets."""

    def __init__(self, *datasets):
        if not datasets:
            raise ValueError("no datasets given")
        length = len(datasets[0])
        for d in datasets[1:]:
            if len(d) != length:
                raise ValueError("all datasets must have the same length")
        self._datasets = datasets
        self._length = length

    def __getitem__(self, index):
        batches = [d[index] for d in self._datasets]
        if isinstance(index, (slice, list, np.ndarray)):
            length = len(batches[0])
            return [tuple(b[i] for b in batches) for i in range(length)]
        return tuple(batches)

    def __len__(self):
        return self._length


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


# -- synthetic stand-ins for the reference example datasets -----------------

def _synthetic_classification(n, shape, n_classes, template_seed,
                              sample_seed):
    """A learnable task: a class template plus noise, standardized.
    ``template_seed`` fixes the classes (shared by the train and test
    splits), ``sample_seed`` the examples."""
    dim = int(np.prod(shape))
    templates = np.random.RandomState(template_seed).normal(
        0, 1.0, size=(n_classes, dim)).astype(np.float32)
    rng = np.random.RandomState(sample_seed)
    labels = rng.randint(0, n_classes, size=n).astype(np.int32)
    x = templates[labels] + rng.normal(0, 0.8, size=(n, dim)).astype(
        np.float32)
    x = (x - x.mean()) / (x.std() + 1e-8)
    x = x.reshape((n,) + shape)
    return x.astype(np.float32), labels


def get_mnist(withlabel=True, ndim=1, n_train=6000, n_test=1000, seed=1701):
    """Synthetic MNIST-shaped data (28 x 28, 10 classes): ``ndim=1`` flat
    784 vectors, ``ndim=3`` (1, 28, 28).  Returns (train, test)."""
    shape = (784,) if ndim == 1 else (1, 28, 28)
    xtr, ytr = _synthetic_classification(n_train, shape, 10, seed, seed + 1)
    xte, yte = _synthetic_classification(n_test, shape, 10, seed, seed + 2)
    if withlabel:
        return TupleDataset(xtr, ytr), TupleDataset(xte, yte)
    return xtr, xte


def get_synthetic_imagenet(n=256, size=224, n_classes=1000, seed=1703,
                           dtype="float32"):
    """ImageNet-shaped synthetic data, NCHW: N(0, 1) floats, or with
    ``dtype="uint8"`` raw 0-255 pixels (for ``input_norm="imagenet"``)."""
    rng = np.random.RandomState(seed)
    if dtype == "uint8":
        x = rng.randint(0, 256, size=(n, 3, size, size), dtype=np.uint8)
    else:
        x = rng.normal(0, 1, size=(n, 3, size, size)).astype(dtype)
    y = rng.randint(0, n_classes, size=n).astype(np.int32)
    return TupleDataset(x, y)
