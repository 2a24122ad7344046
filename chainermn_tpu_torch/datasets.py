"""Dataset scattering.

The port of ``chainermn_tpu.datasets`` (reference: ``chainermn/datasets.py
· scatter_dataset, create_empty_dataset``).  The order is the JAX
package's: the same seeded permutation, padded by wrap-around to a
multiple of ``comm.size`` so that every rank's shard has the same length.
The split follows the reference's MPMD contract: each RANK gets its
contiguous slice of the padded order (the JAX package gives each host one
slice covering all the devices it drives, and splits the batch across
them inside its compiled step).  So a rank iterates its shard with its
own, per-rank batch size.  :func:`rescatter_dataset` re-slices a shard
for a resized world (an elastic shrink or grow), per rank as well.
"""

from __future__ import annotations

import numpy as np

from .dataset.datasets import SubDataset

__all__ = ["scatter_dataset", "rescatter_dataset", "create_empty_dataset",
           "scatter_index", "get_n_iterations_for_one_epoch"]


def scatter_dataset(dataset, comm, root=0, shuffle=False, seed=None,
                    max_buf_len=256 * 1024 * 1024, force_equal_length=True):
    """Return this rank's equal-length shard of ``dataset``.

    ``root`` owns the dataset; other ranks may pass ``None`` and receive
    it over the object channel (sent only when some rank lacks it).
    ``max_buf_len`` is kept for the reference's signature: the pickled
    object channel chunks by itself."""
    if comm.size > 1:
        if comm.rank == root and dataset is None:
            raise ValueError("root must pass the dataset to scatter")
        if not all(comm.allgather_obj(dataset is not None)):
            dataset = comm.bcast_obj(dataset if comm.rank == root else None,
                                     root=root)
    if dataset is None:
        raise ValueError("dataset=None needs a communicator of size > 1 "
                         "whose root passes the dataset")
    n = len(dataset)
    if n == 0:
        raise ValueError("cannot scatter an empty dataset")
    size = comm.size
    if shuffle:
        if seed is None:
            order = comm.bcast_obj(np.random.permutation(n), root=root)
        else:
            order = np.random.RandomState(seed).permutation(n)
    else:
        order = np.arange(n)
    if force_equal_length:
        per_rank = -(-n // size)  # ceil
        total = per_rank * size
        if total > n:
            # wrap-around padding (reference behavior) keeps shards equal
            order = np.concatenate([order, order[: total - n]])
    else:
        per_rank = n // size
        order = order[:per_rank * size]
    start = comm.rank * per_rank
    return SubDataset(dataset, start, start + per_rank, order=order)


def rescatter_dataset(shard, comm):
    """Re-slice an already-scattered shard for a resized communicator
    (the JAX ``rescatter_dataset``, per rank).

    ``shard`` is a :class:`SubDataset` that :func:`scatter_dataset` made
    (its order is the permutation every rank agreed on); ``comm`` is the
    rebuilt communicator.  The same order is padded again by wrap-around
    to a multiple of the new ``comm.size`` and cut into ``comm.size``
    contiguous slices, this rank taking slice ``comm.rank``: a pure
    function of (order, new world), so every member computes its slice
    with no collective, and the union of the new shards is the union of
    the old ones (no sample dropped, none counted twice beyond the
    wrap-around padding).  The iterator's position is trainer state and
    rides the checkpoint."""
    if not isinstance(shard, SubDataset):
        raise TypeError(
            f"rescatter_dataset re-slices a SubDataset produced by "
            f"scatter_dataset, got {type(shard).__name__}; for a raw "
            f"dataset call scatter_dataset with the same seed instead")
    base = shard._dataset
    order = shard._order
    n = len(base) if order is None else len(np.unique(order))
    # the agreed permutation is the first n entries: scatter_dataset
    # appends its padding after it
    order = np.arange(n) if order is None else np.asarray(order)[:n]
    per_rank = -(-n // comm.size)
    total = per_rank * comm.size
    if total > n:
        order = np.concatenate([order, order[: total - n]])
    start = comm.rank * per_rank
    return SubDataset(base, start, start + per_rank, order=order)


def scatter_index(n_total, comm, root=0):
    """Reference ``chainermn.datasets.scatter_index``: evenly split
    ``range(n_total)`` over the ranks; returns this rank's (start, stop)."""
    per = -(-n_total // comm.size)
    return comm.rank * per, min((comm.rank + 1) * per, n_total)


class _EmptyDataset:
    def __init__(self, length):
        self._length = length

    def __len__(self):
        return self._length

    def __getitem__(self, index):
        if isinstance(index, slice):
            return [None] * len(range(*index.indices(self._length)))
        if isinstance(index, (list, np.ndarray)):
            return [None] * len(index)
        if index < 0 or index >= self._length:
            raise IndexError("dataset index out of range")
        return None


def create_empty_dataset(dataset):
    """Same-length dataset of ``None``s (reference: ranks that feed no
    data in model-parallel configurations still iterate in lock-step)."""
    return _EmptyDataset(len(dataset))


def get_n_iterations_for_one_epoch(dataset, local_batch_size, comm):
    per_rank = -(-len(dataset) // comm.size)
    return -(-per_rank // local_batch_size)
