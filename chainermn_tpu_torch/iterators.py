"""Multi-node iterators.

The port of ``chainermn_tpu.iterators`` (reference: ``chainermn/
iterators.py · create_multi_node_iterator, create_synchronized_iterator``):

* ``create_multi_node_iterator``: the master rank runs the real iterator
  and broadcasts each batch (with its epoch bookkeeping); the other ranks
  yield what they receive.  For runs where every rank must see the same
  batch (model parallelism).
* ``create_synchronized_iterator``: the master's RNG state is installed on
  every rank, so that the ranks' own iterators draw identical shuffles.

The JAX package agrees between hosts (its devices share their host's
batch); here, as in the reference, between ranks: on a communicator of
size 1 both are pass-through.
"""

from __future__ import annotations

from .dataset.iterators import Iterator

__all__ = ["create_multi_node_iterator", "create_synchronized_iterator"]


class _MultiNodeIterator(Iterator):
    def __init__(self, actual_iterator, communicator, rank_master=0):
        self.comm = communicator
        self.rank_master = rank_master
        self.actual_iterator = actual_iterator

    @property
    def _local(self):
        """True where this rank's own iterator is the source."""
        return self.comm.size <= 1 or self.comm.rank == self.rank_master

    def __next__(self):
        if self.comm.size <= 1:
            return self.actual_iterator.next()
        if self.comm.rank == self.rank_master:
            it = self.actual_iterator
            try:
                batch = it.next()
                payload = ("batch", batch, it.epoch, it.is_new_epoch,
                           it.epoch_detail, it.previous_epoch_detail)
            except StopIteration:
                payload = ("stop", None, None, None, None, None)
            payload = self.comm.bcast_obj(payload, root=self.rank_master)
        else:
            payload = self.comm.bcast_obj(None, root=self.rank_master)
        kind, batch, epoch, is_new_epoch, detail, prev_detail = payload
        if kind == "stop":
            raise StopIteration
        self._epoch = epoch
        self._is_new_epoch = is_new_epoch
        self._epoch_detail = detail
        self._previous_epoch_detail = prev_detail
        return batch

    next = __next__

    @property
    def epoch(self):
        if self._local:
            return self.actual_iterator.epoch
        return getattr(self, "_epoch", 0)

    @property
    def is_new_epoch(self):
        if self._local:
            return self.actual_iterator.is_new_epoch
        return getattr(self, "_is_new_epoch", False)

    @property
    def epoch_detail(self):
        if self._local:
            return self.actual_iterator.epoch_detail
        # the other ranks never advance their own iterator: epoch progress
        # rides the broadcast, so 'epoch'-unit triggers fire in lock-step
        return getattr(self, "_epoch_detail", 0.0)

    @property
    def previous_epoch_detail(self):
        if self._local:
            return self.actual_iterator.previous_epoch_detail
        return getattr(self, "_previous_epoch_detail", -1.0)

    def reset(self):
        if hasattr(self.actual_iterator, "reset"):
            self.actual_iterator.reset()

    def serialize(self, serializer):
        self.actual_iterator.serialize(serializer)

    def finalize(self):
        self.actual_iterator.finalize()


def create_multi_node_iterator(actual_iterator, communicator, rank_master=0):
    return _MultiNodeIterator(actual_iterator, communicator, rank_master)


def create_synchronized_iterator(actual_iterator, communicator):
    """Install rank 0's RNG state on every rank, so that local shuffles
    are identical (a pre-seeded iterator keeps rank 0's seed)."""
    rng = getattr(actual_iterator, "_rng", None)
    if rng is not None:
        state = rng.get_state() if communicator.rank == 0 else None
        state = communicator.bcast_obj(state, root=0)
        actual_iterator._rng.set_state(state)
        if hasattr(actual_iterator, "reset"):
            actual_iterator.reset()
    return actual_iterator
