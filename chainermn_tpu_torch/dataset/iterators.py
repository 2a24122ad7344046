"""Iterators (consumed-Chainer surface: ``chainer.iterators``).

The port of the ``Iterator`` protocol and ``SerialIterator`` of
``chainermn_tpu.dataset.iterators`` (pure host code, copied): the same
order, epoch bookkeeping and serialized keys, so a run visits the same
examples in the same batches as the JAX package's.  The prefetching
iterators are not ported.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Iterator", "SerialIterator"]


def serialize_rng(serializer, rng):
    """Write a ``np.random.RandomState``'s MT19937 state under the
    iterators' key names."""
    _, keys, pos, has_gauss, cached = rng.get_state()
    serializer("rng_keys", np.asarray(keys))
    serializer("rng_pos", int(pos))
    serializer("rng_has_gauss", int(has_gauss))
    serializer("rng_cached_gaussian", float(cached))


def deserialize_rng(serializer, rng):
    """Restore :func:`serialize_rng`'s state; a snapshot without it keeps
    the current state.  Returns True when a state was restored."""
    try:
        keys = serializer("rng_keys", None)
    except KeyError:
        return False
    if keys is None:
        return False
    rng.set_state(("MT19937", np.asarray(keys, np.uint32),
                   int(serializer("rng_pos", 0)),
                   int(serializer("rng_has_gauss", 0)),
                   float(serializer("rng_cached_gaussian", 0.0))))
    return True


class Iterator:
    """Iterator protocol: ``__next__``, ``epoch``, ``is_new_epoch``, ``reset``."""

    def __iter__(self):
        return self

    def __next__(self):
        raise NotImplementedError

    next = __next__

    def finalize(self):
        pass

    def serialize(self, serializer):
        pass


class SerialIterator(Iterator):
    """Single-thread batch iterator (reference: ``SerialIterator``)."""

    def __init__(self, dataset, batch_size, repeat=True, shuffle=None,
                 order_sampler=None, seed=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self._repeat = repeat
        self._shuffle = True if shuffle is None else shuffle
        self._rng = np.random.RandomState(seed)
        self._order_sampler = order_sampler
        self.reset()

    def reset(self):
        self.current_position = 0
        self.epoch = 0
        self.is_new_epoch = False
        self._previous_epoch_detail = -1.0
        self._order = self._new_order()

    def _new_order(self):
        n = len(self.dataset)
        if self._order_sampler is not None:
            return np.asarray(self._order_sampler(np.arange(n), 0))
        if self._shuffle:
            return self._rng.permutation(n)
        return np.arange(n)

    @property
    def epoch_detail(self):
        return self.epoch + self.current_position / len(self.dataset)

    @property
    def previous_epoch_detail(self):
        return self._previous_epoch_detail

    def _next_indices(self):
        n = len(self.dataset)
        if not self._repeat and self.current_position >= n:
            raise StopIteration
        self._previous_epoch_detail = self.epoch_detail
        i = self.current_position
        i_end = i + self.batch_size
        indices = [int(idx) for idx in self._order[i:i_end]]
        if i_end >= n:
            if self._repeat:
                rest = i_end - n
                self._order = self._new_order()
                if rest > 0:
                    indices.extend(int(idx) for idx in self._order[:rest])
                self.current_position = rest
            else:
                self.current_position = n
            self.epoch += 1
            self.is_new_epoch = True
        else:
            self.is_new_epoch = False
            self.current_position = i_end
        return indices

    def __next__(self):
        return [self.dataset[i] for i in self._next_indices()]

    next = __next__

    def serialize(self, serializer):
        self.current_position = int(serializer("current_position",
                                               self.current_position))
        self.epoch = int(serializer("epoch", self.epoch))
        self.is_new_epoch = bool(serializer("is_new_epoch",
                                            self.is_new_epoch))
        order = serializer("order", np.asarray(self._order))
        if order is not None and not serializer.is_writer:
            self._order = np.asarray(order)
        self._previous_epoch_detail = float(serializer(
            "previous_epoch_detail", self._previous_epoch_detail))
        if serializer.is_writer:
            serialize_rng(serializer, self._rng)
        else:
            deserialize_rng(serializer, self._rng)
