"""Iterator backed by the native C++ gather engine.

The port of ``chainermn_tpu.dataset.native_iterator``: a drop-in for
``SerialIterator`` when the dataset is numpy arrays (or a
``TupleDataset`` of them).  Batch assembly (the gather of each batch's
rows into a contiguous buffer) runs in C++ worker threads with ring-buffer
backpressure (``utils/native/dataloader.cpp``, built with ``g++`` at first
use), and the next batch is always being assembled while the step runs.
Batches come out as stacked arrays (an ``(x, t)`` tuple for a
``TupleDataset``): pair it with ``identity_converter``.  Where the JAX
package's loader falls back when its build fails, this one raises
(``utils.native.NativeBuildFailed``).
"""

from __future__ import annotations

import numpy as np

from .datasets import TupleDataset
from .iterators import Iterator

__all__ = ["NativeBatchIterator"]


class NativeBatchIterator(Iterator):
    def __init__(self, dataset, batch_size, repeat=True, shuffle=True,
                 seed=None, n_prefetch=2, n_threads=4, zero_copy=False):
        arrays = self._extract_arrays(dataset)
        if arrays is None:
            raise TypeError(
                "NativeBatchIterator needs numpy arrays or a TupleDataset "
                "of numpy arrays; use SerialIterator for generic datasets")
        from ..utils.native import NativeLoader
        # zero_copy holds one extra slot out of the ring for the batch
        # currently in the consumer's hands
        self._loaders = [NativeLoader(a, batch_size,
                                      n_buffers=n_prefetch
                                      + (2 if zero_copy else 1),
                                      n_threads=n_threads)
                         for a in arrays]
        # zero_copy: hand out numpy views of the ring slot, no host copy.
        # Batch t's slot is recycled at the next() for batch t + 1, so
        # whatever read batch t (a host-to-device copy included) must
        # have finished by then; the default copies each batch out.
        self._zero_copy = zero_copy
        self._held = []  # (loader, buf_id) of the batch currently out
        self._n = len(arrays[0])
        self.batch_size = batch_size
        self._repeat = repeat
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self._n_prefetch = n_prefetch
        self._tuple = len(arrays) > 1
        self.reset()

    @staticmethod
    def _extract_arrays(dataset):
        if isinstance(dataset, np.ndarray):
            return [dataset]
        if isinstance(dataset, TupleDataset) and all(
                isinstance(d, np.ndarray) for d in dataset._datasets):
            return list(dataset._datasets)
        if isinstance(dataset, (list, tuple)) and all(
                isinstance(d, np.ndarray) for d in dataset):
            return list(dataset)
        return None

    # -- schedule ----------------------------------------------------------
    def _drain_pipeline(self):
        """Release held slots and drain batches already submitted to the
        C++ FIFO: otherwise a re-scheduled stream would start with the
        OLD schedule's batches while reporting the new schedule's
        positions (and each reset would leak n_prefetch ring slots)."""
        for loader, buf_id in getattr(self, "_held", []):
            try:
                loader.release(buf_id)
            except Exception:
                pass
        self._held = []
        for _ in getattr(self, "_in_flight", []):
            for loader in self._loaders:
                _, buf_id = loader.next_view()
                loader.release(buf_id)
        self._in_flight = []
        self._sched_states = []

    def _refill(self):
        self._exhausted = False
        for _ in range(self._n_prefetch):
            self._submit_next()

    def reset(self):
        self._drain_pipeline()
        self.epoch = 0
        self.is_new_epoch = False
        self.current_position = 0
        self._sched_epoch = 0
        self._previous_epoch_detail = -1.0
        self._order = (self._rng.permutation(self._n) if self._shuffle
                       else np.arange(self._n))
        self._refill()

    def _next_indices(self):
        """Advance the schedule; returns (indices, epoch, is_new_epoch).
        The epoch counter is the SCHEDULER's (``_sched_epoch``), not the
        consumer-visible ``self.epoch``: submissions run ``n_prefetch``
        ahead of consumption, and reading the consumer attribute here
        would mis-number batches submitted across an epoch boundary
        before the boundary batch is consumed."""
        i = self.current_position
        i_end = i + self.batch_size
        idx = self._order[i:i_end]
        epoch, new_epoch = self._sched_epoch, False
        if i_end >= self._n:
            if self._repeat:
                rest = i_end - self._n
                order = (self._rng.permutation(self._n) if self._shuffle
                         else np.arange(self._n))
                if rest > 0:
                    idx = np.concatenate([idx, order[:rest]])
                self._order = order
                self.current_position = rest
            else:
                self.current_position = self._n
            epoch += 1
            new_epoch = True
            self._sched_epoch = epoch
        else:
            self.current_position = i_end
        self.epoch_after = epoch
        return idx, epoch, new_epoch

    def _submit_next(self):
        if self._exhausted:
            return
        if not self._repeat and self.current_position >= self._n:
            self._exhausted = True
            return
        # schedule state BEFORE this submission: the consumer-granular
        # snapshot serialize() writes (oldest unconsumed batch's state)
        state = (self.current_position, self._sched_epoch, self._order,
                 self._rng.get_state())
        idx, epoch, new_epoch = self._next_indices()
        if idx.size == 0:
            self._exhausted = True
            return
        for loader in self._loaders:
            loader.submit(idx)
        self._sched_states.append(state)
        self._in_flight.append((epoch, new_epoch,
                                (self.current_position, self._n)))

    def __next__(self):
        if not self._in_flight:
            raise StopIteration
        self._previous_epoch_detail = self.epoch_detail
        epoch, new_epoch, (pos, n) = self._in_flight.pop(0)
        self._sched_states.pop(0)
        if self._zero_copy:
            for loader, buf_id in self._held:  # previous batch consumed
                loader.release(buf_id)
            self._held = []
            batches = []
            for loader in self._loaders:
                view, buf_id = loader.next_view()
                self._held.append((loader, buf_id))
                batches.append(view)
        else:
            batches = [loader.next() for loader in self._loaders]
        self._submit_next()
        self.epoch = epoch if new_epoch else self.epoch
        self.is_new_epoch = new_epoch
        self._detail_pos = pos
        return tuple(batches) if self._tuple else batches[0]

    next = __next__

    @property
    def epoch_detail(self):
        return self.epoch + getattr(self, "_detail_pos", 0) / self._n \
            if not self.is_new_epoch else float(self.epoch)

    @property
    def previous_epoch_detail(self):
        return self._previous_epoch_detail

    def serialize(self, serializer):
        """Consumer-granularity snapshot (the reference
        ``MultiprocessIterator``'s resume contract): the saved schedule
        state is the one from just before the oldest UNCONSUMED batch
        was submitted, so a resumed stream replays exactly the batches
        the uninterrupted run would have delivered — regardless of
        prefetch depth.  On load the C++ pipeline is drained and
        re-filled from the restored schedule."""
        from .iterators import deserialize_rng, serialize_rng
        if serializer.is_writer:
            if self._sched_states:
                pos, ep, order, rng_state = self._sched_states[0]
            else:
                pos, ep, order, rng_state = (
                    self.current_position, self._sched_epoch,
                    self._order, self._rng.get_state())
            saved_rng = np.random.RandomState()
            saved_rng.set_state(rng_state)
            serializer("current_position", int(pos))
            serializer("sched_epoch", int(ep))
            serializer("order", np.asarray(order))
            serialize_rng(serializer, saved_rng)
            serializer("epoch", self.epoch)
            serializer("is_new_epoch", int(self.is_new_epoch))
            serializer("previous_epoch_detail",
                       self._previous_epoch_detail)
            serializer("detail_pos", getattr(self, "_detail_pos", 0))
            return
        # Read EVERYTHING into locals first; commit only when the reads
        # succeed.  Missing-key tolerance is per key: snapshots written
        # by SerialIterator/MultithreadIterator (this class is their
        # drop-in) carry the shared keys but not the native-only ones
        # (sched_epoch) — for those the consumer state IS the schedule
        # state (such iterators save at consumer granularity).
        def rd(key, default):
            try:
                value = serializer(key, None)
            except KeyError:
                return default
            return default if value is None else value

        pos = rd("current_position", None)
        if pos is None:
            return  # snapshot predates iterator serialization
        epoch = int(rd("epoch", 0))
        sched_epoch = int(rd("sched_epoch", epoch))
        order = np.asarray(rd("order", self._order), dtype=np.int64)
        is_new_epoch = bool(int(rd("is_new_epoch", 0)))
        prev_detail = float(rd("previous_epoch_detail", -1.0))
        detail_pos = int(rd("detail_pos", int(pos)))
        self.current_position = int(pos)
        self._sched_epoch = sched_epoch
        self._order = order
        deserialize_rng(serializer, self._rng)
        self.epoch = epoch
        self.is_new_epoch = is_new_epoch
        self._previous_epoch_detail = prev_detail
        self._detail_pos = detail_pos
        self._drain_pipeline()
        self._refill()

    def finalize(self):
        for loader, buf_id in getattr(self, "_held", []):
            try:
                loader.release(buf_id)
            except Exception:
                pass
        self._held = []
        for loader in self._loaders:
            loader.close()
