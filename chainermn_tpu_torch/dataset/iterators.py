"""Iterators (consumed-Chainer surface: ``chainer.iterators``).

The port of ``chainermn_tpu.dataset.iterators`` (the host code copied):
the same order, epoch bookkeeping and serialized keys, so a run visits the
same examples in the same batches as the JAX package's.  Three prefetch
tiers share one consumer contract:

* ``MultithreadIterator``: a background thread keeps batches ready;
* ``MultiprocessIterator`` (``multiprocess_iterator.py``): a process pool
  assembling batches into shared-memory slots, for transforms that hold
  the GIL;
* ``NativeBatchIterator`` (``native_iterator.py``): the C++ gather engine
  for plain-array datasets.

``DevicePrefetchIterator`` stacks over any of them: a feeder thread
converts the next batches into pinned host memory and starts their
copies to the card on a side CUDA stream, so the input copy overlaps
the step.  Each keeps the resume contract: ``serialize`` records the
CONSUMER position, so a resume is bit-exact whatever the prefetch depth.
"""

from __future__ import annotations

import queue
import sys
import threading
import time

import numpy as np
import torch

from .._device import resolve_device
from .convert import to_device

__all__ = ["Iterator", "SerialIterator", "MultiprocessIterator",
           "MultithreadIterator", "DevicePrefetchIterator",
           "IteratorError", "IteratorWorkerError", "IteratorWorkerCrashed"]


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

    def _copy_state_from(self, other):
        """Clone another SerialIterator's position, order and RNG."""
        self.current_position = other.current_position
        self.epoch = other.epoch
        self.is_new_epoch = other.is_new_epoch
        self._previous_epoch_detail = other._previous_epoch_detail
        self._order = np.array(other._order)
        self._rng.set_state(other._rng.get_state())

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


def _make_shadow_pair(dataset, batch_size, repeat, shuffle, seed,
                      from_state=None):
    """(lead, shadow) ``SerialIterator`` pair of the prefetching
    iterators: the lead runs ahead feeding the pipeline, the shadow
    advances once per CONSUMED batch (the serializable position).  Both
    start from ``from_state`` when resuming."""
    lead = SerialIterator(dataset, batch_size, repeat=repeat,
                          shuffle=shuffle, seed=seed)
    shadow = SerialIterator(dataset, batch_size, repeat=repeat,
                            shuffle=shuffle, seed=seed)
    if from_state is not None:
        shadow._copy_state_from(from_state)
        lead._copy_state_from(shadow)
    else:
        shadow._copy_state_from(lead)
    return lead, shadow


def _serialize_consumer_shadow(it, serializer):
    """The consumer-shadow resume contract of ``MultithreadIterator`` and
    ``MultiprocessIterator`` (one copy, so their snapshots stay
    interchangeable): the writer snapshots the shadow; the reader
    restores it, tears the pipeline down and rebuilds it from the
    restored position.  A snapshot without iterator state (KeyError)
    keeps the fresh stream."""
    if serializer.is_writer:
        it._state.serialize(serializer)
        return
    try:
        it._state.serialize(serializer)
    except KeyError:
        return
    it.finalize()
    it._setup(from_state=it._state)


class MultithreadIterator(Iterator):
    """Background-thread prefetching iterator: a worker thread keeps
    ``n_prefetch`` batches ready, so host input preparation overlaps the
    step.  ``n_threads`` is the reference's signature (one worker)."""

    def __init__(self, dataset, batch_size, repeat=True, shuffle=None,
                 n_threads=1, n_prefetch=2, seed=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self._repeat = repeat
        self._shuffle = shuffle
        self._seed = seed
        self._n_prefetch = max(1, n_prefetch)
        self._setup()

    def _setup(self, from_state=None):
        # the worker's lead runs up to n_prefetch batches ahead of the
        # consumer shadow that serialize records
        self._base, self._state = _make_shadow_pair(
            self.dataset, self.batch_size, self._repeat, self._shuffle,
            self._seed, from_state)
        self._queue = queue.Queue(maxsize=self._n_prefetch)
        self._stop = threading.Event()
        # the worker's state is bound as arguments: a worker not yet
        # stopped only ever touches its own (discarded) objects
        self._thread = threading.Thread(
            target=self._worker, args=(self._base, self._queue, self._stop),
            daemon=True)
        self._started = False
        self._exhausted = False
        self._error = None
        self.epoch = self._state.epoch
        self.is_new_epoch = self._state.is_new_epoch

    def reset(self):
        """Stop the worker and start again from a fresh epoch."""
        self.finalize()
        self._setup()

    @staticmethod
    def _worker(base, q, stop):
        try:
            while not stop.is_set():
                try:
                    batch = base.next()
                except StopIteration:
                    q.put(StopIteration)
                    return
                q.put(batch)
        except Exception as e:  # handed to the consumer, raised there
            q.put(e)

    def __next__(self):
        if self._exhausted:
            # sticky: the worker's one StopIteration is gone
            raise StopIteration
        if self._error is not None:
            raise self._error
        if not self._started:
            self._thread.start()
            self._started = True
        item = self._queue.get()
        if item is StopIteration:
            self._exhausted = True
            raise StopIteration
        if isinstance(item, Exception):
            # sticky: the worker died delivering this
            self._error = item
            raise item
        self._state._next_indices()   # the consumer shadow, in lock-step
        self.epoch = self._state.epoch
        self.is_new_epoch = self._state.is_new_epoch
        return item

    next = __next__

    @property
    def epoch_detail(self):
        return self._state.epoch_detail

    @property
    def previous_epoch_detail(self):
        return self._state.previous_epoch_detail

    def serialize(self, serializer):
        """The CONSUMER position (resume continues the stream where the
        training saw it, whatever the prefetch depth); a reader rebuilds
        the pipeline from the restored position."""
        _serialize_consumer_shadow(self, serializer)

    def finalize(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._started:   # the drained queue unblocks a pending put
            self._thread.join(timeout=5.0)


class _FeedDone:
    """Sentinel: the feeder drained a non-repeating base iterator."""


class _FeedError:
    """A feeder-thread exception, raised again on the consumer."""

    def __init__(self, error):
        self.error = error


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


class DevicePrefetchIterator(Iterator):
    """Device-feed stage: keeps up to ``size`` batches already on
    ``device`` (``None``: ``cuda``) ahead of the consumer, over any host
    iterator (Serial, Multithread, Multiprocess, NativeBatch).  The JAX
    package's ``sharding`` argument is ``device`` here: a rank feeds its
    own card.

    Each batch goes through ``converter`` (e.g. ``concat_examples``) on
    the host, into pinned host memory, and to a CUDA device by
    non-blocking copies on a side stream, followed by an event.  The
    consumer's stream waits on that event before the batch is handed
    over, and each tensor is marked as used by the consumer's stream
    (``record_stream``), so the caching allocator does not reuse its
    memory while the step still reads it.  With ``overlap=True``
    (default) a feeder thread does all of that ahead of the consumer,
    whose ``next()`` blocks only when the feed cannot keep up; the time
    it blocks adds to :attr:`input_stall_ms`.  ``overlap=False`` fills
    synchronously (the copies still run on the side stream).  Give the
    updater ``identity_converter``: batches arrive as device tensors.
    :attr:`h2d_bytes` and :attr:`h2d_batches` count the bytes and the
    batches copied.

    Resume contract (as ``MultithreadIterator``'s): ``serialize`` writes
    the base iterator's state from just before the oldest unconsumed
    batch was fetched, so a resume is bit-exact whatever ``size``.
    """

    def __init__(self, base_iterator, size=2, device=None, converter=None,
                 overlap=True):
        self.base = base_iterator
        self._size = max(1, size)
        self._device = resolve_device(device)
        self._converter = converter
        self._overlap = overlap
        self._stall_s = 0.0
        self.h2d_bytes = 0
        self.h2d_batches = 0
        self._stream = (torch.cuda.Stream(device=self._device)
                        if self._device.type == "cuda" else None)
        self._setup_feed()

    def _setup_feed(self):
        self._buf = []       # sync mode: (batch, event) in flight
        self._meta = []      # sync mode: per-batch epoch bookkeeping
        self._states = []    # base state BEFORE fetching each batch
        self._detail = None
        self._prev_detail = None
        self.epoch = getattr(self.base, "epoch", 0)
        self.is_new_epoch = getattr(self.base, "is_new_epoch", False)
        if self._overlap:
            self._q = queue.Queue(maxsize=self._size)
            self._stop = threading.Event()
            self._base_lock = threading.Lock()
            self._states_lock = threading.Lock()
            # everything the feeder touches is bound as arguments: an old
            # feeder that outlived _teardown_feed's wait only ever
            # touches its own discarded objects
            self._thread = threading.Thread(
                target=self._feeder,
                args=(self.base, self._q, self._stop, self._states,
                      self._states_lock, self._base_lock), daemon=True)
            self._started = False
            self._drained = False
            self._feed_error = None

    @staticmethod
    def _snap(base):
        from ..serializers.npz import DictionarySerializer
        s = DictionarySerializer()
        base.serialize(s)
        return s.target

    @staticmethod
    def _meta_of(base):
        return (getattr(base, "epoch", 0),
                getattr(base, "is_new_epoch", False),
                getattr(base, "epoch_detail", None),
                getattr(base, "previous_epoch_detail", None))

    def _place(self, batch):
        """``(batch on the device, event)``: the event follows its
        copies on the side stream (None off CUDA)."""
        if self._converter is not None:
            batch = self._converter(batch)
        if self._stream is None:
            placed = to_device(batch, self._device)
            event = None
        else:
            with torch.cuda.device(self._device), \
                    torch.cuda.stream(self._stream):
                placed = to_device(batch, self._device)
                event = torch.cuda.Event()
                event.record(self._stream)
        self.h2d_bytes += sum(t.numel() * t.element_size()
                              for t in _tensors(placed))
        self.h2d_batches += 1
        return placed, event

    def _hand_over(self, placed, event):
        """The consumer's stream waits for the batch's copies; its tensors
        are marked as used there."""
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for t in _tensors(placed):
                t.record_stream(consumer)
        return placed

    # -- overlapped feed ----------------------------------------------------
    def _feeder(self, base, q, stop, states, states_lock, base_lock):
        try:
            while not stop.is_set():
                with base_lock:
                    # snapshot, fetch and state append are one unit:
                    # serialize's writer takes the same lock, so it never
                    # sees a fetched batch without its state
                    state = self._snap(base)
                    try:
                        batch = base.next()
                    except StopIteration:
                        q.put(_FeedDone)
                        return
                    meta = self._meta_of(base)
                    with states_lock:
                        states.append(state)
                q.put((self._place(batch), meta))
        except Exception as e:  # handed to the consumer, raised there
            q.put(_FeedError(e))

    def _teardown_feed(self):
        """Stop the feeder (overlap mode) and drop buffered batches; the
        base iterator is left as it is.  Waits up to 30 s for the feeder
        to leave ``base.next()``, draining the queue so that a pending
        put cannot wedge it."""
        if not self._overlap:
            return
        self._stop.set()
        if self._started:
            deadline = time.monotonic() + 30.0
            while self._thread.is_alive() \
                    and time.monotonic() < deadline:
                try:
                    while True:
                        self._q.get_nowait()
                except queue.Empty:
                    pass
                self._thread.join(timeout=0.5)
            if self._thread.is_alive():
                print("chainermn_tpu_torch: DevicePrefetchIterator feeder "
                      "still blocked in base.next() after 30 s; going on "
                      "(the old feeder may take one batch from the base "
                      "iterator)", file=sys.stderr)
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    # -- sync feed ----------------------------------------------------------
    def _fill(self):
        while len(self._buf) < self._size:
            state = self._snap(self.base)
            try:
                batch = self.base.next()
            except StopIteration:
                return  # hand out what is in flight
            self._buf.append(self._place(batch))
            self._states.append(state)
            self._meta.append(self._meta_of(self.base))

    def __next__(self):
        if not self._overlap:
            t0 = time.perf_counter()
            self._fill()
            self._stall_s += time.perf_counter() - t0
            if not self._buf:
                raise StopIteration
            placed = self._buf.pop(0)
            self._states.pop(0)
            (self.epoch, self.is_new_epoch, self._detail,
             self._prev_detail) = self._meta.pop(0)
            return self._hand_over(*placed)
        if self._drained:
            raise StopIteration
        if self._feed_error is not None:
            raise self._feed_error
        if not self._started:
            self._thread.start()
            self._started = True
        t0 = time.perf_counter()
        item = self._q.get()
        self._stall_s += time.perf_counter() - t0
        if item is _FeedDone:
            self._drained = True
            raise StopIteration
        if isinstance(item, _FeedError):
            # sticky: the feeder exited delivering this
            self._feed_error = item.error
            raise item.error
        placed, meta = item
        with self._states_lock:
            self._states.pop(0)
        (self.epoch, self.is_new_epoch, self._detail,
         self._prev_detail) = meta
        return self._hand_over(*placed)

    next = __next__

    @property
    def epoch_detail(self):
        return self._detail if self._detail is not None \
            else getattr(self.base, "epoch_detail", None)

    @property
    def previous_epoch_detail(self):
        return self._prev_detail if self._detail is not None \
            else getattr(self.base, "previous_epoch_detail", None)

    @property
    def input_stall_ms(self):
        """Milliseconds ``next()`` has spent blocked on the feed: the
        input cost the overlap does not hide."""
        return self._stall_s * 1e3

    def reset(self):
        self._teardown_feed()
        if hasattr(self.base, "reset"):
            self.base.reset()
        self._setup_feed()

    def serialize(self, serializer):
        if serializer.is_writer:
            # the consumer position: the state before the oldest
            # unconsumed batch, else the base's current state (under the
            # base lock, which excludes a feeder mid-fetch)
            if self._overlap and self._started:
                with self._base_lock:
                    with self._states_lock:
                        state = dict(self._states[0]) if self._states \
                            else None
                    if state is None:
                        state = self._snap(self.base)
            else:
                state = (self._states[0] if self._states
                         else self._snap(self.base))
            for key, value in state.items():
                serializer(key, value)
            return
        # read: the stored keys are exactly what base.serialize reads
        self._teardown_feed()
        self.base.serialize(serializer)
        self._setup_feed()

    def finalize(self):
        self._teardown_feed()
        self._buf, self._meta, self._states = [], [], []
        if hasattr(self.base, "finalize"):
            self.base.finalize()


# the process-pool iterator (shared-memory slots, typed worker errors)
# lives in multiprocess_iterator.py; exported here under the reference's
# import path
from .multiprocess_iterator import (  # noqa: E402  (after the base classes)
    IteratorError, IteratorWorkerCrashed, IteratorWorkerError,
    MultiprocessIterator)
