"""Process-pool batch iterator (reference: ``chainer.iterators.
MultiprocessIterator``).

The port of ``chainermn_tpu.dataset.multiprocess_iterator`` (host code,
copied).  For per-example transforms that hold the GIL: a pool of worker
processes runs ``dataset[i]`` and assembles each batch directly into a
``multiprocessing.shared_memory`` ring slot, so arrays cross the process
boundary as one shared-memory write and one copy out in the parent,
never a pickle.  Control traffic (index lists, slot ids, completion
records) stays on small queues.

* A scheduler (``SerialIterator`` bookkeeping) decides each batch's
  indices ahead; the workers are stateless, so delivery follows the
  schedule (``ordered=True``, default) whichever worker finishes first,
  or completion order (``ordered=False``).
* A consumer-side shadow advances only when the consumer takes a batch,
  so ``serialize`` records a resumable position, with the same keys as
  the serial, thread and native iterators (snapshots are
  interchangeable).
* A dead worker is found (liveness poll while waiting) and raised as
  :class:`IteratorWorkerCrashed`; a transform's exception comes back as
  :class:`IteratorWorkerError` with the worker's traceback.

The slot layout is probed from ``dataset[0]``; a batch whose examples do
not match it, or a dataset of non-array examples, is pickled through the
result queue instead.  ``shared_mem`` caps a slot's bytes; 0 forces the
pickle path.

Workers run numpy and the dataset only, never CUDA.  They are forked
(no pickling of the dataset) unless CUDA is initialized in the parent:
then they are spawned, and the dataset must pickle.
"""

from __future__ import annotations

import os
import queue as _queue_mod
import traceback

import numpy as np

from .iterators import (Iterator, _make_shadow_pair,
                        _serialize_consumer_shadow)

__all__ = ["MultiprocessIterator", "IteratorError", "IteratorWorkerError",
           "IteratorWorkerCrashed"]


def _cuda_initialized():
    import torch
    return torch.cuda.is_initialized()


class IteratorError(RuntimeError):
    """Base class for iterator pipeline failures."""


class IteratorWorkerError(IteratorError):
    """The per-example transform raised inside a worker process; carries
    the worker-side traceback text."""

    def __init__(self, exc_type, message, tb_text):
        super().__init__(
            f"{exc_type} in MultiprocessIterator worker: {message}\n"
            f"--- worker traceback ---\n{tb_text}")
        self.exc_type = exc_type
        self.worker_traceback = tb_text


class IteratorWorkerCrashed(IteratorError):
    """A worker process died without reporting a result (segfault,
    os._exit, OOM-kill): the pipeline cannot make progress."""

    def __init__(self, pid, exitcode):
        super().__init__(
            f"MultiprocessIterator worker pid={pid} died with "
            f"exitcode={exitcode} (segfault/os._exit/OOM-kill?); "
            "the iterator cannot continue — rebuild it (reset()) or fix "
            "the transform")
        self.pid = pid
        self.exitcode = exitcode


class _SlotLayout:
    """Per-slot shared-memory layout: ``batch_size`` examples, each a
    tuple of fixed-shape arrays, stored field-by-field as contiguous
    ``[batch_size, *shape]`` blocks.  Picklable (shipped to spawn-started
    workers)."""

    def __init__(self, tuple_mode, shapes, dtypes, batch_size):
        self.tuple_mode = tuple_mode
        self.shapes = shapes
        self.dtypes = [np.dtype(d) for d in dtypes]
        self.batch_size = batch_size
        self.offsets = []
        off = 0
        for shape, dtype in zip(shapes, self.dtypes):
            self.offsets.append(off)
            nbytes = batch_size * int(np.prod(shape, dtype=np.int64)) \
                * dtype.itemsize
            # 64-byte-align every field block (cheap, keeps memcpy fast)
            off += (nbytes + 63) & ~63
        self.slot_bytes = off

    def field_views(self, buf, slot_off):
        """One writable ndarray view per field over ``buf`` at the slot."""
        return [np.ndarray((self.batch_size,) + shape, dtype=dtype,
                           buffer=buf, offset=slot_off + off)
                for shape, dtype, off
                in zip(self.shapes, self.dtypes, self.offsets)]


def _probe_layout(dataset, batch_size, shared_mem):
    """Build a :class:`_SlotLayout` from ``dataset[0]``, or None when the
    dataset can't use the shared-memory path (ragged/object examples, or
    a slot that would exceed the ``shared_mem`` cap)."""
    try:
        example = dataset[0]
    except Exception:
        return None
    fields = example if isinstance(example, (tuple, list)) else (example,)
    shapes, dtypes = [], []
    for f in fields:
        try:
            a = np.asarray(f)
        except Exception:
            return None
        if a.dtype == object or a.dtype.hasobject:
            return None
        shapes.append(a.shape)
        dtypes.append(a.dtype)
    layout = _SlotLayout(isinstance(example, (tuple, list)),
                         shapes, dtypes, batch_size)
    if shared_mem is not None and layout.slot_bytes > shared_mem:
        return None
    if layout.slot_bytes == 0:
        return None
    return layout


class _LayoutMismatch(Exception):
    """A batch's example shapes/dtypes don't match the probed layout —
    internal signal for the per-batch pickle fallback."""


def _assemble_into_slot(layout, buf, slot_off, examples):
    """Write ``examples`` into the slot's field blocks.  Raises
    :class:`_LayoutMismatch` when an example disagrees with the probe."""
    views = layout.field_views(buf, slot_off)
    for j, example in enumerate(examples):
        fields = example if layout.tuple_mode else (example,)
        if len(fields) != len(views):
            raise _LayoutMismatch
        for view, shape, dtype, f in zip(views, layout.shapes,
                                         layout.dtypes, fields):
            fa = np.asarray(f)
            if fa.shape != shape or fa.dtype != dtype:
                raise _LayoutMismatch
            view[j] = fa


def _worker_loop(dataset, shm_name, layout, task_q, result_q):
    """Worker process body: pull (seq, slot, indices) tasks, run the
    per-example transform, assemble into the shared slot (pickle
    fallback on layout mismatch), report completion.  Exits on the None
    sentinel.  Top-level so spawn-started workers can import it."""
    shm = None
    if shm_name is not None:
        from multiprocessing import shared_memory
        # The parent owns the segment.  On 3.10 attaching ALSO registers
        # with the resource tracker (bpo-39959), and with fork the
        # tracker process is shared — a per-child unregister would strip
        # the parent's registration (and later ones KeyError in the
        # tracker).  Suppress the attach-side registration instead.
        try:
            from multiprocessing import resource_tracker
            _orig_register = resource_tracker.register
            resource_tracker.register = lambda *a, **k: None
        except Exception:
            resource_tracker = None
        try:
            shm = shared_memory.SharedMemory(name=shm_name)
        finally:
            if resource_tracker is not None:
                resource_tracker.register = _orig_register
    try:
        while True:
            try:
                task = task_q.get(timeout=5.0)
            except _queue_mod.Empty:
                # orphan guard: a SIGKILLed parent never sends the
                # sentinel (daemon cleanup only runs on clean exit) —
                # without this check the worker would block in get()
                # forever, pinning inherited fds (e.g. a pipe a
                # supervisor is waiting to see EOF on)
                import multiprocessing as _mp
                parent = _mp.parent_process()
                if parent is not None and not parent.is_alive():
                    return
                continue
            if task is None:
                return
            seq, slot, indices = task
            try:
                examples = [dataset[int(i)] for i in indices]
                if shm is not None:
                    try:
                        _assemble_into_slot(
                            layout, shm.buf, slot * layout.slot_bytes,
                            examples)
                        result_q.put((seq, slot, "shm", len(examples)))
                        continue
                    except _LayoutMismatch:
                        pass
                result_q.put((seq, slot, "pickle", examples))
            except Exception as e:
                result_q.put((seq, slot, "error",
                              (type(e).__name__, str(e),
                               traceback.format_exc())))
    except (KeyboardInterrupt, EOFError, OSError):
        pass  # parent tore the queues down first: silent exit
    finally:
        if shm is not None:
            try:
                shm.close()
            except Exception:
                pass


class _PoolResources:
    """Everything `finalize` must tear down, detached from the iterator
    object so a ``weakref.finalize`` can run the teardown at GC time
    without resurrecting it."""

    def __init__(self):
        self.procs = []
        self.task_q = None
        self.result_q = None
        self.shm = None
        self.closed = False

    def close(self):
        if self.closed:
            return
        self.closed = True
        try:
            for _ in self.procs:
                try:
                    self.task_q.put_nowait(None)
                except Exception:
                    break
            for p in self.procs:
                p.join(timeout=2.0)
            for p in self.procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=2.0)
        except Exception:
            pass
        for q in (self.task_q, self.result_q):
            try:
                q.cancel_join_thread()
                q.close()
            except Exception:
                pass
        if self.shm is not None:
            try:
                self.shm.close()
            except Exception:
                pass
            try:
                self.shm.unlink()
            except Exception:
                pass
            self.shm = None


class MultiprocessIterator(Iterator):
    """Process-pool prefetching iterator (the reference's namesake).

    Args:
        dataset: indexable dataset; ``dataset[i]`` (the per-example
            transform) runs in the worker processes.  With the default
            ``fork`` start method it is inherited copy-on-write; with
            ``spawn`` it must pickle.
        batch_size: examples per batch.
        repeat / shuffle / seed: `SerialIterator` semantics.
        n_processes: worker count (default ``os.cpu_count()``).
        n_prefetch: completed batches kept ready ahead of the consumer.
        shared_mem: per-slot byte cap (reference knob).  None = size
            from probing ``dataset[0]``; 0 disables shared memory (all
            batches pickle through the result queue).
        ordered: True (default) delivers batches in schedule order —
            identical stream to `SerialIterator`; False delivers in
            completion order (same multiset per epoch, lower latency
            under skewed transform cost).
        as_arrays: True returns the batch as a tuple of stacked
            ``[n, *shape]`` arrays (`NativeBatchIterator` convention,
            pair with ``identity_converter``); False (default) returns
            the reference's list-of-examples (views into the stacked
            arrays — `concat_examples` compatible).
        start_method: multiprocessing start method; default ``fork``
            where available (no dataset pickling) and CUDA is not
            initialized in this process, else ``spawn``.
        worker_timeout: seconds to wait on a dead pipeline before
            declaring it crashed (liveness is polled much faster; this
            only bounds the no-progress-no-corpse case).
    """

    def __init__(self, dataset, batch_size, repeat=True, shuffle=None,
                 n_processes=None, n_prefetch=2, shared_mem=None,
                 seed=None, ordered=True, as_arrays=False,
                 start_method=None, worker_timeout=60.0):
        self.dataset = dataset
        self.batch_size = batch_size
        self._repeat = repeat
        self._shuffle = shuffle
        self._seed = seed
        self._n_processes = max(1, n_processes or os.cpu_count() or 2)
        self._n_prefetch = max(1, n_prefetch)
        self._shared_mem = shared_mem
        self._ordered = ordered
        self._as_arrays = as_arrays
        self._start_method = start_method
        self._worker_timeout = worker_timeout
        self._res = None
        self._finalized = False
        # probe once: the layout depends only on constructor-fixed
        # inputs, and dataset[0] runs the (possibly expensive) transform
        # in the parent — reset()/resume rebuilds must not re-pay it
        self._layout = None if shared_mem == 0 else _probe_layout(
            dataset, batch_size, shared_mem)
        self._setup()

    # -- pipeline lifecycle -------------------------------------------------
    def _setup(self, from_state=None):
        import multiprocessing as mp
        import weakref

        # scheduler decides batch indices ahead of the workers;
        # consumer shadow advances per delivered batch (serialize source)
        self._sched, self._state = _make_shadow_pair(
            self.dataset, self.batch_size, self._repeat, self._shuffle,
            self._seed, from_state)

        method = self._start_method or (
            "fork" if "fork" in mp.get_all_start_methods()
            and not _cuda_initialized() else "spawn")
        ctx = mp.get_context(method)

        res = _PoolResources()
        self._n_slots = self._n_prefetch + self._n_processes
        if self._layout is not None:
            from multiprocessing import shared_memory
            res.shm = shared_memory.SharedMemory(
                create=True,
                size=self._n_slots * self._layout.slot_bytes)
        res.task_q = ctx.Queue()
        res.result_q = ctx.Queue()
        shm_name = res.shm.name if res.shm is not None else None
        import warnings
        with warnings.catch_warnings():
            # CPython warns on fork under threads because the child
            # could deadlock in an inherited lock; these workers run
            # only numpy and the dataset and take no parent lock before
            # entering their loop (PyTorch's DataLoader contract)
            warnings.filterwarnings(
                "ignore", message=".*os.fork.*", category=RuntimeWarning)
            warnings.filterwarnings(
                "ignore", message=".*fork.*multithreaded.*",
                category=DeprecationWarning)
            for _ in range(self._n_processes):
                p = ctx.Process(
                    target=_worker_loop,
                    args=(self.dataset, shm_name, self._layout,
                          res.task_q, res.result_q),
                    daemon=True)
                p.start()
                res.procs.append(p)
        self._res = res
        # GC-time teardown must not keep the iterator alive
        self._gc_guard = weakref.finalize(self, res.close)

        self._free_slots = list(range(self._n_slots))
        self._pending = {}        # seq -> completed-but-undelivered result
        self._seq_epoch = {}      # seq -> epoch the batch was scheduled in
        self._undelivered = set()
        self._seq_submitted = 0
        self._seq_delivered = 0
        self._exhausted = False
        self._broken = None       # sticky pipeline error
        self._finalized = False
        self.epoch = self._state.epoch
        self.is_new_epoch = self._state.is_new_epoch
        self._submit_tasks()

    def _submit_tasks(self):
        while self._free_slots and not self._exhausted:
            sched_epoch = self._sched.epoch  # epoch the batch STARTS in
            try:
                indices = self._sched._next_indices()
            except StopIteration:
                self._exhausted = True
                return
            slot = self._free_slots.pop()
            self._res.task_q.put(
                (self._seq_submitted, slot,
                 np.asarray(indices, dtype=np.int64)))
            self._seq_epoch[self._seq_submitted] = sched_epoch
            self._undelivered.add(self._seq_submitted)
            self._seq_submitted += 1

    def _check_workers_alive(self):
        for p in self._res.procs:
            if not p.is_alive():
                self._broken = IteratorWorkerCrashed(p.pid, p.exitcode)
                raise self._broken

    def _take_result(self):
        """Next deliverable result: the exact next seq when ordered; any
        completed batch of the OLDEST undelivered epoch when unordered
        (the scheduler runs ahead across epoch boundaries, but epochs
        must still deliver in order or the per-epoch example multiset
        breaks).  Polls worker liveness while waiting so a crashed pool
        raises instead of hanging."""
        import time
        deadline = time.monotonic() + self._worker_timeout
        while True:
            if self._ordered:
                want = self._seq_delivered
                if want in self._pending:
                    self._undelivered.discard(want)
                    self._seq_epoch.pop(want, None)
                    return self._pending.pop(want)
            elif self._pending:
                gate = self._seq_epoch[min(self._undelivered)]
                for seq in self._pending:
                    if self._seq_epoch[seq] == gate:
                        self._undelivered.discard(seq)
                        self._seq_epoch.pop(seq, None)
                        return self._pending.pop(seq)
            try:
                seq, slot, kind, payload = \
                    self._res.result_q.get(timeout=0.05)
            except _queue_mod.Empty:
                self._check_workers_alive()
                if time.monotonic() > deadline:
                    self._broken = IteratorError(
                        f"no batch completed within worker_timeout="
                        f"{self._worker_timeout}s (workers alive but "
                        "not progressing)")
                    raise self._broken
                continue
            # progress: ANY completed batch resets the no-progress
            # deadline — a single legitimately slow batch must not
            # break a pipeline whose other workers keep delivering
            deadline = time.monotonic() + self._worker_timeout
            self._pending[seq] = (slot, kind, payload)

    def _materialize(self, slot, kind, payload):
        """Copy the batch out of its ring slot (one memcpy per field),
        free the slot, and shape the output per ``as_arrays``."""
        if kind == "error":
            self._free_slots.append(slot)
            exc_type, message, tb_text = payload
            self._broken = IteratorWorkerError(exc_type, message, tb_text)
            raise self._broken
        if kind == "shm":
            n = payload
            views = self._layout.field_views(
                self._res.shm.buf, slot * self._layout.slot_bytes)
            arrays = [np.array(v[:n]) for v in views]  # memcpy out
            self._free_slots.append(slot)
            if self._as_arrays:
                return tuple(arrays) if self._layout.tuple_mode \
                    else arrays[0]
            if self._layout.tuple_mode:
                return [tuple(a[j] for a in arrays) for j in range(n)]
            return [arrays[0][j] for j in range(n)]
        # pickle fallback: payload IS the example list
        self._free_slots.append(slot)
        if not self._as_arrays:
            return payload
        first = payload[0]
        if isinstance(first, (tuple, list)):
            return tuple(np.stack([np.asarray(ex[k]) for ex in payload])
                         for k in range(len(first)))
        return np.stack([np.asarray(ex) for ex in payload])

    # -- iterator protocol --------------------------------------------------
    def __next__(self):
        if self._finalized:
            raise RuntimeError("MultiprocessIterator is finalized")
        if self._broken is not None:
            raise self._broken
        if self._exhausted and self._seq_delivered >= self._seq_submitted:
            raise StopIteration
        slot, kind, payload = self._take_result()
        batch = self._materialize(slot, kind, payload)
        self._seq_delivered += 1
        self._submit_tasks()
        # consumer shadow advances in lock-step (index bookkeeping only)
        self._state._next_indices()
        self.epoch = self._state.epoch
        self.is_new_epoch = self._state.is_new_epoch
        return batch

    next = __next__

    @property
    def epoch_detail(self):
        return self._state.epoch_detail

    @property
    def previous_epoch_detail(self):
        return self._state.previous_epoch_detail

    def reset(self):
        """Tear the pool down and restart from a fresh epoch."""
        self.finalize()
        self._setup()

    def serialize(self, serializer):
        """Consumer-granularity snapshot (reference contract; same keys
        as `SerialIterator`/`MultithreadIterator`, so snapshots are
        interchangeable across iterator classes).  On load the pool is
        rebuilt from the restored position.

        ``ordered=False`` refuses to WRITE a mid-stream snapshot: the
        consumer shadow tracks schedule order, but unordered delivery
        hands out an arbitrary completion-ordered subset — a resumed
        stream would duplicate the batches delivered out of schedule
        order and permanently drop the ones skipped.  Failing loudly
        beats silently corrupting the epoch multiset; reading INTO an
        unordered iterator is fine (scheduling restarts at the restored
        position)."""
        if serializer.is_writer and not self._ordered \
                and self._seq_delivered:
            raise RuntimeError(
                "MultiprocessIterator(ordered=False) cannot snapshot "
                "a mid-stream position: completion-order delivery "
                "diverges from the schedule-order shadow, so resume "
                "would duplicate/drop examples.  Use ordered=True "
                "for checkpointed training")
        _serialize_consumer_shadow(self, serializer)

    def finalize(self):
        """Stop workers, release queues and the shared-memory ring.
        Idempotent — double-finalize (trainer teardown after an explicit
        close) is a no-op."""
        if self._finalized or self._res is None:
            return
        self._finalized = True
        self._gc_guard.detach()
        self._res.close()
