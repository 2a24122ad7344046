"""Trainer loop (consumed-Chainer surface: ``chainer.training.Trainer``).

The port of ``chainermn_tpu.training.trainer``: runs the updater until
``stop_trigger`` fires, each iteration inside a fresh ``Reporter``
observation scope in which the optimizer targets are registered as
``main`` (so the model's ``report({"loss": ...}, self)`` lands as
``main/loss``), then calls the registered extensions by priority: each
extension's ``initialize(trainer)`` once before the first iteration
(and so again in a trainer that resumes from a snapshot), its
``finalize()`` once at the end, each in its own ``try`` (the first
failure is raised after every finalizer and the updater's have run,
unless the loop is already raising).  With tracing on
(``CHAINERMN_TPU_TRACE``) a run leaves its rank's Chrome-trace shard,
``trace-rank{r}.jsonl``, in ``out``.

``run`` is also the supervisor of the JAX trainer: when an extension can
recover (``can_recover`` and ``recover``, i.e.
:class:`~..extensions.FailureRecovery` or its elastic subclass) and the
exception escaping the loop is one it can recover, every extension's
``on_error`` fires, the extension recovers (consensus resume, transport
quiesce, an optional rebuild) and the loop is entered again; any other
failure fires ``on_error`` and is raised.
"""

from __future__ import annotations

import collections
import os
import sys
import time
import traceback

from .. import observability
from ..core import reporter as reporter_module
from .triggers import get_trigger

__all__ = ["Trainer", "Extension", "make_extension",
           "PRIORITY_WRITER", "PRIORITY_EDITOR", "PRIORITY_READER"]

PRIORITY_WRITER = 300
PRIORITY_EDITOR = 200
PRIORITY_READER = 100


class Extension:
    """Base extension (reference: ``chainer/training/extension.py``)."""

    trigger = (1, "iteration")
    priority = PRIORITY_READER
    name = None

    @property
    def default_name(self):
        return type(self).__name__

    def __call__(self, trainer):
        raise NotImplementedError

    def initialize(self, trainer):
        pass

    def finalize(self):
        pass

    def on_error(self, trainer, exc, tb):
        pass

    def serialize(self, serializer):
        pass


def make_extension(trigger=(1, "iteration"), default_name=None,
                   priority=PRIORITY_READER, initializer=None):
    """Decorator giving a function the extension attributes."""
    def decorator(ext):
        ext.trigger = trigger
        ext.default_name = default_name or getattr(ext, "__name__",
                                                   "extension")
        ext.priority = priority
        if initializer is not None:
            ext.initialize = initializer
        return ext
    return decorator


class _ExtensionEntry:
    def __init__(self, extension, name, trigger, priority,
                 call_before_training):
        self.extension = extension
        self.name = name
        self.trigger = get_trigger(trigger)
        self.priority = priority
        self.call_before_training = call_before_training


class Trainer:
    def __init__(self, updater, stop_trigger=None, out="result"):
        self.updater = updater
        # None: train until interrupted (reference semantics)
        self.stop_trigger = (get_trigger(stop_trigger)
                             or (lambda trainer: False))
        self.out = out
        self.observation = {}
        self.reporter = reporter_module.Reporter()
        for name, optimizer in updater.get_all_optimizers().items():
            self.reporter.add_observer(name, optimizer.target)
            self.reporter.add_observers(
                name, optimizer.target.namedlinks(skipself=True))
        self._extensions = collections.OrderedDict()
        self._start_at = None
        self._snapshot_elapsed_time = 0.0
        self._done = False
        updater.connect_trainer(self)

    @property
    def elapsed_time(self):
        """Seconds of training, those of the run a snapshot resumed
        included."""
        if self._start_at is None:
            return self._snapshot_elapsed_time
        return time.time() - self._start_at + self._snapshot_elapsed_time

    def extend(self, extension, name=None, trigger=None, priority=None,
               call_before_training=False):
        """Register ``extension(trainer)``, called after each update its
        trigger fires on (every iteration by default)."""
        if name is None:
            name = (getattr(extension, "name", None)
                    or getattr(extension, "default_name", None)
                    or getattr(extension, "__name__", None)
                    or type(extension).__name__)
        if trigger is None:
            trigger = getattr(extension, "trigger", (1, "iteration"))
        if priority is None:
            priority = getattr(extension, "priority", PRIORITY_READER)
        original, ordinal = name, 0
        while name in self._extensions:
            ordinal += 1
            name = f"{original}_{ordinal}"
        self._extensions[name] = _ExtensionEntry(
            extension, name, trigger, priority, call_before_training)

    def get_extension(self, name):
        return self._extensions[name].extension

    def _fire_on_error(self, extensions, exc):
        """Every extension's ``on_error``, each in its own ``try``: a
        failing handler is reported and must not mask the failure or stop
        the recovery."""
        for entry in extensions:
            on_error = getattr(entry.extension, "on_error", None)
            if on_error:
                try:
                    on_error(self, exc, exc.__traceback__)
                except Exception as handler_exc:
                    print(f"Exception in on_error of extension "
                          f"{entry.name}: {handler_exc}", file=sys.stderr)

    @staticmethod
    def _find_recovery(extensions):
        for entry in extensions:
            ext = entry.extension
            if hasattr(ext, "can_recover") and hasattr(ext, "recover"):
                return ext
        return None

    def run(self, show_loop_exception_msg=True):
        """Run the training loop until ``stop_trigger`` fires.  A failure
        is passed to every extension's ``on_error``; then, when a
        recovery extension can recover it, recovered and the loop entered
        again, else raised (after the message and traceback when
        ``show_loop_exception_msg``)."""
        if self._done:
            raise RuntimeError("cannot run training loop multiple times")
        os.makedirs(self.out, exist_ok=True)
        extensions = sorted(self._extensions.values(),
                            key=lambda e: -e.priority)
        self._start_at = time.time()
        for entry in extensions:
            initializer = getattr(entry.extension, "initialize", None)
            if initializer:
                initializer(self)
        for entry in extensions:
            if entry.call_before_training:
                entry.extension(self)
        recovery = self._find_recovery(extensions)
        try:
            while True:
                try:
                    while not self.stop_trigger(self):
                        self.observation = {}
                        with self.reporter.scope(self.observation):
                            self.updater.update()
                            for entry in extensions:
                                if entry.trigger is None \
                                        or entry.trigger(self):
                                    entry.extension(self)
                    break
                except Exception as e:
                    self._fire_on_error(extensions, e)
                    if recovery is not None and recovery.can_recover(e):
                        if show_loop_exception_msg:
                            print("Recoverable exception in main training "
                                  "loop:", e, file=sys.stderr)
                        recovery.recover(self, e)
                        continue
                    if show_loop_exception_msg:
                        print("Exception in main training loop:", e,
                              file=sys.stderr)
                        traceback.print_exc()
                    raise
        finally:
            self._finalize(extensions)

    def _finalize(self, extensions):
        """Every extension's ``finalize`` and the updater's, each in its
        own ``try``: one failing cleanup must not skip the others (the
        updater's stops the loader workers and the device-feed thread).
        The first failure is printed and raised after all of them have
        run, unless an exception is already unwinding from the loop,
        which wins.  Then the trace shard is written (tracing on), a
        failure to write it printed, never raised."""
        first = None
        cleanups = [(f"finalize of extension {entry.name}",
                     getattr(entry.extension, "finalize", None))
                    for entry in extensions]
        cleanups.append(("updater.finalize", self.updater.finalize))
        for what, finalize in cleanups:
            if finalize is None:
                continue
            try:
                finalize()
            except BaseException as e:  # noqa: BLE001 (re-raised below)
                print(f"Exception in {what}: {e}", file=sys.stderr)
                if first is None:
                    first = e
        self._done = True
        if observability.enabled():
            try:
                tr = observability.tracer()
                tr.export(os.path.join(self.out,
                                       f"trace-rank{tr.rank}.jsonl"))
            except Exception as e:  # noqa: BLE001 (never mask the run)
                print(f"trace export failed: {e}", file=sys.stderr)
        if first is not None and sys.exc_info()[0] is None:
            raise first

    def serialize(self, serializer):
        """The JAX trainer's keys: ``updater/...``, ``stop_trigger/...``,
        ``extensions/<name>/...``, ``extension_triggers/<name>/...`` and
        ``_snapshot_elapsed_time``."""
        self.updater.serialize(serializer["updater"])
        if hasattr(self.stop_trigger, "serialize"):
            self.stop_trigger.serialize(serializer["stop_trigger"])
        s = serializer["extensions"]
        t = serializer["extension_triggers"]
        for name, entry in self._extensions.items():
            if hasattr(entry.extension, "serialize"):
                entry.extension.serialize(s[name])
            if hasattr(entry.trigger, "serialize"):
                entry.trigger.serialize(t[name])
        if serializer.is_writer:
            serializer("_snapshot_elapsed_time", self.elapsed_time)
        else:
            self._snapshot_elapsed_time = float(
                serializer("_snapshot_elapsed_time", 0.0))
