"""Observation reporting (consumed-Chainer surface: ``chainer.Reporter``).

The port of ``chainermn_tpu.core.reporter`` (pure host code, copied).
Reported values may be 0-d tensors on the card: they are kept as tensors
in the observation, and ``Summary`` / ``DictSummary`` convert them only
when a statistic is computed, so a ``report`` in the training step never
forces a device sync.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

__all__ = ["Reporter", "report", "report_scope", "get_current_reporter",
           "Summary", "DictSummary"]

_thread_local = threading.local()


def _reporter_stack():
    if not hasattr(_thread_local, "stack"):
        _thread_local.stack = []
    return _thread_local.stack


class Reporter:
    """Collects named observations from registered observers."""

    def __init__(self):
        self._observer_names = {}
        self.observation = {}

    def add_observer(self, name, observer):
        self._observer_names[id(observer)] = name

    def add_observers(self, prefix, observers):
        for name, observer in observers:
            self._observer_names[id(observer)] = prefix + name

    @contextlib.contextmanager
    def scope(self, observation):
        stack = _reporter_stack()
        stack.append(self)
        old = self.observation
        self.observation = observation
        try:
            yield
        finally:
            self.observation = old
            stack.pop()

    def __enter__(self):
        _reporter_stack().append(self)
        return self

    def __exit__(self, *exc):
        _reporter_stack().pop()

    def report(self, values, observer=None):
        if observer is not None:
            observer_name = self._observer_names.get(id(observer))
            if observer_name is None:
                raise KeyError("observer is not registered: %r" % observer)
            for key, value in values.items():
                self.observation[f"{observer_name}/{key}"] = value
        else:
            self.observation.update(values)


def get_current_reporter() -> Reporter:
    stack = _reporter_stack()
    if not stack:
        stack.append(Reporter())
    return stack[-1]


def report(values, observer=None):
    stack = _reporter_stack()
    if stack:
        stack[-1].report(values, observer)


@contextlib.contextmanager
def report_scope(observation):
    with get_current_reporter().scope(observation):
        yield


def _to_host(value):
    """A reported value as a numpy array (a tensor is detached and
    copied from the card here, when a statistic needs it)."""
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()
    return np.asarray(value)


class Summary:
    """Online mean/std accumulator (reference: ``chainer.reporter.Summary``)."""

    def __init__(self):
        self._x = 0.0
        self._x2 = 0.0
        self._n = 0.0

    def add(self, value, weight=1.0):
        value = float(_to_host(value))
        self._x += weight * value
        self._x2 += weight * value * value
        self._n += weight

    def compute_mean(self):
        return self._x / self._n

    def make_statistics(self):
        mean = self._x / self._n
        var = self._x2 / self._n - mean * mean
        return mean, float(np.sqrt(max(var, 0.0)))

    def serialize(self, serializer):
        self._x = float(serializer("x", self._x))
        self._x2 = float(serializer("x2", self._x2))
        self._n = float(serializer("n", self._n))


class DictSummary:
    """Per-key ``Summary`` over observation dicts.  Values stay as they
    were reported until :meth:`compute_mean` reads them."""

    def __init__(self):
        self._pending = {}

    def add(self, d):
        for key, value in d.items():
            if isinstance(value, torch.Tensor):
                if value.numel() != 1:
                    continue
            else:
                try:
                    if np.asarray(value).size != 1:
                        continue
                except (TypeError, ValueError):
                    continue
            self._pending.setdefault(key, []).append(value)

    def compute_mean(self):
        means = {}
        for key, values in self._pending.items():
            s = Summary()
            for value in values:
                s.add(value)
            means[key] = s.compute_mean()
        return means
