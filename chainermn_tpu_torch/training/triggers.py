"""Triggers (consumed-Chainer surface: ``chainer.training.triggers``).

A copy of ``chainermn_tpu.training.triggers`` (pure host code).  A trigger
is a callable ``trigger(trainer) -> bool``.  A watched observation may be
a 0-d tensor on the card; it is read when the trigger looks at it.
"""

from __future__ import annotations

import numpy as np

from ..core.reporter import _to_host

__all__ = ["IntervalTrigger", "OnceTrigger", "MaxValueTrigger",
           "MinValueTrigger", "get_trigger"]


class IntervalTrigger:
    def __init__(self, period, unit):
        assert unit in ("iteration", "epoch")
        self.period = period
        self.unit = unit
        self._previous_iteration = 0
        self._previous_epoch_detail = 0.0

    def __call__(self, trainer):
        updater = trainer.updater
        if self.unit == "epoch":
            prev = self._previous_epoch_detail
            self._previous_epoch_detail = updater.epoch_detail
            return (prev // self.period) != (updater.epoch_detail // self.period)
        prev = self._previous_iteration
        self._previous_iteration = updater.iteration
        return (prev // self.period) != (updater.iteration // self.period)

    def serialize(self, serializer):
        self._previous_iteration = int(serializer(
            "previous_iteration", self._previous_iteration))
        self._previous_epoch_detail = float(serializer(
            "previous_epoch_detail", self._previous_epoch_detail))

    def __str__(self):
        return f"IntervalTrigger({self.period}, '{self.unit}')"


class OnceTrigger:
    def __init__(self, call_on_resume=False):
        self._flag_first = True
        self._flag_resumed = call_on_resume

    def __call__(self, trainer):
        fire = self._flag_first or self._flag_resumed
        self._flag_first = False
        self._flag_resumed = False
        return fire

    def serialize(self, serializer):
        # reference parity: a resumed OnceTrigger must not re-fire unless
        # constructed with call_on_resume (which stays untouched here)
        self._flag_first = bool(serializer("flag_first", self._flag_first))


class _BestValueTrigger:
    def __init__(self, key, compare, trigger=(1, "epoch")):
        self._key = key
        self._compare = compare
        self._interval = get_trigger(trigger)
        self._best = None
        self._summary = []

    def __call__(self, trainer):
        obs = trainer.observation
        if self._key in obs:
            self._summary.append(float(_to_host(obs[self._key])))
        if not self._interval(trainer) or not self._summary:
            return False
        value = float(np.mean(self._summary))
        self._summary = []
        if self._best is None or self._compare(self._best, value):
            self._best = value
            return True
        return False

    def serialize(self, serializer):
        """Best value + in-window summary + interval position: without
        these a resumed Max/MinValueTrigger forgets its best and re-fires
        on a WORSE value (e.g. re-saving a 'best' snapshot over a better
        model)."""
        if hasattr(self._interval, "serialize"):
            self._interval.serialize(serializer["interval"])
        if serializer.is_writer:
            # explicit has-best flag: NaN is a legitimate latched best
            # (a diverged metric window), not an "unset" sentinel
            serializer("has_best", self._best is not None)
            serializer("best", 0.0 if self._best is None else self._best)
            serializer("summary", np.asarray(self._summary, np.float64))
            return
        # defaults are the CURRENT field values (IntervalTrigger's
        # pattern): a non-strict load from a snapshot lacking these keys
        # leaves the live trigger untouched instead of wiping its best
        has_best = bool(serializer("has_best", self._best is not None))
        best = serializer("best",
                          0.0 if self._best is None else self._best)
        self._best = float(best) if has_best and best is not None else None
        summary = serializer("summary",
                             np.asarray(self._summary, np.float64))
        self._summary = [] if summary is None \
            else [float(v) for v in np.asarray(summary).ravel()]


class MaxValueTrigger(_BestValueTrigger):
    def __init__(self, key, trigger=(1, "epoch")):
        super().__init__(key, lambda best, new: new > best, trigger)


class MinValueTrigger(_BestValueTrigger):
    def __init__(self, key, trigger=(1, "epoch")):
        super().__init__(key, lambda best, new: new < best, trigger)


def get_trigger(trigger):
    if trigger is None:
        return None
    if callable(trigger):
        return trigger
    period, unit = trigger
    return IntervalTrigger(period, unit)
