"""Standard trainer extensions (consumed-Chainer surface).

The port of ``chainermn_tpu.training.extensions`` (reference: ``chainer/
training/extensions/ · LogReport, PrintReport, ProgressBar, snapshot,
Evaluator, ExponentialShift, LinearShift``).  Their serialized keys, the
``log`` file and the snapshot file names are the JAX package's, so a
trainer snapshot moves between the two packages.

``Evaluator`` runs the reference's eager loop, under ``torch.no_grad()``
and ``using_config("train", False)``, and records per key the number of
examples its means cover (``_mn_counts``), which the multi-node evaluator
weights by.  Reported values stay tensors until a mean is taken, so the
training loop syncs with the card once per ``LogReport`` interval.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import tempfile

import numpy as np
import torch

from ..core import reporter as reporter_module
from ..core.config import using_config
from ..dataset.convert import concat_examples
from ..serializers.npz import save_npz
from .trainer import PRIORITY_WRITER, Extension
from .triggers import get_trigger

__all__ = ["LogReport", "PrintReport", "ProgressBar", "snapshot",
           "snapshot_object", "make_snapshot_extension", "Evaluator",
           "ExponentialShift", "LinearShift", "observe_lr",
           "make_observe_extension", "FailOnNonNumber",
           "ParameterStatistics"]


def _write_atomic(out, name, write):
    """``write(path)`` to a temporary file in ``out``, then renamed to
    ``name`` there (a reader never sees a half-written file)."""
    fd, tmp = tempfile.mkstemp(prefix=name, dir=out)
    os.close(fd)
    try:
        write(tmp)
    except Exception:
        os.remove(tmp)
        raise
    os.replace(tmp, os.path.join(out, name))


class LogReport(Extension):
    """Means of the observations over each ``trigger`` interval, kept in
    :attr:`log` and written as JSON to ``<out>/<log_name>``."""

    priority = PRIORITY_WRITER  # must see raw observations before readers

    def __init__(self, keys=None, trigger=(1, "epoch"), postprocess=None,
                 log_name="log"):
        self._keys = keys
        self._trigger = get_trigger(trigger)
        self.trigger = (1, "iteration")
        self._postprocess = postprocess
        self._log_name = log_name
        self._log = []
        self._summary = reporter_module.DictSummary()

    @property
    def log(self):
        return self._log

    def __call__(self, trainer):
        obs = trainer.observation
        if self._keys is None:
            self._summary.add(obs)
        else:
            self._summary.add({k: obs[k] for k in self._keys if k in obs})
        if not self._trigger(trainer):
            return
        entry = {k: float(v) for k, v in self._summary.compute_mean().items()}
        entry["epoch"] = trainer.updater.epoch
        entry["iteration"] = trainer.updater.iteration
        entry["elapsed_time"] = trainer.elapsed_time
        if self._postprocess is not None:
            self._postprocess(entry)
        self._log.append(entry)
        if self._log_name is not None:
            def write(path):
                with open(path, "w") as f:
                    json.dump(self._log, f, indent=4)
            _write_atomic(trainer.out, self._log_name, write)
        self._summary = reporter_module.DictSummary()

    def serialize(self, serializer):
        if hasattr(self._trigger, "serialize"):
            self._trigger.serialize(serializer["_trigger"])
        # the entries so far, so that a resumed run appends to them
        if serializer.is_writer:
            serializer("log_json", np.frombuffer(
                json.dumps(self._log).encode(), dtype=np.uint8))
            return
        try:
            data = serializer("log_json", None)
        except KeyError:
            data = None
        if data is not None and np.asarray(data).size:
            self._log = json.loads(
                np.asarray(data, dtype=np.uint8).tobytes().decode())


class PrintReport(Extension):
    """Prints the chosen entries of each new ``LogReport`` entry as a
    table row."""

    def __init__(self, entries, log_report="LogReport", out=sys.stdout):
        self._entries = entries
        self._log_report = log_report
        self._out = out
        self._log_len = 0
        self._header = "  ".join(f"{e:13}" for e in entries) + "\n"

    def __call__(self, trainer):
        if self._header:
            self._out.write(self._header)
            self._header = None
        log_report = self._log_report
        if isinstance(log_report, str):
            log_report = trainer.get_extension(log_report)
        log = log_report.log
        while len(log) > self._log_len:
            entry = log[self._log_len]
            cells = []
            for key in self._entries:
                value = entry.get(key)
                if value is None:
                    cells.append(" " * 13)
                elif isinstance(value, float):
                    cells.append(f"{value:<13.6g}")
                else:
                    cells.append(f"{value:<13}")
            self._out.write("  ".join(cells) + "\n")
            self._log_len += 1
        self._out.flush()


class ProgressBar(Extension):
    def __init__(self, training_length=None, update_interval=100,
                 bar_length=50, out=sys.stdout):
        self._training_length = training_length
        self._update_interval = update_interval
        self._bar_length = bar_length
        self._out = out

    def __call__(self, trainer):
        iteration = trainer.updater.iteration
        if iteration % self._update_interval:
            return
        length = self._training_length
        if length is None:
            t = trainer.stop_trigger
            if hasattr(t, "period"):
                length = (t.period, t.unit)
        if length is None:
            return
        period, unit = length
        if unit == "iteration":
            rate = iteration / period
        else:
            rate = trainer.updater.epoch_detail / period
        rate = min(rate, 1.0)
        marks = "#" * int(rate * self._bar_length)
        self._out.write(f"\r[{marks:{self._bar_length}}] {rate:6.2%}")
        if rate >= 1.0:
            self._out.write("\n")
        self._out.flush()


def make_snapshot_extension(fn):
    fn.trigger = (1, "epoch")
    fn.priority = -100
    return fn


def snapshot(savefun=save_npz, filename="snapshot_iter_{.updater.iteration}"):
    """The trainer's state written to ``<out>/<filename>`` (formatted
    with the trainer), by default each epoch."""

    @make_snapshot_extension
    def _snapshot(trainer):
        _write_atomic(trainer.out, filename.format(trainer),
                      lambda path: savefun(path, trainer))

    return _snapshot


def snapshot_object(target, filename, savefun=save_npz):
    """``target``'s state written to ``<out>/<filename>``."""

    @make_snapshot_extension
    def _snapshot_object(trainer):
        _write_atomic(trainer.out, filename.format(trainer),
                      lambda path: savefun(path, target))

    return _snapshot_object


class Evaluator(Extension):
    """Validation loop (reference: ``extensions.Evaluator``): the means
    of what the target reports over the iterator's batches, reported
    under ``<name>/main/...``.  ``evaluate()`` is what
    ``create_multi_node_evaluator`` wraps."""

    trigger = (1, "epoch")
    priority = PRIORITY_WRITER
    default_name = "validation"

    def __init__(self, iterator, target, converter=concat_examples,
                 device=None, eval_hook=None, eval_func=None):
        if not isinstance(iterator, dict):
            iterator = {"main": iterator}
        self._iterators = iterator
        if isinstance(target, torch.nn.Module):
            target = {"main": target}
        self._targets = target
        self.converter = converter
        self.device = device
        self.eval_hook = eval_hook
        self.eval_func = eval_func
        self.name = None

    def get_iterator(self, name="main"):
        return self._iterators[name]

    def get_target(self, name="main"):
        return self._targets[name]

    def __call__(self, trainer=None):
        reporter = reporter_module.Reporter()
        prefix = (self.name or self.default_name) + "/"
        for name, target in self._targets.items():
            reporter.add_observer(prefix + name, target)
            reporter.add_observers(prefix + name,
                                   target.namedlinks(skipself=True))
        with reporter:
            result = self.evaluate()
        reporter_module.report(result)
        return result

    def _device(self):
        if self.device is not None:
            return self.device
        return next(self._targets["main"].parameters()).device

    def evaluate(self):
        iterator = self._iterators["main"]
        eval_func = self.eval_func or self._targets["main"]
        if self.eval_hook:
            self.eval_hook(self)
        if hasattr(iterator, "reset"):
            iterator.reset()
            it = iterator
        else:
            it = copy.copy(iterator)
        summary = reporter_module.DictSummary()
        # per-key numbers of EXAMPLES (not batches): the multi-node
        # wrapper weights each rank's means by them, so a ragged last
        # batch counts by its size
        counts = {}
        device = self._device()
        with torch.no_grad(), using_config("train", False):
            for batch in it:
                in_arrays = self.converter(batch, device)
                observation = {}
                with reporter_module.report_scope(observation):
                    if isinstance(in_arrays, tuple):
                        eval_func(*in_arrays)
                    elif isinstance(in_arrays, dict):
                        eval_func(**in_arrays)
                    else:
                        eval_func(in_arrays)
                summary.add(observation)
                n = len(batch) if hasattr(batch, "__len__") else 1
                for k in observation:
                    counts[k] = counts.get(k, 0) + n
        self._mn_counts = counts
        return summary.compute_mean()


class ExponentialShift(Extension):
    """Multiply an optimizer attribute by ``rate`` on each trigger."""

    trigger = (1, "epoch")

    def __init__(self, attr, rate, init=None, target=None, optimizer=None):
        self._attr = attr
        self._rate = rate
        self._init = init
        self._target = target
        self._optimizer = optimizer
        self._t = 0

    def _get_optimizer(self, trainer):
        return self._optimizer or trainer.updater.get_optimizer("main")

    def initialize(self, trainer):
        optimizer = self._get_optimizer(trainer)
        if self._init is None:
            self._init = getattr(optimizer, self._attr)
        setattr(optimizer, self._attr, self._init * (self._rate ** self._t))

    def __call__(self, trainer):
        self._t += 1
        value = self._init * (self._rate ** self._t)
        if self._target is not None:
            if (self._rate < 1 and value < self._target) or \
               (self._rate > 1 and value > self._target):
                value = self._target
        setattr(self._get_optimizer(trainer), self._attr, value)

    def serialize(self, serializer):
        self._t = int(serializer("t", self._t))


class LinearShift(Extension):
    """Move an optimizer attribute linearly from ``value_range[0]`` to
    ``value_range[1]`` over ``time_range`` iterations."""

    trigger = (1, "iteration")

    def __init__(self, attr, value_range, time_range, optimizer=None):
        self._attr = attr
        self._value_range = value_range
        self._time_range = time_range
        self._optimizer = optimizer
        self._t = 0

    def __call__(self, trainer):
        optimizer = self._optimizer or trainer.updater.get_optimizer("main")
        t1, t2 = self._time_range
        v1, v2 = self._value_range
        if self._t <= t1:
            value = v1
        elif self._t >= t2:
            value = v2
        else:
            value = v1 + (v2 - v1) * (self._t - t1) / (t2 - t1)
        setattr(optimizer, self._attr, value)
        self._t += 1

    def serialize(self, serializer):
        self._t = int(serializer("t", self._t))


def make_observe_extension(fn):
    fn.trigger = (1, "iteration")
    fn.priority = PRIORITY_WRITER
    return fn


def observe_lr(optimizer_name="main", observation_key="lr"):
    """Report the optimizer's ``lr`` each iteration."""

    @make_observe_extension
    def _observe_lr(trainer):
        optimizer = trainer.updater.get_optimizer(optimizer_name)
        reporter_module.report({observation_key: getattr(optimizer, "lr")})

    return _observe_lr


class FailOnNonNumber(Extension):
    """Abort training when any model parameter becomes NaN or Inf (one
    sync with the card per trigger)."""

    trigger = (1, "iteration")

    def __call__(self, trainer):
        for optimizer in trainer.updater.get_all_optimizers().values():
            params = list(optimizer.target.params())
            finite = torch.stack([torch.isfinite(p).all() for p in params])
            if not bool(finite.all()):
                raise RuntimeError(
                    "Kill the process since parameters contain NaN/Inf")


class ParameterStatistics(Extension):
    """Report per-parameter statistics of the data and the gradients
    under ``<prefix>/<link>/<path>/<data|grad>/<statistic>`` (reference:
    ``extensions.ParameterStatistics``).  The default statistics are
    the mean, the standard deviation (of the population, as
    ``jnp.std``), the minimum and the maximum."""

    trigger = (1, "epoch")
    priority = PRIORITY_WRITER
    default_statistics = {
        "mean": lambda x: x.mean(),
        "std": lambda x: x.std(correction=0),
        "min": lambda x: x.min(),
        "max": lambda x: x.max(),
    }

    def __init__(self, links, statistics=None, report_params=True,
                 report_grads=True, prefix=None):
        if isinstance(links, torch.nn.Module):
            links = [links]
        self._links = links
        self._statistics = statistics or dict(self.default_statistics)
        self._report_params = report_params
        self._report_grads = report_grads
        self._prefix = prefix

    def __call__(self, trainer=None):
        observation = {}
        base = self._prefix + "/" if self._prefix else ""
        with torch.no_grad():
            for i, link in enumerate(self._links):
                name = getattr(link, "name", None) or str(i)
                for path, p in link.namedparams():
                    key = f"{base}{name}{path}"
                    for kind, x in (("data", p if self._report_params
                                     else None),
                                    ("grad", p.grad if self._report_grads
                                     else None)):
                        if x is None:
                            continue
                        for sname, fn in self._statistics.items():
                            observation[f"{key}/{kind}/{sname}"] = fn(x)
        reporter_module.report(observation)
        return observation
