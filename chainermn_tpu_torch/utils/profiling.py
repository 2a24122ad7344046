"""Profiling helpers: the port of ``chainermn_tpu.utils.profiling``.

The JAX package wraps ``jax.profiler``; the port wraps
``torch.profiler`` in the same vocabulary: :func:`trace` captures a
window and exports it as a Chrome trace (Perfetto, ``chrome://tracing``),
:func:`annotate` names a range in it (``record_function``),
:class:`Profile` is a trainer extension that captures a window of
iterations mid-run, and :func:`device_ops_in_ranges` reads from a capture
which kernels and copies ran inside which named ranges, and on which
streams.
"""

from __future__ import annotations

import contextlib
import os
import warnings

import torch
import torch.profiler

from ..training.trainer import Extension

__all__ = ["trace", "annotate", "Profile", "device_ops_in_ranges"]

#: the file a capture is exported to, inside its ``log_dir``
TRACE_FILE = "trace.json"


def _profiler():
    """A ``torch.profiler.profile`` over the host and, where there is a
    card, the device."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def _export(prof, log_dir):
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def trace(log_dir="result/trace"):
    """Capture a ``torch.profiler`` trace of the block, written to
    ``<log_dir>/trace.json`` when it ends."""
    prof = _profiler()
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        _export(prof, log_dir)


def annotate(name):
    """A named range in profiler timelines (``record_function``; the JAX
    package's ``jax.named_scope``)."""
    return torch.profiler.record_function(name)


#: the trace categories of work on the card, and of its launches
_DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCHES = ("cuda_runtime", "cuda_driver")


def device_ops_in_ranges(events, prefix):
    """The work on the card that a ``torch.profiler`` Chrome trace
    (``traceEvents``) shows launched inside the ranges whose names start
    with ``prefix`` (``annotate``, or the span names under
    ``CHAINERMN_TPU_TRACE=full``): ``[(range name, device op event)]``.
    A kernel, copy or set is joined to its launch on the host by the
    ``correlation`` id and attributed to the innermost such range around
    the launch on that thread; ``op["args"]["stream"]`` is the stream it
    ran on."""
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation" \
                and str(e.get("name", "")).startswith(prefix):
            ranges.setdefault((e["pid"], e["tid"]), []).append(e)
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in _LAUNCHES
                and "correlation" in e.get("args", {})}
    out = []
    for op in events:
        if op.get("cat") not in _DEVICE_OPS:
            continue
        launch = launches.get(op.get("args", {}).get("correlation"))
        if launch is None:
            continue
        inside = [r for r in ranges.get((launch["pid"], launch["tid"]), ())
                  if r["ts"] <= launch["ts"] <= r["ts"] + r.get("dur", 0)]
        if inside:
            out.append((max(inside, key=lambda r: r["ts"])["name"], op))
    return out


class Profile(Extension):
    """Trainer extension: trace iterations ``[start, start + n_steps)``
    into ``<log_dir or out/trace>/trace.json``.

    Leak contract (the JAX extension's): a run that ends, or raises,
    inside the window still stops the profiler.  ``on_error`` stops it at
    the failure; ``finalize`` (which ``Trainer.run`` calls for every
    extension, each in its own ``try``) stops it on any exit; ``_stop``
    is idempotent and turns the profiler's own failure into a warning,
    so that it never masks the run's exception."""

    trigger = (1, "iteration")
    priority = 400  # before anything else each iteration

    def __init__(self, start=10, n_steps=3, log_dir=None):
        self.start = start
        self.n_steps = n_steps
        self.log_dir = log_dir
        self._active = False
        self._prof = None
        self._dir = None

    def __call__(self, trainer):
        it = trainer.updater.iteration
        if not self._active and it == self.start:
            self._dir = self.log_dir or os.path.join(trainer.out, "trace")
            self._prof = _profiler()
            self._prof.start()
            self._active = True
        elif self._active and it >= self.start + self.n_steps:
            self._stop()

    def _stop(self):
        if not self._active:
            return
        self._active = False   # first: a failing stop must not re-fire
        prof, self._prof = self._prof, None
        try:
            prof.stop()
            _export(prof, self._dir)
        except Exception as e:  # noqa: BLE001 (never mask the caller)
            warnings.warn(f"torch.profiler failed while closing a Profile "
                          f"window: {e}", stacklevel=2)

    def on_error(self, trainer, exc, tb):
        self._stop()

    def finalize(self):
        self._stop()
