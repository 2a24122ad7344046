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
#: the host event around each node that autograd's engine runs; it
#: carries the sequence number of the forward op that made the node
BACKWARD_NODE = "autograd::engine::evaluate_function"
#: the ranges that a backward kernel also counts toward through its
#: forward op (the model's layer ranges, ``observability.scope``)
LAYER_PREFIX = "model."


def _from_chrome(events):
    """A Chrome trace's events (``traceEvents``) as ``(host, ops)``:
    ``host`` the annotations, backward nodes and forward ops, each
    ``(thread, start, end, name, kind, seq, forward thread)``; ``ops``
    each ``(op, launching thread, launch time)``.  Times in the trace's
    microseconds.  The trace names a thread by its system id and a
    backward node's forward thread by the profiler's own, so a node's
    forward op is found by its sequence number alone."""
    host, launches, device = [], {}, []
    for e in events:
        cat = e.get("cat")
        args = e.get("args") or {}
        if cat in _DEVICE_OPS:
            device.append(e)
        elif cat in _LAUNCHES and "correlation" in args:
            launches[args["correlation"]] = e
        elif cat == "user_annotation" or cat == "cpu_op":
            start = e["ts"]
            row = ((e["pid"], e["tid"]), start, start + e.get("dur", 0),
                   e["name"])
            seq = args.get("Sequence number", -1)
            if cat == "user_annotation":
                host.append(row + ("range", -1, None))
            elif e["name"].startswith(BACKWARD_NODE):
                host.append(row + ("node", seq, None))
            elif seq >= 0 and not args.get("Fwd thread id"):
                host.append(row + ("forward", seq, None))
    ops = []
    for op in device:
        launch = launches.get((op.get("args") or {}).get("correlation"))
        if launch is not None:
            ops.append((op, (launch["pid"], launch["tid"]), launch["ts"]))
    return host, ops


def _from_kineto(events):
    """``torch.profiler``'s raw events (``prof.profiler.kineto_results.
    events()``) as :func:`_from_chrome`'s ``(host, ops)``, in ns.  A
    kernel's launch is the host event with the kernel's correlation id
    and its ``linked_correlation_id`` (the innermost host range open at
    the launch); host ranges and ops link to none.  A device op linked to
    none was launched outside every range, and is left out.  (The order
    of the tests keeps the calls into the profiler's events few: they
    cost most of the join.)"""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    host, launches, device = [], {}, []
    for e in events:
        linked = e.linked_correlation_id()
        if linked:
            if e.device_type() == cuda:
                device.append(e)
            else:
                launches[(e.correlation_id(), linked)] = e
            continue
        if e.is_user_annotation():
            if e.device_type() == cuda:   # the device lane's copy
                continue
            kind, seq, fwd = "range", -1, None
        else:
            seq = e.sequence_nr()
            if seq < 0:
                continue
            fwd = e.fwd_thread_id() or None
            if e.name().startswith(BACKWARD_NODE):
                kind = "node"
            elif fwd is None:
                kind = "forward"
            else:
                continue
        host.append((e.start_thread_id(), e.start_ns(), e.end_ns(),
                     e.name(), kind, seq, fwd))
    ops = []
    for op in device:
        launch = launches.get((op.correlation_id(),
                               op.linked_correlation_id()))
        if launch is not None:
            ops.append((op, launch.start_thread_id(), launch.start_ns()))
    return host, ops


def _open_at(intervals, queries):
    """For each query ``(thread, time, key)``: the host intervals open at
    ``time`` on ``thread``, outermost first, as ``{key: [interval]}``.
    One sorted sweep a thread; an interval is ``(thread, start, end,
    ...)``."""
    by_thread = {}
    for iv in intervals:
        by_thread.setdefault(iv[0], []).append(iv)
    asked = {}
    for thread, t, key in queries:
        asked.setdefault(thread, []).append((t, key))
    out = {}
    for thread, points in asked.items():
        ivs = sorted(by_thread.get(thread, ()),
                     key=lambda iv: (iv[1], -iv[2]))
        stack, i = [], 0
        for t, key in sorted(points, key=lambda p: p[0]):
            while i < len(ivs) and ivs[i][1] <= t:
                while stack and stack[-1][2] < ivs[i][1]:
                    stack.pop()
                stack.append(ivs[i])
                i += 1
            while stack and stack[-1][2] < t:
                stack.pop()
            out[key] = [iv for iv in stack if iv[2] >= t]
    return out


def device_ops_in_ranges(events, prefix):
    """The work on the card that a ``torch.profiler`` capture shows
    launched inside the ranges whose names start with ``prefix`` (a
    string or a tuple of them; ``annotate``, ``observability.scope``, or
    the span names under ``CHAINERMN_TPU_TRACE=full``):
    ``[(range name, device op)]``, one pair for each range name around
    the op.  ``events`` is the capture's Chrome trace (``traceEvents``)
    or its raw events (``prof.profiler.kineto_results.events()``); the
    ops are of the same kind.

    A kernel, copy or set is joined to its launch on the host by its
    correlation id, and counts toward every range open at the launch on
    the launching thread, nested ones each.  One launched by autograd's
    backward thread also counts toward the ranges open at that moment on
    the thread that called backward (so the backward's kernels count in
    ``train.backward``), and toward the layer ranges (``model.*``) around
    the forward op whose node it ran: the ``autograd::engine::
    evaluate_function`` event around the launch carries that op's
    sequence number.  ``op["args"]["stream"]`` (Chrome) or
    ``op.device_resource_id()`` (raw) is the stream it ran on."""
    chrome = isinstance(events, list) and (not events
                                           or isinstance(events[0], dict))
    host, ops = (_from_chrome if chrome else _from_kineto)(events)
    intervals = [h for h in host if h[4] != "forward"]
    queries = [(thread, t, i) for i, (_, thread, t) in enumerate(ops)]
    queries += [(h[0], h[1], ("fwd", j)) for j, h in enumerate(host)
                if h[4] == "forward"]
    opened = _open_at(intervals, queries)
    # (forward thread, sequence number) -> (thread, layer ranges); the
    # Chrome trace cannot name the forward thread (see _from_chrome)
    forward = {}
    for j, h in enumerate(host):
        if h[4] == "forward":
            forward[(None if chrome else h[0], h[5])] = (h[0], [
                iv[3] for iv in opened[("fwd", j)] if iv[4] == "range"
                and iv[3].startswith(LAYER_PREFIX)])
    names, callers = [], []
    for i, (_, thread, t) in enumerate(ops):
        around = opened.get(i, [])
        names.append([iv[3] for iv in around if iv[4] == "range"])
        nodes = [iv for iv in around if iv[4] == "node"]
        if not nodes:
            continue
        node = nodes[-1]
        caller, layers = forward.get((node[6], node[5]), (node[6], []))
        names[i] += layers
        if caller is not None and caller != thread:
            callers.append((caller, t, i))
    for i, around in _open_at(intervals, callers).items():
        names[i] += [iv[3] for iv in around if iv[4] == "range"]
    out = []
    for (op, _, _), found in zip(ops, names):
        seen = set()
        for name in found:
            if name.startswith(prefix) and name not in seen:
                seen.add(name)
                out.append((name, op))
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
