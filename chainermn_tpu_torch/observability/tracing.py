"""Host-side structured span tracing.

The port of ``chainermn_tpu.observability.tracing`` (pure host code,
copied): the same span names, event schema and JSONL format, so that the
JAX package's ``tools/trace_merge.py`` merges the port's rank shards.

Design:

* a :class:`Span` is a named interval on a (pid, tid) track, recorded
  with ``time.monotonic()`` (never wall clock: NTP steps would break
  the balance invariant) into a BOUNDED ring buffer (old events fall
  off; a trainer cannot leak memory by tracing forever);
* export is Chrome-trace-event JSONL, one event object per line,
  ``B``/``E`` pairs per track plus ``i`` instants and ``M`` metadata,
  which Perfetto / ``chrome://tracing`` open directly;
* ``pid`` is the RANK (so a merged multi-rank trace shows one process
  lane per rank), ``tid`` is the host thread, or a synthetic
  per-request track for serving lifecycles;
* the knob ladder is ``CHAINERMN_TPU_TRACE=off|events|full``: ``off``
  (default) makes every call site a no-op returning a module-level
  singleton (zero allocations), ``events`` records host spans, ``full``
  additionally opens ``torch.profiler.record_function`` around each span
  (the name with ``/`` replaced by ``.``), so a ``torch.profiler``
  capture carries the SAME vocabulary (the JAX package opens
  ``jax.named_scope`` there).

Device twins (the port's own): a span opened with ``device=`` a CUDA
device, with tracing on, also records a timing CUDA event on that
device's current stream at enter and at exit.  The pairs are resolved
lazily (``Event.query()`` when a later device span opens; in full before
:meth:`SpanTracer.events` and :meth:`SpanTracer.export` return), so the
hot path never synchronizes; each becomes a ``<name>/device`` B/E pair
on a device track (one ``tid`` a stream, ``DEVICE_TID_BASE`` and up, no
host thread's), with ``args.device_ms`` the exact ``elapsed_time``.  It
is placed on the tracer's clock through one anchor per device: an event
recorded, with its host time, right after a ``torch.cuda.synchronize()``
that runs once, when the first device span opens; ``events()`` and
``export()`` take a new anchor after resolving.  The host span and its
twin share ``args.span_id``.

:func:`scope` names a range in ``torch.profiler`` timelines only
(``record_function`` under ``full``, nothing in the ring): the model's
layer ranges and the exchange's per-bucket ones.

Clocks: ``ts`` is microseconds of ``time.monotonic`` since the tracer's
creation; the export's ``clock_sync`` metadata holds that origin and two
``(monotonic_ns, time_ns)`` pairs, taken at creation and at export, which
map ``ts`` onto ``CLOCK_REALTIME``, the clock of ``torch.profiler``'s
events (``tools/trace_merge.py --profile``).

The mode is resolved ONCE at import (the hot path is one module-global
truthiness check); :func:`set_mode` exists for tests and tools that flip
it in-process.

``docs/torch_observability.md`` describes the port's additions: scopes,
device twins, the step's phase spans, the clock pair and
``trace_merge --profile``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque

__all__ = ["Span", "SpanTracer", "CudaEvents", "tracer", "span", "scope",
           "instant", "mode", "enabled", "named_scopes_enabled", "set_mode",
           "reset_tracer", "validate_events", "repair_balance",
           "read_jsonl", "TRACE_ENV", "MODES", "DEVICE_TID_BASE"]

TRACE_ENV = "CHAINERMN_TPU_TRACE"
MODES = ("off", "events", "full")

_REQUIRED_KEYS = ("name", "ph", "ts", "pid", "tid")

#: the first device track's ``tid``: above every Linux thread id, which
#: are addresses under 2**48, and within a JSON number's exact range
DEVICE_TID_BASE = 1 << 50


def _resolve_mode(value=None):
    v = (value if value is not None
         else os.environ.get(TRACE_ENV, "off")).strip().lower() or "off"
    if v not in MODES:
        raise ValueError(f"{TRACE_ENV}={v!r}: expected one of {MODES}")
    return v


# Resolved at import: the disabled hot path is `if not _ENABLED` on a
# module global — no env read, no object construction, per call site.
_MODE = _resolve_mode()
_ENABLED = _MODE != "off"
_FULL = _MODE == "full"


def mode():
    """The resolved ``CHAINERMN_TPU_TRACE`` mode (off|events|full)."""
    return _MODE


def enabled():
    """True when spans are recorded (``events`` or ``full``)."""
    return _ENABLED


def named_scopes_enabled():
    """True only under ``full``: span names also open
    ``torch.profiler.record_function`` so profiler timelines share the
    vocabulary.  The port itself asks :func:`scope` instead; this stays
    for the JAX package's API, whose communicator calls it."""
    return _FULL


def set_mode(value):
    """Re-resolve the trace mode in-process (tests / tools; production
    runs set the env var before import).  Returns the previous mode."""
    global _MODE, _ENABLED, _FULL
    prev = _MODE
    _MODE = _resolve_mode(value)
    _ENABLED = _MODE != "off"
    _FULL = _MODE == "full"
    return prev


class _NoopSpan:
    """The off-path singleton: every disabled ``span()`` call returns
    THIS object: no allocation, no clock read."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class Span:
    """An open interval: ``B`` recorded at construction, ``E`` at
    ``__exit__``/``close()``.  Context-manager use guarantees balance;
    an unclosed span is repaired at export (synthetic ``E``)."""

    __slots__ = ("_tracer", "name", "tid", "_twin")

    def __init__(self, tracer, name, tags=None, tid=None, device=None):
        self._tracer = tracer
        self.name = name
        self.tid = tid if tid is not None else threading.get_ident()
        ts = tracer._now_us()   # before the twin's event is recorded
        self._twin = tracer._open_twin(device)
        if self._twin is not None:
            tags = dict(tags or (), span_id=self._twin[0])
        tracer._emit("B", name, ts, self.tid, tags)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):
        if self._tracer is not None:
            self._tracer._emit("E", self.name, self._tracer._now_us(),
                               self.tid, None)
            if self._twin is not None:
                self._tracer._close_twin(self.name, self._twin)
            self._tracer = None


class CudaEvents:
    """The device twins' event source: timing ``torch.cuda.Event``\\ s on
    a device's current stream.  A test puts a fake with the same methods
    in its place (``SpanTracer(device_events=...)``); an event needs
    ``query()``, ``synchronize()`` and ``elapsed_time(later)`` (ms)."""

    @staticmethod
    def accepts(device):
        return getattr(device, "type", None) == "cuda"

    @staticmethod
    def synchronize(device):
        import torch
        torch.cuda.synchronize(device)

    @staticmethod
    def record(device):
        """A timing event recorded now on ``device``'s current stream, and
        the stream's key ``(device index, stream id)``."""
        import torch
        stream = torch.cuda.current_stream(device)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev, (stream.device_index, stream.stream_id)


class SpanTracer:
    """Rank-tagged span recorder over a bounded ring buffer.

    ``capacity``: ring bound (``CHAINERMN_TPU_TRACE_CAPACITY``, default
    65536 events) — the oldest events fall off; export repairs any
    B/E pairs the eviction unbalanced so the written file is always
    schema-valid.
    """

    def __init__(self, rank=0, capacity=None, device_events=None):
        if capacity is None:
            capacity = int(os.environ.get(
                "CHAINERMN_TPU_TRACE_CAPACITY", "65536"))
        self._events = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._t0_ns = time.monotonic_ns()
        self._created = _clock_pair()
        self.rank = int(rank)
        self.epoch = None
        self._dropped = 0
        self._track_ts = {}   # tid -> last emitted ts (complete() clamp)
        self.device_events = device_events or CudaEvents()
        self._pending = deque()   # (name, start, end, stream, anchor, id)
        self._anchors = {}        # device -> (event, host ts)
        self._device_tids = {}    # stream key -> tid
        self._span_ids = 0
        self._device_lock = threading.Lock()

    # -- configuration -------------------------------------------------------

    def configure(self, rank=None, epoch=None):
        """Stamp the rank (Chrome ``pid`` — one lane per rank in a
        merged trace) and, on elastic runs, the current membership
        epoch (tagged into every subsequent event's args)."""
        if rank is not None:
            self.rank = int(rank)
        if epoch is not None:
            self.epoch = int(epoch)

    # -- recording -----------------------------------------------------------

    def _now_us(self):
        return (time.monotonic_ns() - self._t0_ns) // 1000

    def _emit(self, ph, name, ts, tid, tags):
        ev = {"name": name, "ph": ph, "ts": ts, "pid": self.rank,
              "tid": tid}
        args = dict(tags) if tags else None
        if self.epoch is not None:
            args = args or {}
            args["epoch"] = self.epoch
        if args:
            ev["args"] = args
        if ph == "i":
            ev["s"] = "t"   # thread-scoped instant (Perfetto marker)
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(ev)
            if ts > self._track_ts.get(tid, -1):
                self._track_ts[tid] = ts

    def span(self, name, tags=None, tid=None, device=None):
        """Open a span (use as a context manager); on a CUDA ``device``
        (one the tracer's ``device_events`` accept) with a device twin."""
        return Span(self, name, tags=tags, tid=tid, device=device)

    def instant(self, name, tags=None, tid=None):
        """A point event on the track (eviction, fork, detection...)."""
        self._emit("i", name, self._now_us(),
                   tid if tid is not None else threading.get_ident(),
                   tags)

    def complete(self, name, duration_s, tags=None, tid=None, end_us=None):
        """Record a span RETROACTIVELY: an interval of ``duration_s``
        seconds ending now (or at ``end_us``).  Used where the start
        was observed on a different clock — e.g. a serving request's
        queue wait, measured on the engine's (possibly SIMULATED)
        clock: the EXACT duration is stamped into ``args.duration_ms``,
        and the drawn interval is clamped so its start never reaches
        back past the track's last event — a foreign-clock duration
        larger than the real elapsed tracer time would otherwise
        overlap earlier spans on the lane and cross-pair their B/E
        under LIFO pairing (wrong durations in Perfetto even though
        the file stays balanced)."""
        end = self._now_us() if end_us is None else int(end_us)
        t = tid if tid is not None else threading.get_ident()
        start = max(0, end - int(duration_s * 1e6),
                    self._track_ts.get(t, 0))
        end = max(end, start)
        args = dict(tags) if tags else {}
        args["duration_ms"] = round(duration_s * 1e3, 3)
        self._emit("B", name, start, t, args)
        self._emit("E", name, end, t, None)

    # -- device twins --------------------------------------------------------

    def _open_twin(self, device):
        """A device span's start, ``(span id, device, start event, stream
        key, anchor)``; None where the span has no twin.  The first span on
        a device takes its anchor (one synchronize)."""
        if device is None or not self.device_events.accepts(device):
            return None
        with self._device_lock:
            self._resolve(wait=False)
            if device not in self._anchors:
                self._anchor(device)
            self._span_ids += 1
            span_id, anchor = self._span_ids, self._anchors[device]
        start, key = self.device_events.record(device)
        return span_id, device, start, key, anchor

    def _close_twin(self, name, twin):
        span_id, device, start, key, anchor = twin
        end, _ = self.device_events.record(device)
        with self._device_lock:
            self._pending.append((name, start, end, key, anchor, span_id))

    def _anchor(self, device):
        """An event recorded on an idle ``device``, with the host time:
        the point that places the device's events on the tracer's
        clock."""
        self.device_events.synchronize(device)
        event, _ = self.device_events.record(device)
        self._anchors[device] = (event, self._now_us())

    def _resolve(self, wait):
        """The pending pairs as ``<name>/device`` B/E pairs on their
        stream's track: those finished, oldest first, or with ``wait``
        all of them.  Caller holds ``_device_lock``."""
        while self._pending:
            name, start, end, key, (anchor, anchor_us), span_id = \
                self._pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self._pending.popleft()
            ms = start.elapsed_time(end)
            begin_us = anchor_us + anchor.elapsed_time(start) * 1e3
            tid = self._device_tids.setdefault(
                key, DEVICE_TID_BASE + len(self._device_tids))
            self._emit("B", name + "/device", round(begin_us), tid,
                       {"device_ms": ms, "span_id": span_id})
            self._emit("E", name + "/device", round(begin_us + ms * 1e3),
                       tid, None)

    def _settle(self):
        """Every pending pair resolved, then each device anchored anew."""
        with self._device_lock:
            self._resolve(wait=True)
            for device in list(self._anchors):
                self._anchor(device)

    # -- export --------------------------------------------------------------

    def events(self):
        """Snapshot of the ring (metadata events NOT included), with every
        pending device twin resolved first."""
        self._settle()
        with self._lock:
            return list(self._events)

    def clear(self):
        """Empty the ring and drop the pending device twins; the anchors
        stay."""
        with self._device_lock:
            self._pending.clear()
        with self._lock:
            self._events.clear()
            self._track_ts.clear()
            self._dropped = 0

    def export(self, path):
        """Write the ring as Chrome-trace-event JSONL, sanitized to the
        committed schema: events ts-sorted, per-track B/E balanced
        (orphan ``E`` whose ``B`` fell off the ring are dropped,
        unclosed ``B`` get a synthetic ``E`` at the track's last ts),
        prefixed with ``M`` metadata: the rank lane's name, the
        ``clock_sync`` pairs, each device track's name.  Returns the
        number of NON-metadata events written (0 = nothing recorded;
        callers use that to skip empty shards)."""
        evs = sorted(self.events(), key=lambda e: e["ts"])
        evs = repair_balance(evs)
        meta = [{"name": "process_name", "ph": "M", "ts": 0,
                 "pid": self.rank, "tid": 0,
                 "args": {"name": f"rank{self.rank}"}},
                {"name": "clock_sync", "ph": "M", "ts": 0,
                 "pid": self.rank, "tid": 0,
                 "args": {"t0_monotonic_ns": self._t0_ns,
                          "created": self._created,
                          "exported": _clock_pair()}}]
        meta += [{"name": "thread_name", "ph": "M", "ts": 0,
                  "pid": self.rank, "tid": tid,
                  "args": {"name": f"cuda:{key[0]} stream {key[1]}"}}
                 for key, tid in sorted(self._device_tids.items(),
                                        key=lambda kv: kv[1])]
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            for ev in meta + evs:
                f.write(json.dumps(ev) + "\n")
        return len(evs)


def _clock_pair():
    """``[monotonic_ns, time_ns]`` read back to back (the monotonic one
    the mean of a read before and after)."""
    m0 = time.monotonic_ns()
    real = time.time_ns()
    return [(m0 + time.monotonic_ns()) // 2, real]


def repair_balance(events):
    """Repair B/E damage in a ts-sorted event stream: drop ``E`` events
    whose ``B`` is gone (ring eviction; a checkpoint export's synthetic
    close followed by the exit export's real ``E``), close still-open
    ``B`` with synthetic ``E`` at the track's final ts.  Used by both
    :meth:`SpanTracer.export` and ``tools/trace_merge.py`` — output
    satisfies :func:`validate_events`."""
    out = []
    stacks = {}   # (pid, tid) -> [names]
    last_ts = {}
    for ev in events:
        key = (ev["pid"], ev["tid"])
        ph = ev["ph"]
        if ph == "B":
            stacks.setdefault(key, []).append(ev["name"])
            out.append(ev)
        elif ph == "E":
            stack = stacks.get(key)
            if stack and stack[-1] == ev["name"]:
                stack.pop()
                out.append(ev)
            # else: orphan E (its B was evicted) — dropped
        else:
            out.append(ev)
        last_ts[key] = ev["ts"]
    for (pid, tid), stack in stacks.items():
        while stack:
            out.append({"name": stack.pop(), "ph": "E",
                        "ts": last_ts[(pid, tid)], "pid": pid,
                        "tid": tid})
    return out


def validate_events(events):
    """The committed trace schema, machine-checked (the JAX package's
    ``tools/trace_merge.py`` checks a merge with its own copy and
    refuses to write a merge that fails it).

    Every event: the required keys, ``ph`` in {B,E,i,M}, integer
    ``ts >= 0``.  Per (pid, tid) track: ``ts`` monotonically
    non-decreasing in file order, and B/E strictly balanced with
    E matching the innermost open B (proper nesting).  Raises
    ``ValueError`` naming the first offending event; returns the event
    count on success."""
    cursors = {}
    stacks = {}
    for i, ev in enumerate(events):
        for k in _REQUIRED_KEYS:
            if k not in ev:
                raise ValueError(f"event {i} missing key {k!r}: {ev}")
        if ev["ph"] not in ("B", "E", "i", "M"):
            raise ValueError(f"event {i}: unknown ph {ev['ph']!r}")
        if not isinstance(ev["ts"], int) or ev["ts"] < 0:
            raise ValueError(f"event {i}: ts must be a non-negative "
                             f"integer, got {ev['ts']!r}")
        if ev["ph"] == "M":
            continue
        key = (ev["pid"], ev["tid"])
        if ev["ts"] < cursors.get(key, 0):
            raise ValueError(
                f"event {i}: ts {ev['ts']} goes backwards on track "
                f"{key} (last {cursors[key]})")
        cursors[key] = ev["ts"]
        if ev["ph"] == "B":
            stacks.setdefault(key, []).append(ev["name"])
        elif ev["ph"] == "E":
            stack = stacks.get(key)
            if not stack:
                raise ValueError(f"event {i}: E {ev['name']!r} with no "
                                 f"open B on track {key}")
            if stack[-1] != ev["name"]:
                raise ValueError(
                    f"event {i}: E {ev['name']!r} does not match "
                    f"innermost open B {stack[-1]!r} on track {key}")
            stack.pop()
    for key, stack in stacks.items():
        if stack:
            raise ValueError(f"track {key}: unclosed B spans {stack}")
    return len(events)


def read_jsonl(path):
    """Read a JSONL trace shard (blank lines skipped)."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


# -- module-level convenience surface ---------------------------------------

_TRACER = None
_TRACER_LOCK = threading.Lock()


def tracer():
    """The process-global tracer (created on first use)."""
    global _TRACER
    if _TRACER is None:
        with _TRACER_LOCK:
            if _TRACER is None:
                _TRACER = SpanTracer()
    return _TRACER


def reset_tracer():
    """Drop the global tracer (tests; the next ``tracer()`` call builds
    a fresh one re-reading the capacity env knob)."""
    global _TRACER
    _TRACER = None


@contextlib.contextmanager
def _full_span(name, tags, tid, device):
    import torch.profiler
    with torch.profiler.record_function(name.replace("/", ".")):
        with tracer().span(name, tags=tags, tid=tid, device=device):
            yield


def span(name, tags=None, tid=None, device=None):
    """Open a span on the global tracer — THE instrumentation call site.

    Off (default): returns the no-op singleton — no allocation, no
    clock read.  ``events``: records B/E on the ring, and on a CUDA
    ``device`` its device twin.  ``full``: additionally opens
    ``torch.profiler.record_function`` so any surrounding profiler trace
    carries the same name."""
    if not _ENABLED:
        return _NOOP
    if _FULL:
        return _full_span(name, tags, tid, device)
    return tracer().span(name, tags=tags, tid=tid, device=device)


def scope(name):
    """A named range in ``torch.profiler`` timelines (``/`` as ``.``):
    ``record_function`` under ``full``, else the no-op singleton.  It
    records nothing in the ring."""
    if not _FULL:
        return _NOOP
    import torch.profiler
    return torch.profiler.record_function(name.replace("/", "."))


def instant(name, tags=None, tid=None):
    """Record a point event on the global tracer (no-op when off)."""
    if _ENABLED:
        tracer().instant(name, tags=tags, tid=tid)
