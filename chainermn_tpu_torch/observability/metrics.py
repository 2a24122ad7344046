"""Mergeable runtime metrics registry.

The port of ``chainermn_tpu.observability.metrics`` (pure host code,
copied).

Counters, gauges, and fixed-bucket histograms as PURE HOST OBJECTS —
no device arrays, no jit interaction — updated from the instrumentation
sites (trainer step phases, serving scheduler, elastic supervisor) and:

* **mergeable across ranks** over the existing object collectives
  (:meth:`MetricsRegistry.merge_across` rides ``comm.allgather_obj`` —
  the same transport scatter_dataset/checkpoint consensus use, so a
  metrics merge needs no new wire machinery).  Counters and histograms
  SUM (they are rank-additive by construction); gauges are point-in-
  time per-rank facts and merge under an added ``rank`` label instead
  of a lossy reduction;
* **dumped in Prometheus text exposition format**
  (:meth:`to_prometheus` — ``# HELP``/``# TYPE`` + samples, histograms
  as cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count``), which is
  what a real deployment's scraper ingests unchanged.

Histograms use FIXED bucket bounds chosen at construction (the
Prometheus discipline): merging is then bucket-wise addition, exact —
no quantile sketch, no approximation surprises across ranks.

All mutation paths are thread-safe (one registry lock — these are
bookkeeping counters, not a hot loop; the serving engine touches them
a handful of times per decode step and only when observability is
enabled).
"""

from __future__ import annotations

import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "registry", "reset_registry", "DEFAULT_TIME_BUCKETS_MS"]

# Default latency bucket ladder (milliseconds): spans queue waits from
# sub-ms scheduler passes to multi-second preemption stalls.
DEFAULT_TIME_BUCKETS_MS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                           500.0, 1000.0, 2500.0, 5000.0, 10000.0)


def _label_key(labels):
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label_value(v):
    """Prometheus text-format label-value escaping (backslash, quote,
    newline) — label values are caller-supplied (tenant names), and one
    stray quote must not forge or break the whole exposition."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt_labels(key):
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label_value(v)}"'
                          for k, v in key) + "}"


class _Metric:
    kind = None

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._values = {}          # label key tuple -> value
        self._lock = threading.Lock()

    def labels(self):
        with self._lock:
            return list(self._values)

    def value(self, **labels):
        with self._lock:
            return self._values.get(_label_key(labels))


class Counter(_Metric):
    """Monotonic accumulator (``inc`` only — a decrement is a bug)."""

    kind = "counter"

    def inc(self, amount=1, **labels):
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment "
                             f"{amount}")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def _merge(self, values):
        with self._lock:
            for key, v in values.items():
                self._values[key] = self._values.get(key, 0) + v

    def _samples(self):
        with self._lock:
            return [(self.name, key, v)
                    for key, v in sorted(self._values.items())]


class Gauge(_Metric):
    """Point-in-time value (``set``); per-rank under merge."""

    kind = "gauge"

    def set(self, value, **labels):
        with self._lock:
            self._values[_label_key(labels)] = value

    def inc(self, amount=1, **labels):
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def _merge(self, values):
        # rank label is appended by the registry merge BEFORE this is
        # called, so distinct ranks can never collide here
        with self._lock:
            self._values.update(values)

    def _samples(self):
        with self._lock:
            return [(self.name, key, v)
                    for key, v in sorted(self._values.items())]


class Histogram(_Metric):
    """Fixed-bucket histogram (Prometheus shape: cumulative ``le``
    buckets + ``_sum`` + ``_count``).  Bucket bounds are part of the
    metric's identity — merging with mismatched bounds is a hard error,
    never a silent re-bin."""

    kind = "histogram"

    def __init__(self, name, help="", buckets=DEFAULT_TIME_BUCKETS_MS):
        super().__init__(name, help)
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError(f"histogram {name}: bucket bounds must be "
                             f"sorted, got {buckets}")

    def observe(self, value, **labels):
        key = _label_key(labels)
        with self._lock:
            counts, total, n = self._values.get(
                key, ([0] * (len(self.buckets) + 1), 0.0, 0))
            counts = list(counts)
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1   # +Inf bucket
            self._values[key] = (counts, total + value, n + 1)

    def percentile(self, q, **labels):
        """Bucket-resolution percentile estimate (upper bound of the
        bucket holding the q-th observation) — what the serving bench
        reports as p50/p99 queue wait when only the merged histogram
        survives.  None when empty."""
        v = self.value(**labels)
        if v is None or v[2] == 0:
            return None
        counts, _, n = v
        target = q / 100.0 * n
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= target and c:
                return (self.buckets[i] if i < len(self.buckets)
                        else float("inf"))
        return float("inf")

    def _merge(self, values):
        with self._lock:
            for key, (counts, total, n) in values.items():
                if key in self._values:
                    mc, mt, mn = self._values[key]
                    if len(mc) != len(counts):
                        raise ValueError(
                            f"histogram {self.name}: merging mismatched "
                            f"bucket counts ({len(mc)} vs {len(counts)})")
                    self._values[key] = (
                        [a + b for a, b in zip(mc, counts)],
                        mt + total, mn + n)
                else:
                    self._values[key] = (list(counts), total, n)

    def _samples(self):
        out = []
        with self._lock:
            for key, (counts, total, n) in sorted(self._values.items()):
                cum = 0
                for bound, c in zip(self.buckets, counts):
                    cum += c
                    out.append((f"{self.name}_bucket",
                                key + (("le", repr(bound)),), cum))
                out.append((f"{self.name}_bucket",
                            key + (("le", "+Inf"),), cum + counts[-1]))
                out.append((f"{self.name}_sum", key, total))
                out.append((f"{self.name}_count", key, n))
        return out


class MetricsRegistry:
    """Name -> metric, with get-or-create accessors (idempotent: the
    same name returns the same object; a name re-used across metric
    kinds is a hard error)."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help=help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {cls.kind}")
            return m

    def counter(self, name, help=""):
        return self._get(Counter, name, help)

    def gauge(self, name, help=""):
        return self._get(Gauge, name, help)

    def histogram(self, name, help="", buckets=DEFAULT_TIME_BUCKETS_MS):
        return self._get(Histogram, name, help, buckets=buckets)

    def metrics(self):
        with self._lock:
            return dict(self._metrics)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    # -- merge ---------------------------------------------------------------

    def to_dict(self):
        """Plain JSON-able snapshot (what rides ``allgather_obj``)."""
        out = {}
        for name, m in self.metrics().items():
            entry = {"kind": m.kind, "help": m.help,
                     "values": {json_key(k): v
                                for k, v in m._values.items()}}
            if m.kind == "histogram":
                entry["buckets"] = list(m.buckets)
            out[name] = entry
        return out

    def merge_dict(self, snapshot, rank=None):
        """Fold one rank's snapshot in: counters/histograms ADD, gauges
        keep per-rank identity via an appended ``rank`` label (when
        ``rank`` is given)."""
        for name, entry in snapshot.items():
            kind = entry["kind"]
            if kind == "counter":
                m = self.counter(name, entry.get("help", ""))
            elif kind == "gauge":
                m = self.gauge(name, entry.get("help", ""))
            elif kind == "histogram":
                m = self.histogram(name, entry.get("help", ""),
                                   buckets=tuple(entry["buckets"]))
                if tuple(entry["buckets"]) != m.buckets:
                    raise ValueError(
                        f"histogram {name!r}: bucket bounds differ "
                        f"across ranks ({entry['buckets']} vs "
                        f"{list(m.buckets)})")
            else:
                raise ValueError(f"metric {name!r}: unknown kind "
                                 f"{kind!r}")
            values = {unjson_key(k): v
                      for k, v in entry["values"].items()}
            if kind == "gauge" and rank is not None:
                # keys stay in _label_key's sorted order so lookups
                # through value(**labels) keep working after the merge
                values = {tuple(sorted(key + (("rank", str(rank)),))): v
                          for key, v in values.items()}
            if kind == "histogram":
                values = {k: tuple(v) for k, v in values.items()}
            m._merge(values)

    def merge_across(self, comm):
        """Every rank contributes its snapshot over the existing object
        collectives; every rank returns the SAME merged registry (the
        allgather is symmetric).  Counters/histograms sum; gauges gain
        a ``rank`` label."""
        shards = comm.allgather_obj(self.to_dict())
        merged = MetricsRegistry()
        for r, shard in enumerate(shards):
            merged.merge_dict(shard, rank=r)
        return merged

    # -- export --------------------------------------------------------------

    def to_prometheus(self):
        """Text exposition format (the scrape payload)."""
        lines = []
        for name, m in sorted(self.metrics().items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for sample_name, key, v in m._samples():
                if isinstance(v, float) and v == int(v):
                    v = int(v)
                lines.append(f"{sample_name}{_fmt_labels(key)} {v}")
        return "\n".join(lines) + ("\n" if lines else "")


def json_key(key):
    """Label key tuple -> a JSON-object-safe string."""
    return "\x1f".join(f"{k}\x1e{v}" for k, v in key)


def unjson_key(s):
    if not s:
        return ()
    return tuple(tuple(part.split("\x1e", 1))
                 for part in s.split("\x1f"))


_REGISTRY = None
_REGISTRY_LOCK = threading.Lock()


def registry():
    """The process-global registry (created on first use)."""
    global _REGISTRY
    if _REGISTRY is None:
        with _REGISTRY_LOCK:
            if _REGISTRY is None:
                _REGISTRY = MetricsRegistry()
    return _REGISTRY


def reset_registry():
    """Drop the global registry (tests)."""
    global _REGISTRY
    _REGISTRY = None
