"""Runtime observability: the port of ``chainermn_tpu.observability``.

Two host-side pieces every subsystem shares, copied from the JAX package
(pure host code):

* :mod:`.tracing`: structured span tracing into a bounded ring, exported
  as Chrome-trace-event JSONL (Perfetto-loadable; rank shards merge with
  the JAX package's ``tools/trace_merge.py``), gated by
  ``CHAINERMN_TPU_TRACE=off|events|full``; under ``full`` every span also
  opens ``torch.profiler.record_function``; a span given a CUDA
  ``device`` also records its device twin from CUDA events, and
  :func:`~.tracing.scope` names a profiler range alone;
* :mod:`.metrics`: a mergeable registry of counters, gauges and
  fixed-bucket histograms, joined across ranks over the communicator's
  ``allgather_obj`` and rendered in Prometheus text format.
"""

from .metrics import (DEFAULT_TIME_BUCKETS_MS, Counter, Gauge, Histogram,
                      MetricsRegistry, registry, reset_registry)
from .tracing import (MODES, TRACE_ENV, Span, SpanTracer, enabled, instant,
                      mode, named_scopes_enabled, read_jsonl,
                      repair_balance, reset_tracer, scope, set_mode, span,
                      tracer, validate_events)

__all__ = [
    "Span", "SpanTracer", "tracer", "span", "scope", "instant", "mode",
    "enabled", "named_scopes_enabled", "set_mode", "reset_tracer",
    "validate_events", "repair_balance",
    "read_jsonl", "TRACE_ENV", "MODES",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
    "reset_registry", "DEFAULT_TIME_BUCKETS_MS",
]
