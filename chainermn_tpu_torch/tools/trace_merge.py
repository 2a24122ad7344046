"""Merge rank-tagged Chrome-trace JSONL shards into one Perfetto file:
the port of the JAX package's ``tools/trace_merge.py``, over the port's
own ``read_jsonl``, ``repair_balance`` and ``validate_events``, so it
runs where JAX is not installed.

Every rank's span tracer writes its own shard (``trace-rank<N>.jsonl``:
one Chrome trace event per line, ``pid`` = rank).  This tool joins them:

* events are deduplicated across shards by (pid, tid, ts, ph, name, its
  occurrence within the shard): a shard exported twice collapses to one
  copy, while distinct events, even two equal ones within one shard, are
  never dropped;
* metadata events lead, then the union is sorted by ``ts`` (a stable
  sort: a B before its E at an equal time stays first), the balance
  repaired (an E left orphaned by the dedupe dropped, a B left open
  closed) and validated against the schema; an invalid merge is refused
  with a non-zero exit and nothing written;
* the output is Chrome trace "JSON array" format (``[...]``), which
  Perfetto and ``chrome://tracing`` load directly;
* with ``--profile <trace.json>`` (a ``torch.profiler`` Chrome capture,
  ``utils.profiling.trace``), the merge is written into that capture on
  the profiler's clock: each shard's ``ts`` is mapped through its
  ``clock_sync`` pairs onto ``CLOCK_REALTIME`` and the capture's
  ``baseTimeNanoseconds``, and each rank's lane moves to pid
  ``RANK_PID_BASE + rank`` (the capture's own pids are the host
  process's and the cards'), so host spans, device twins and kernels
  share one timeline.

Usage::

    python -m chainermn_tpu_torch.tools.trace_merge -o merged.json result/trace-rank*.jsonl
    python -m chainermn_tpu_torch.tools.trace_merge --profile result/trace/trace.json \
        -o merged.json result/trace-rank*.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys

from ..observability.tracing import (read_jsonl, repair_balance,
                                     validate_events)

__all__ = ["merge_events", "merge_files", "profiler_clock",
           "merge_with_profile", "main", "RANK_PID_BASE"]

#: a rank's lane in a merge with a profiler capture: above every process
#: id of the host (at most 2**22 on Linux) and every card's index
RANK_PID_BASE = 1 << 24


def _dedupe_key(ev):
    return (ev.get("pid"), ev.get("tid"), ev.get("ts"), ev.get("ph"),
            ev.get("name"))


def merge_events(shards):
    """Merge per-rank event lists: dedupe across shards, sort, repair,
    validate.  Returns the merged event list; a schema-invalid result
    raises ``ValueError``."""
    seen = set()
    merged = []
    for shard in shards:
        occurrence = {}
        for ev in shard:
            key = _dedupe_key(ev)
            n = occurrence.get(key, 0)
            occurrence[key] = n + 1
            if (key, n) in seen:
                continue
            seen.add((key, n))
            merged.append(ev)
    merged.sort(key=lambda e: (0 if e.get("ph") == "M" else 1,
                               e.get("ts", 0)))
    try:
        merged = repair_balance(merged)
    except (KeyError, TypeError) as e:
        raise ValueError(f"malformed event in shard: {e!r}") from e
    validate_events(merged)
    return merged


def merge_files(paths, out_path=None):
    """Merge JSONL shard files; with ``out_path``, write the
    Perfetto-loadable JSON array there.  Returns the merged events."""
    merged = merge_events([read_jsonl(p) for p in paths])
    if out_path is not None:
        with open(out_path, "w") as f:
            f.write("[\n")
            f.write(",\n".join(json.dumps(ev) for ev in merged))
            f.write("\n]\n")
    return merged


def profiler_clock(clock, base_ns=0):
    """``ts -> profiler ts`` for one shard: its ``clock_sync`` metadata
    (the monotonic origin of ``ts`` and the ``[monotonic_ns, time_ns]``
    pairs taken at the tracer's creation and at the export), a line
    through the two pairs; the result in microseconds since
    ``base_ns`` of ``CLOCK_REALTIME``."""
    (m0, r0), (m1, r1) = clock["created"], clock["exported"]
    slope = (r1 - r0) / (m1 - m0) if m1 != m0 else 1.0
    origin = clock["t0_monotonic_ns"]

    def convert(ts):
        return (r0 - base_ns + (origin + ts * 1000 - m0) * slope) / 1000
    return convert


def merge_with_profile(shard_events, profile):
    """The merged shards (:func:`merge_events`' output) inside the
    ``torch.profiler`` Chrome capture ``profile`` (its JSON object), on
    the capture's clock: a new capture object.  A shard without
    ``clock_sync`` metadata cannot be placed and raises
    ``ValueError``."""
    base = profile.get("baseTimeNanoseconds", 0)
    clocks = {e["pid"]: profiler_clock(e["args"], base)
              for e in shard_events
              if e.get("ph") == "M" and e["name"] == "clock_sync"}
    placed = []
    for e in shard_events:
        if e["pid"] not in clocks:
            raise ValueError(f"rank {e['pid']}'s shard has no clock_sync "
                             f"metadata: it cannot be placed on the "
                             f"profiler's clock")
        e = dict(e, pid=RANK_PID_BASE + e["pid"])
        if e["ph"] != "M":
            e["ts"] = clocks[e["pid"] - RANK_PID_BASE](e["ts"])
        placed.append(e)
    return dict(profile, traceEvents=list(profile.get("traceEvents", ()))
                + placed)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Merge rank-tagged Chrome-trace JSONL shards into one "
                    "Perfetto file.")
    ap.add_argument("shards", nargs="+",
                    help="rank-tagged JSONL trace shards")
    ap.add_argument("-o", "--out", required=True,
                    help="merged Perfetto-loadable JSON array")
    ap.add_argument("--profile",
                    help="a torch.profiler Chrome capture to merge the "
                         "shards into, on its clock")
    args = ap.parse_args(argv)
    try:
        if args.profile is None:
            merged = merge_files(args.shards, args.out)
        else:
            merged = merge_files(args.shards)
            with open(args.profile) as f:
                out = merge_with_profile(merged, json.load(f))
            with open(args.out, "w") as f:
                json.dump(out, f)
    except ValueError as e:
        print(f"trace_merge: REFUSED (schema-invalid merge): {e}",
              file=sys.stderr)
        return 1
    ranks = sorted({ev.get("pid") for ev in merged
                    if ev.get("ph") != "M"})
    print(f"trace_merge: {len(merged)} events from "
          f"{len(args.shards)} shard(s), ranks {ranks} -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
