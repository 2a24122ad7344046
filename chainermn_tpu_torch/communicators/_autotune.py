"""Self-tuning exchange planner: measure the fabric, agree, plan, apply.

The port of ``chainermn_tpu.communicators._autotune``.  The pure host
code is copied from the JAX package unchanged, with its rounding
(:func:`_round6`), :data:`PLAN_VERSION` and :data:`OVERHEAD_FRAC`, so the
same measurements give the same plan and the same
:func:`plan_fingerprint` in both packages:

1. **measure**: :func:`measure_fabric` times one ``all_reduce`` per hop
   of the communicator's ``torch.distributed`` groups (the world group
   of a flat communicator; the intra-node and inter-node subgroups of a
   hierarchical one), at ``probe_mb`` for bandwidth and at 8 elements
   for launch latency.  Or, online, :func:`measurements_from_trace`
   reads the ``train/grad_exchange*`` spans the multi-node optimizer
   emits under ``CHAINERMN_TPU_TRACE``, whose ``payload_bytes`` tags make
   bandwidth = bytes / duration.  On the card the duration is the span's
   device twin, which holds this rank's wait for the slowest rank as
   well as the exchange: :func:`online_measurement` takes each step's
   fastest rank, that is the minimum over the ranks.
2. **agree**: :func:`agree_exchange_plan` all-gathers every rank's
   measurement (``all_gather_object``), reduces them deterministically
   (sorted median, fixed tie-break, 6 significant digits), derives the
   plan locally, and executes rank 0's plan (``broadcast_object_list``);
   a rank whose own derivation differs is warned and counted.
3. **plan**: :func:`derive_exchange_plan`, a pure function of the agreed
   measurements and :func:`topology_summary`: ``bucket_mb`` from the
   slowest hop's bandwidth x latency, ``stripe_ratio`` from the
   finish-together split, a bf16 inter-node crossing when that hop is
   under half the intra-node bandwidth.  An unmeasurable hop (size 1, or
   no latency sample) falls back to the committed defaults with a note.

:meth:`~.mesh_communicator.MeshCommunicator.retuned` applies a plan only
to the knobs the caller did not set by hand.  The agreed plan is written
to ``$CHAINERMN_TPU_AUTOTUNE_DIR/autotune_plan_<axis>.json`` in the JAX
package's format.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import warnings

import torch
import torch.distributed as dist

from .. import observability
from ._memory_utility import (DEFAULT_BUCKET_MB, DEFAULT_STRIPE_RATIO,
                              derived_bucket_bytes, derived_stripe_ratio,
                              exchanged_bytes)

__all__ = ["measure_fabric", "measurements_from_trace",
           "exchange_twin_samples", "online_measurement",
           "reduce_measurements", "derive_exchange_plan",
           "agree_exchange_plan", "retune_communicator",
           "topology_summary", "plan_fingerprint", "record_plan",
           "PLAN_VERSION"]

#: plan schema version: bumped when the derivation rules change, so a
#: recorded plan is never replayed against other rules
PLAN_VERSION = 1

#: the share of a collective's time its launch overhead may take, which
#: the bucket rule amortizes
OVERHEAD_FRAC = 0.125


def _round6(x):
    """Six significant digits: every number that enters a plan passes
    through here, so ranks deriving from the same agreed measurements
    write byte-identical JSON."""
    return float(f"{float(x):.6g}")


# -- measurement ----------------------------------------------------------------
def _hop_list(comm):
    """``(hop name, process group, size)`` per fabric hop: ``ici`` (the
    intra-node subgroup) and ``dcn`` (the inter-node one) on a
    hierarchical communicator, ``world`` (its group) on a flat one."""
    if comm.hierarchy is not None:
        intra_g, inter_g = comm._hop_groups
        return [("ici", intra_g, comm.ici_size),
                ("dcn", inter_g, comm.dcn_size)]
    return [("world", comm.group, comm.size)]


def _synchronized(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_fabric(comm, probe_mb=1.0, iters=4):
    """Startup micro-bench: per hop, ``iters`` chained ``all_reduce``\\ s
    of a ``probe_mb`` fp32 buffer (scaled by ``1/size`` after each, so
    the value stays put) timed together for bandwidth (wire bytes per
    call = :func:`exchanged_bytes` of an allreduce over the hop), and
    ``iters`` single calls on 8 elements for launch latency (the
    fastest).  Host wall clock around the calls, with the card
    synchronized on both sides on CUDA.  A size-1 hop crosses no wire and
    reports ``{"size": 1, "gbps": None, "lat_us": None}``.  Collective:
    every rank of the communicator enters."""
    measurement = {"source": "startup", "probe_mb": _round6(probe_mb),
                   "iters": int(iters), "hops": {}}
    device = comm.device
    with observability.span("autotune/measure",
                            tags={"mode": "startup",
                                  "probe_mb": float(probe_mb)}):
        for hop, group, size in _hop_list(comm):
            if size <= 1:
                measurement["hops"][hop] = {"size": 1, "gbps": None,
                                            "lat_us": None}
                continue
            inv = 1.0 / float(size)

            def probe(x, _group=group, _inv=inv):
                dist.all_reduce(x, group=_group)
                x.mul_(_inv)

            n_big = max(1, int(float(probe_mb) * (1 << 20)) // 4)
            big = torch.ones(n_big, dtype=torch.float32, device=device)
            probe(big)                               # warm
            _synchronized(device)
            t0 = time.perf_counter()
            for _ in range(int(iters)):
                probe(big)
            _synchronized(device)
            elapsed = max(time.perf_counter() - t0, 1e-9)
            wire = exchanged_bytes(n_big * 4, size, "psum")
            gbps = wire * int(iters) / elapsed / 1e9

            small = torch.ones(8, dtype=torch.float32, device=device)
            probe(small)
            _synchronized(device)
            lat_s = float("inf")
            for _ in range(int(iters)):
                t0 = time.perf_counter()
                probe(small)
                _synchronized(device)
                lat_s = min(lat_s, time.perf_counter() - t0)
            measurement["hops"][hop] = {"size": int(size),
                                        "gbps": float(gbps),
                                        "lat_us": float(lat_s * 1e6)}
    return measurement


def measurements_from_trace(events, payload_key="payload_bytes"):
    """Online mode: bandwidth read off the ``train/grad_exchange*`` spans.
    B/E pairs match LIFO per ``(pid, tid, name)``; each pair adds its
    ``args.payload_bytes`` over its duration, grouped by its ``args.hop``
    tag (``world`` without one).  A span without the payload tag is not a
    sample.  Where the span has a device twin (``<name>/device`` with the
    same ``args.span_id``), the duration is the twin's ``device_ms``: on
    the card the host span times only the exchange's enqueue.  The twin
    runs from the end of the work before the exchange on this rank's
    stream to the end of the exchange, so it also holds this rank's wait
    for the slowest rank (:func:`online_measurement` removes it).  A trace
    gives no latency field (a whole exchange bounds the launch overhead
    only loosely), so a plan from online measurements keeps the
    committed ``bucket_mb``."""
    totals = {}     # hop -> [bytes, seconds, samples]
    for hop, payload, dur_s, _ in _exchange_samples(events, payload_key):
        acc = totals.setdefault(hop, [0.0, 0.0, 0])
        acc[0] += float(payload)
        acc[1] += dur_s
        acc[2] += 1
    return _online_hops(totals)


def _online_hops(totals):
    hops = {}
    for hop, (nbytes, secs, samples) in sorted(totals.items()):
        hops[hop] = {"size": None,
                     "gbps": nbytes / secs / 1e9 if secs > 0 else None,
                     "lat_us": None, "samples": samples}
    return {"source": "online", "hops": hops}


def _exchange_samples(events, payload_key="payload_bytes"):
    """``(hop, payload, seconds, from_twin)`` of each closed
    ``train/grad_exchange*`` span with a payload tag, in the order the
    spans close."""
    open_spans = {}
    events = events or []
    device_ms = {(ev.get("pid"), ev["args"]["span_id"]):
                 ev["args"]["device_ms"] for ev in events
                 if ev.get("ph") == "B"
                 and ev.get("name", "").endswith("/device")
                 and {"device_ms", "span_id"} <= set(ev.get("args") or ())}
    for ev in events:
        name = ev.get("name", "")
        if not name.startswith("train/grad_exchange"):
            continue
        key = (ev.get("pid"), ev.get("tid"), name)
        if ev.get("ph") == "B":
            open_spans.setdefault(key, []).append(ev)
        elif ev.get("ph") == "E" and open_spans.get(key):
            b = open_spans[key].pop()
            args = b.get("args") or {}
            payload = args.get(payload_key)
            if payload is None:
                continue
            twin_ms = device_ms.get((b.get("pid"), args["span_id"])) \
                if "span_id" in args else None
            dur_s = (twin_ms * 1e-3 if twin_ms is not None else
                     max(ev.get("ts", 0) - b.get("ts", 0), 0) * 1e-6)
            if dur_s <= 0:
                continue
            yield args.get("hop", "world"), payload, dur_s, \
                twin_ms is not None


def exchange_twin_samples(events, payload_key="payload_bytes"):
    """This rank's exchanges timed by their device twins, one sample a
    span in the order the spans close: ``{hop: [[payload_bytes, seconds],
    ...]}``.  Spans without a twin are left out (``{}`` off the card)."""
    out = {}
    for hop, payload, dur_s, from_twin in _exchange_samples(events,
                                                            payload_key):
        if from_twin:
            out.setdefault(hop, []).append([float(payload), dur_s])
    return out


def online_measurement(comm, events):
    """The online measurement this rank brings to the agreement.  On the
    card each exchange's twin holds the exchange and this rank's wait for
    the slowest rank; the rank that came last waited least, so the
    minimum over the ranks of each step's twin is the exchange.  Where
    every rank has twins for the same hops, the ranks all-gather their
    :func:`exchange_twin_samples`, and each step of a hop takes its
    fastest rank's seconds over the last steps every rank holds: every
    rank then brings the same measurement.  Otherwise (the CPU, where
    gloo's allreduce returns when the exchange is done) the rank's own
    :func:`measurements_from_trace`.  Collective."""
    samples = exchange_twin_samples(events)
    gathered = comm.allgather_obj(samples)
    hops = set(gathered[0]) if gathered else set()
    if not hops or any(set(g) != hops for g in gathered):
        return measurements_from_trace(events)
    totals = {}
    for hop in sorted(hops):
        steps = min(len(g[hop]) for g in gathered)
        rows = [g[hop][len(g[hop]) - steps:] for g in gathered]
        totals[hop] = [sum(rows[0][i][0] for i in range(steps)),
                       sum(min(r[i][1] for r in rows)
                           for i in range(steps)),
                       steps]
    return _online_hops(totals)


# -- deterministic agreement ------------------------------------------------------
def reduce_measurements(gathered):
    """The all-gathered per-rank measurements reduced to one agreed set:
    per hop and field the sorted median with a fixed tie-break (element
    ``(n-1)//2``), rounded to 6 significant digits.  Order-insensitive:
    every rank holds the same list after the all-gather, so every rank
    reduces to the same set."""
    gathered = [g for g in gathered if g]
    if not gathered:
        raise ValueError("no fabric measurements to reduce")
    base = gathered[0]
    out = {"source": base.get("source", "startup"), "ranks": len(gathered)}
    for k in ("probe_mb", "iters"):
        if base.get(k) is not None:
            out[k] = base[k]
    hop_names = sorted({h for g in gathered for h in (g.get("hops") or {})})
    hops = {}
    for h in hop_names:
        entries = [g["hops"][h] for g in gathered
                   if h in (g.get("hops") or {})]
        agg = {}
        for field in ("size", "gbps", "lat_us"):
            vals = sorted(float(e[field]) for e in entries
                          if e.get(field) is not None)
            if not vals:
                agg[field] = None
            else:
                v = vals[(len(vals) - 1) // 2]
                agg[field] = int(v) if field == "size" else _round6(v)
        hops[h] = agg
    out["hops"] = hops
    return out


def topology_summary(comm):
    """The topology facts the planner keys off, each a function of the
    communicator's construction arguments (the same on every rank):
    the JAX axis label (``mn_world``, or ``dcnxici``), flat or
    hierarchical, the size, the bucketing, and the split."""
    axis = comm.axis_name
    label = "x".join(axis) if isinstance(axis, (tuple, list)) else str(axis)
    summary = {"axis": label,
               "kind": "hierarchical" if comm.hierarchy is not None
               else "flat",
               "size": int(comm.size),
               "exchange": comm.exchange}
    if comm.hierarchy is not None:
        summary["inter"], summary["intra"] = (int(s)
                                              for s in comm._hier_sizes)
    return summary


def plan_fingerprint(plan):
    """The first 16 hex digits of the sha256 of the plan's canonical JSON
    (sorted keys, no whitespace, ``fingerprint`` left out)."""
    body = {k: v for k, v in plan.items() if k != "fingerprint"}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def derive_exchange_plan(measurements, topology):
    """Agreed measurements + topology summary -> the ``{bucket_mb,
    stripe_ratio, grad_dtype}`` plan, deterministic and byte-identical
    across ranks.

    * ``bucket_mb``: from the slowest measured hop's bandwidth and latency
      (:func:`derived_bucket_bytes`); ``None`` (keep the committed default)
      when no hop has both.
    * ``stripe_ratio``: hierarchical topologies only,
      ``B_dcn / (B_ici + B_dcn)`` when both hops were measured, else
      :data:`DEFAULT_STRIPE_RATIO`; ``None`` on a flat one.
    * ``grad_dtype``: ``{"ici": None, "dcn": "bfloat16"}`` when the
      measured inter-node bandwidth is under half the intra-node one.
    """
    notes = []
    hops = dict(measurements.get("hops") or {})
    measured = {h: v for h, v in hops.items()
                if (v or {}).get("gbps") is not None}

    bucket_mb = None
    if measured:
        slowest = min(sorted(measured), key=lambda h: measured[h]["gbps"])
        lat = measured[slowest].get("lat_us")
        if lat is not None:
            bucket_mb = _round6(
                derived_bucket_bytes(measured[slowest]["gbps"], lat,
                                     overhead_frac=OVERHEAD_FRAC)
                / (1 << 20))
            notes.append(f"bucket_mb from slowest measured hop "
                         f"'{slowest}' (bandwidth x latency / "
                         f"{OVERHEAD_FRAC})")
        else:
            notes.append(f"hop '{slowest}' has bandwidth but no latency "
                         f"sample (online trace): bucket_mb keeps the "
                         f"committed default {DEFAULT_BUCKET_MB} MB")
    else:
        notes.append(f"no measurable hop: bucket_mb keeps the committed "
                     f"default {DEFAULT_BUCKET_MB} MB")

    stripe_ratio = None
    grad_dtype = None
    if topology.get("kind") == "hierarchical":
        gi = (hops.get("ici") or {}).get("gbps")
        gd = (hops.get("dcn") or {}).get("gbps")
        if gi is not None and gd is not None:
            stripe_ratio = _round6(derived_stripe_ratio(gi, gd))
            notes.append("stripe_ratio = r* = B_dcn / (B_ici + B_dcn) "
                         "(docs/performance.md S10 finish-together split)")
            if gd < 0.5 * gi:
                grad_dtype = {"ici": None, "dcn": "bfloat16"}
                notes.append("B_dcn < B_ici/2: bfloat16 DCN crossing "
                             "(ICI stays lossless by design)")
        else:
            missing = "+".join(h for h in ("ici", "dcn")
                               if (hops.get(h) or {}).get("gbps") is None)
            stripe_ratio = _round6(DEFAULT_STRIPE_RATIO)
            notes.append(f"{missing} unmeasured: stripe_ratio falls back "
                         f"to DEFAULT_STRIPE_RATIO "
                         f"({DEFAULT_STRIPE_RATIO})")

    plan = {
        "version": PLAN_VERSION,
        "axis": topology.get("axis"),
        "topology": dict(topology),
        "bucket_mb": bucket_mb,
        "stripe_ratio": stripe_ratio,
        "grad_dtype": grad_dtype,
        "measurements": measurements,
        "derivation": {
            "formula": "r* = B_dcn / (B_ici + B_dcn)",
            "bucket_rule": f"bytes = bandwidth x latency / "
                           f"{OVERHEAD_FRAC}, clamped [1, 32] MB",
            "fallbacks": {"stripe_ratio": DEFAULT_STRIPE_RATIO,
                          "bucket_mb": DEFAULT_BUCKET_MB},
            "notes": notes,
        },
    }
    plan["fingerprint"] = plan_fingerprint(plan)
    return plan


def agree_exchange_plan(comm, measurement):
    """All-gather the per-rank measurements, reduce them, derive the plan
    here, and return rank 0's plan (broadcast): the plan every rank
    applies.  The local derivation should already be identical (a pure
    function of agreed inputs); where it is not, rank 0's plan wins, a
    ``RuntimeWarning`` names both fingerprints, and
    ``chainermn_tpu_autotune_plan_divergence_total`` counts it.  Rank 0
    records the plan (:func:`record_plan`).  Collective."""
    with observability.span("autotune/agree"):
        gathered = comm.allgather_obj(measurement)
        reduced = reduce_measurements(gathered)
        with observability.span("autotune/derive"):
            local = derive_exchange_plan(reduced, topology_summary(comm))
        plan = comm.bcast_obj(local, root=0)
    registry = observability.registry()
    if plan.get("fingerprint") != local.get("fingerprint"):
        registry.counter(
            "chainermn_tpu_autotune_plan_divergence_total",
            help="ranks whose locally derived plan differed from the "
                 "broadcast rank-0 plan (should be 0: the planner is a "
                 "pure function of agreed measurements)").inc(
            axis=str(plan.get("axis")))
        warnings.warn(
            f"autotune plan derivation diverged from rank 0 "
            f"(local {local.get('fingerprint')} != broadcast "
            f"{plan.get('fingerprint')}); executing rank 0's plan",
            RuntimeWarning, stacklevel=2)
    registry.gauge(
        "chainermn_tpu_autotune_plan_fingerprint",
        help="numeric prefix of the agreed exchange plan's fingerprint "
             "(identical on every rank of a healthy job)").set(
        float(int(plan["fingerprint"][:12], 16)),
        axis=str(plan.get("axis")))
    observability.instant(
        "autotune/plan",
        tags={"fingerprint": plan["fingerprint"],
              "bucket_mb": plan.get("bucket_mb"),
              "stripe_ratio": plan.get("stripe_ratio")})
    if comm.rank == 0:
        record_plan(plan)
    return plan


def record_plan(plan, path=None):
    """Write ``plan`` as JSON (sorted keys, indent 2): to ``path``, else to
    ``$CHAINERMN_TPU_AUTOTUNE_DIR/autotune_plan_<axis>.json`` (one file
    per axis label); without the variable nothing is written.  Returns
    the path written, or ``None``."""
    if path is None:
        out_dir = os.environ.get("CHAINERMN_TPU_AUTOTUNE_DIR", "").strip()
        if not out_dir:
            return None
        safe_axis = "".join(c if c.isalnum() or c in "-_" else "_"
                            for c in str(plan.get("axis", "world")))
        path = os.path.join(out_dir, f"autotune_plan_{safe_axis}.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(plan, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def retune_communicator(comm, mode="startup", events=None):
    """Measure, agree and apply: the communicator to train with (a
    re-tuned clone, or ``comm`` itself with the plan attached when the
    plan changes no knob the caller left free).  ``mode="online"``
    derives from tracer events (``events``, else the live tracer's ring)
    instead of the micro-bench.  Collective: every rank calls it with the
    same arguments."""
    if mode in (True, "startup"):
        measurement = measure_fabric(comm)
    elif mode == "online":
        if events is None:
            events = observability.tracer().events()
        measurement = online_measurement(comm, events)
    else:
        raise ValueError(
            f"autotune mode must be 'startup' (True) or 'online', "
            f"got {mode!r}")
    plan = agree_exchange_plan(comm, measurement)
    return comm.retuned(plan)
