"""Gradient packing and bucket planning.

The port of the pure parts of ``chainermn_tpu.communicators._memory_utility``:
:func:`tree_pack`/:func:`tree_unpack`, :func:`plan_buckets`,
:func:`hop_schedule` (its ``"hierarchical"``, ``"striped"`` and ``"moe"``
modes),
the striped split (:func:`stripe_plan`, :func:`derived_stripe_ratio`,
:func:`stripe_plan_from_measurement`), the measured bucket bound
(:func:`derived_bucket_bytes`), :func:`pad_to_multiple`,
:func:`resolve_grad_dtype`, :func:`pack_params`/:func:`unpack_params`,
the sharded update's flat layout (:func:`padded_length`,
:func:`chunk_bounds`, :func:`chain_chunk_index`), the quantized wire
(:func:`quantize_symmetric` and its inverse, the error-feedback residual,
:func:`dequantize_sum`, the MoE crossing's per-segment
:func:`quantize_symmetric_segments`) and the wire-byte accounting
(:func:`exchanged_bytes`, :func:`hierarchical_exchanged_bytes`,
:func:`striped_exchanged_bytes`, :func:`quantized_hop_bytes`,
:func:`moe_dispatch_exchanged_bytes`).
A "tree" here is a sequence of tensors (the port's gradients are
``Parameter.grad`` tensors, not a pytree).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["pack_params", "unpack_params", "tree_pack", "tree_unpack",
           "plan_buckets", "hop_schedule", "pad_to_multiple",
           "resolve_grad_dtype", "is_quantized_dtype", "QUANTIZED_DTYPES",
           "quantize_symmetric", "dequantize_symmetric",
           "quantize_symmetric_segments", "quantization_residual", "quantize_with_feedback",
           "dequantize_sum", "exchanged_bytes",
           "hierarchical_exchanged_bytes", "striped_exchanged_bytes",
           "quantized_hop_bytes", "moe_dispatch_exchanged_bytes", "padded_length", "chunk_bounds",
           "chain_chunk_index", "stripe_plan",
           "derived_stripe_ratio", "stripe_plan_from_measurement",
           "derived_bucket_bytes", "DEFAULT_BUCKET_MB", "DEFAULT_STRIPE_RATIO"]

#: default bucket bound (MB) for the bucketed exchange, as in the JAX
#: package (``CHAINERMN_TPU_BUCKET_MB`` overrides)
DEFAULT_BUCKET_MB = 4.0

#: the stripe ratio used when no fabric measurement exists (the JAX
#: package's fallback): the 1:3 DCN:ICI seed ratio.  The right value is
#: the slow fabric's share of the aggregate bandwidth,
#: :func:`derived_stripe_ratio`; ``CHAINERMN_TPU_STRIPE_RATIO`` and
#: ``create_communicator(stripe_ratio=)`` pin it by hand
DEFAULT_STRIPE_RATIO = 0.25

#: the quantized wire names, mapped to the largest magnitude each can
#: represent (the symmetric scale's target).  int8 uses +-127 (-128 is
#: never emitted: a symmetric codebook keeps Q(-v) == -Q(v)); e4m3 is the
#: OCP finite-only ``e4m3fn`` variant (max 448), e5m2 has max 57344.
QUANTIZED_DTYPES = {"int8": 127.0, "float8_e4m3": 448.0,
                    "float8_e5m2": 57344.0}

#: the names :func:`resolve_grad_dtype` maps onto the quantized torch
#: dtypes
_QUANTIZED_TORCH = {"int8": torch.int8,
                    "float8_e4m3": torch.float8_e4m3fn,
                    "float8_e4m3fn": torch.float8_e4m3fn,
                    "float8_e5m2": torch.float8_e5m2}
_QUANT_KEY = {torch.int8: "int8", torch.float8_e4m3fn: "float8_e4m3",
              torch.float8_e5m2: "float8_e5m2"}


def tree_pack(tensors, dtype=None):
    """Flatten a sequence of tensors into ``(flat, spec)``: one 1-D tensor
    (in ``dtype``, else the tensors' own) and what :func:`tree_unpack`
    needs to cut it back."""
    tensors = list(tensors)
    spec = ([tuple(x.shape) for x in tensors], [x.dtype for x in tensors])
    if not tensors:
        return torch.zeros((0,), dtype=dtype or torch.float32), spec
    flat = torch.cat([x.reshape(-1).to(dtype or x.dtype) for x in tensors])
    return flat, spec


def tree_unpack(flat, spec):
    """The tensors :func:`tree_pack` packed, as views of ``flat`` cast
    back to their dtypes."""
    shapes, dtypes = spec
    out, offset = [], 0
    for shape, dt in zip(shapes, dtypes):
        n = int(np.prod(shape))
        out.append(flat[offset:offset + n].reshape(shape).to(dt))
        offset += n
    return out


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size() \
        if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize


def plan_buckets(shapes, dtypes, bucket_bytes):
    """Partition leaves into size-bounded buckets of leaf INDICES.

    Deterministic pure function of the arguments (identical on every
    rank, which the per-bucket collectives rely on).  Buckets are emitted
    in REVERSE leaf order; a bucket never exceeds ``bucket_bytes`` unless
    a single leaf does, and never mixes dtypes."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    buckets = []
    current = []
    current_bytes = 0
    current_dtype = None
    for i in reversed(range(len(shapes))):
        dt = dtypes[i]
        nbytes = int(np.prod(shapes[i])) * _itemsize(dt)
        if current and (current_bytes + nbytes > bucket_bytes
                        or dt != current_dtype):
            buckets.append(current)
            current, current_bytes = [], 0
        current.append(i)
        current_bytes += nbytes
        current_dtype = dt
    if current:
        buckets.append(current)
    return buckets


def hop_schedule(n_buckets, mode="hierarchical"):
    """The emission order of the two-level exchanges: ``(op, bucket)``
    pairs that the exchange follows literally, buckets in plan order.
    Every rank emits the same order, which keeps the collectives of the
    groups from deadlocking each other.

    ``"hierarchical"``: per bucket ``"ici_reduce_scatter"`` (fast hop,
    the whole bucket), then ``"dcn_exchange"`` (slow hop, the ``1/intra``
    chunk); after every bucket's slow hop, the ``"ici_all_gather"``s.

    ``"striped"``: each bucket splits (:func:`stripe_plan`) into an
    ICI-path slice (fast-hop-major: reduce-scatter over the intra-node
    group, the chunk's exchange over the inter-node group, all-gather
    over intra) and a DCN-path slice (the transposed chain, slow hop
    first).  Per bucket ``dcn_path_scatter``, ``ici_path_scatter``,
    ``dcn_path_exchange``, ``ici_path_exchange``; then per bucket the
    epilogue ``dcn_path_gather``, ``ici_path_gather``.  The slow path's
    op leads each phase of its bucket, each path keeps its dataflow
    order, and both paths' scatters and exchanges of every bucket come
    before any gather.

    ``"moe"``: the two-stage token exchange of ``parallel.moe``, one
    "bucket" per MoE layer's dispatch buffer.  Per bucket
    ``"ici_dispatch"`` (fast hop: tokens regroup by destination slot
    within the node, so tokens whose expert is on the node finish here),
    then ``"dcn_dispatch"`` (slow hop: only the off-node remainder
    crosses); then per bucket the combine, the transposed reverse with
    the slow hop first: ``"dcn_combine"``, ``"ici_combine"``.  The two
    stages act on disjoint buffer dimensions, so the order is a schedule
    choice with the same result."""
    if n_buckets < 0:
        raise ValueError(f"n_buckets must be >= 0, got {n_buckets}")
    if mode not in ("hierarchical", "striped", "moe"):
        raise ValueError(f"unknown hop_schedule mode {mode!r}")
    schedule = []
    if mode == "moe":
        for b in range(n_buckets):
            schedule.append(("ici_dispatch", b))
            schedule.append(("dcn_dispatch", b))
        for b in range(n_buckets):
            schedule.append(("dcn_combine", b))
            schedule.append(("ici_combine", b))
        return schedule
    if mode == "striped":
        for b in range(n_buckets):
            schedule.append(("dcn_path_scatter", b))
            schedule.append(("ici_path_scatter", b))
            schedule.append(("dcn_path_exchange", b))
            schedule.append(("ici_path_exchange", b))
        for b in range(n_buckets):
            schedule.append(("dcn_path_gather", b))
            schedule.append(("ici_path_gather", b))
        return schedule
    for b in range(n_buckets):
        schedule.append(("ici_reduce_scatter", b))
        schedule.append(("dcn_exchange", b))
    for b in range(n_buckets):
        schedule.append(("ici_all_gather", b))
    return schedule


def stripe_plan(n_elems, ratio):
    """The striped exchange's split of a bucket's flat payload:
    ``(ici_elems, dcn_elems)``, the ICI-path slice at ``flat[:ici_elems]``
    and the DCN-path slice at ``flat[ici_elems:]``.  A pure function of
    its arguments, so every rank splits alike: every element in one
    slice, both contiguous, ``dcn_elems == round(ratio * n_elems)``;
    ratio 0 is the hierarchical exchange, ratio 1 routes the whole
    payload over the slow-hop-major path."""
    if not 0.0 <= ratio <= 1.0:
        raise ValueError(f"stripe ratio must be in [0, 1], got {ratio}")
    if n_elems < 0:
        raise ValueError(f"n_elems must be >= 0, got {n_elems}")
    dcn_elems = int(round(ratio * n_elems))
    return n_elems - dcn_elems, dcn_elems


def derived_stripe_ratio(b_ici, b_dcn):
    """The DCN share at which both paths of the striped exchange finish
    together, from measured per-hop bandwidths (any one unit): ``b_dcn
    / (b_ici + b_dcn)``, clamped to the open interval (0, 1), so that a
    derived plan never collapses to one path.  0.25 at the 1:3 seed
    ratio.  A non-finite or non-positive bandwidth raises (an
    unmeasured hop falls back to :data:`DEFAULT_STRIPE_RATIO` at the
    call site)."""
    b_ici, b_dcn = float(b_ici), float(b_dcn)
    if not (np.isfinite(b_ici) and np.isfinite(b_dcn)) \
            or b_ici <= 0 or b_dcn <= 0:
        raise ValueError(
            f"derived_stripe_ratio needs positive finite per-hop "
            f"bandwidths, got b_ici={b_ici!r} b_dcn={b_dcn!r}; an "
            f"unmeasured hop falls back to DEFAULT_STRIPE_RATIO "
            f"explicitly at the call site")
    ratio = b_dcn / (b_ici + b_dcn)
    eps = 1e-6
    return min(1.0 - eps, max(eps, ratio))


def stripe_plan_from_measurement(n_elems, b_ici, b_dcn):
    """:func:`stripe_plan` at the ratio :func:`derived_stripe_ratio`
    derives from measured per-hop bandwidths."""
    return stripe_plan(n_elems, derived_stripe_ratio(b_ici, b_dcn))


def derived_bucket_bytes(gbps, lat_us, overhead_frac=0.125,
                         floor_mb=1.0, cap_mb=32.0):
    """The bucket bound (bytes) from a measured hop's bandwidth (GB/s)
    and launch latency (µs): the smallest bucket whose wire time keeps
    one collective's launch overhead under ``overhead_frac`` of it,
    ``bandwidth x latency / overhead_frac``, clamped to [``floor_mb``,
    ``cap_mb``] MiB and rounded to 2 significant digits (the JAX
    package's rule, bit for bit).  A non-finite or non-positive
    bandwidth, or a negative latency, raises."""
    gbps, lat_us = float(gbps), float(lat_us)
    if not (np.isfinite(gbps) and np.isfinite(lat_us)) \
            or gbps <= 0 or lat_us < 0:
        raise ValueError(
            f"derived_bucket_bytes needs a positive finite bandwidth "
            f"and a non-negative latency, got gbps={gbps!r} "
            f"lat_us={lat_us!r}")
    raw = gbps * 1e9 * (lat_us * 1e-6) / float(overhead_frac)
    mb = min(float(cap_mb), max(float(floor_mb), raw / (1 << 20)))
    if mb > 0:
        digits = 1 - int(math.floor(math.log10(abs(mb))))
        mb = round(mb, digits)
    return int(round(min(float(cap_mb), max(float(floor_mb), mb))
                     * (1 << 20)))


def pad_to_multiple(flat, multiple):
    """Zero-pad a 1-D vector up to the next multiple of ``multiple`` (a
    reduce-scatter needs its length divisible by the group's size).
    Returns ``(padded, true_length)``."""
    n = flat.shape[0]
    n_pad = -(-n // multiple) * multiple
    if n_pad == n:
        return flat, n
    return torch.nn.functional.pad(flat, (0, n_pad - n)), n


def resolve_grad_dtype(dtype):
    """``allreduce_grad_dtype`` entry as a ``torch.dtype``: a torch dtype,
    or a name (``"bfloat16"``, ``"float16"``, ``"float32"``, the quantized
    wire names: ``"int8"``, ``"float8_e4m3"`` and ``"float8_e4m3fn"`` give
    ``torch.float8_e4m3fn``, ``"float8_e5m2"`` gives
    ``torch.float8_e5m2``).  ``None`` passes through (lossless)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = str(np.dtype(dtype)) if not isinstance(dtype, str) else dtype
    name = name.removeprefix("torch.")
    if name in _QUANTIZED_TORCH:
        return _QUANTIZED_TORCH[name]
    resolved = getattr(torch, name, None)
    if not isinstance(resolved, torch.dtype):
        raise ValueError(f"unknown allreduce_grad_dtype {dtype!r}")
    return resolved


def _quant_key(dtype):
    """The :data:`QUANTIZED_DTYPES` key of a dtype or dtype name, or
    ``None`` (unknown names included)."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return _QUANT_KEY.get(dtype)
    name = str(dtype).removeprefix("torch.")
    name = {"float8_e4m3fn": "float8_e4m3"}.get(name, name)
    return name if name in QUANTIZED_DTYPES else None


def is_quantized_dtype(dtype):
    """True for the int8/fp8 wire dtypes the quantized exchange owns
    (bf16/fp16 are plain casts: they ride the cast path, not the scale
    and residual machinery)."""
    return _quant_key(dtype) is not None


def quantize_symmetric(v, wire_dtype):
    """Per-bucket symmetric quantization: ``(q, scale)`` with ``q ~ v /
    scale`` in ``wire_dtype`` and ``scale = absmax(v) / qmax`` (a 0-d
    fp32 tensor on ``v``'s device).

    The JAX function's contract, operation for operation, so that both
    give the same bits on the same fp32 input: deterministic (every rank
    quantizing the same buffer gets the same codebook); an all-zero or
    empty buffer gives zeros with scale 1; the scale is taken over the
    finite values only, ``+-inf`` saturates to ``+-qmax`` and NaN encodes
    as 0.  The clip comes before the cast: ``.to(float8_e4m3fn)`` does
    not saturate.  int8 rounds half to even, as ``jnp.round``.  ``qmax``
    divides as a tensor on ``v``'s device: a CUDA division by a Python
    number multiplies by its reciprocal, which rounds otherwise than the
    CPU's (and XLA's) division for 448 and 57344."""
    wire = resolve_grad_dtype(wire_dtype)
    v = v.float()
    qmax = torch.full((), QUANTIZED_DTYPES[_quant_key(wire)],
                      dtype=torch.float32, device=v.device)
    zero = torch.zeros((), dtype=torch.float32, device=v.device)
    absmax = torch.where(torch.isfinite(v), v, zero).abs().max() \
        if v.numel() else zero
    scale = torch.where(absmax > 0, absmax / qmax, 1.0)
    scaled = torch.clamp(torch.where(torch.isnan(v), zero, v) / scale,
                         -qmax, qmax)
    if wire == torch.int8:
        return torch.round(scaled).to(wire), scale
    return scaled.to(wire), scale


def dequantize_symmetric(q, scale):
    """The inverse of :func:`quantize_symmetric`: ``q * scale`` in fp32."""
    return q.float() * scale


def quantize_symmetric_segments(v, wire_dtype):
    """Per-segment symmetric quantization along the leading axis: one
    :func:`quantize_symmetric` per ``v[i]`` (the JAX function maps it
    over the axis), so each destination block of the MoE crossing takes
    its own scale and a hot block cannot flatten a quiet one's
    codewords.  Returns ``(q [S, ...], scales [S])``; bitwise the JAX
    function's, segment by segment."""
    pairs = [quantize_symmetric(seg, wire_dtype) for seg in v.unbind(0)]
    return (torch.stack([q for q, _ in pairs]),
            torch.stack([s for _, s in pairs]))


def quantization_residual(v, q, scale):
    """The error-feedback residual ``v - Q(v)``, 0 wherever ``v`` (or the
    difference) is not finite: carrying inf or NaN forward would poison
    every later step."""
    v = v.float()
    r = v - dequantize_symmetric(q, scale)
    return torch.where(torch.isfinite(v) & torch.isfinite(r), r,
                       torch.zeros((), dtype=torch.float32,
                                   device=r.device))


def quantize_with_feedback(v, residual, wire_dtype):
    """The quantization prologue of every compressed hop: ``v`` in fp32
    plus the carried ``residual`` (``None`` without error feedback),
    quantized; returns ``(q, scale, new_residual)``, the last ``v -
    Q(v)`` (``None`` without feedback)."""
    v = v.float()
    if residual is not None:
        v = v + residual
    q, scale = quantize_symmetric(v, wire_dtype)
    new_residual = quantization_residual(v, q, scale) \
        if residual is not None else None
    return q, scale, new_residual


def dequantize_sum(q_stacked, scales):
    """The sum of per-rank dequantized buffers: ``q_stacked`` the
    gathered ``(size, n)`` codewords, ``scales`` the ``(size,)`` scales;
    each rank's codewords decode with its own scale before the fp32
    accumulation.  The rows are added one after another, in rank order,
    on every device (a reduction kernel may order its additions
    otherwise on the card than on the CPU)."""
    rows = dequantize_symmetric(q_stacked, scales[:, None]).unbind(0)
    return functools.reduce(torch.add, rows)


def exchanged_bytes(n_bytes, size, collective):
    """Per-replica wire bytes of one collective on an ``n_bytes`` full
    buffer over ``size`` ranks, ring decomposition: ``psum`` (allreduce)
    ``2 n (size-1)/size``; ``reduce_scatter``, ``all_gather`` and
    ``all_to_all`` ``n (size-1)/size``."""
    if size <= 1:
        return 0
    frac = (size - 1) / size
    if collective == "psum":
        return int(2 * n_bytes * frac)
    if collective in ("reduce_scatter", "all_gather", "all_to_all"):
        return int(n_bytes * frac)
    raise ValueError(f"unknown collective {collective!r}")


def hierarchical_exchanged_bytes(n_bytes, intra_size, inter_size,
                                 collective="psum", dcn_n_bytes=None):
    """Per-replica wire bytes of the two-level exchange on an ``n_bytes``
    full buffer, by hop: ``{"ici": ..., "dcn": ...}`` (ICI is the
    intra-node hop, DCN the inter-node one).  The slow hop sees only the
    ``1/intra`` chunk the fast reduce-scatter leaves (``dcn_n_bytes``
    overrides the chunk's bytes for a per-hop wire dtype).  ``"psum"``:
    reduce-scatter and all-gather over ICI, a chunk allreduce over DCN;
    ``"reduce_scatter"``/``"all_gather"``: one crossing per hop.  With
    one dtype the hops sum to the flat ring figure over ``intra *
    inter`` ranks: the hierarchy moves bytes onto the fast wire, it adds
    none."""
    if intra_size < 1 or inter_size < 1:
        raise ValueError(
            f"intra_size/inter_size must be >= 1, got "
            f"{intra_size}/{inter_size}")
    if n_bytes % intra_size:
        raise ValueError(
            f"n_bytes={n_bytes} not divisible by intra_size={intra_size} "
            f"(pad_to_multiple the bucket first: the accounting must "
            f"match the buffer on the wire)")
    chunk = n_bytes // intra_size if dcn_n_bytes is None else dcn_n_bytes
    ici = exchanged_bytes(n_bytes, intra_size, "reduce_scatter")
    dcn = exchanged_bytes(chunk, inter_size, "reduce_scatter")
    if collective == "psum":
        return {"ici": 2 * ici, "dcn": 2 * dcn}
    if collective in ("reduce_scatter", "all_gather"):
        return {"ici": ici, "dcn": dcn}
    raise ValueError(f"unknown collective {collective!r}")


def striped_exchanged_bytes(n_bytes, intra_size, inter_size, ratio,
                            itemsize=4, dcn_itemsize=None):
    """Per-replica wire bytes of the striped exchange on an ``n_bytes``
    buffer, by path and by fabric: ``{"ici_path": {"ici", "dcn",
    "total"}, "dcn_path": {"ici", "dcn", "total"}}``.  The ICI-path slice
    (share ``1 - ratio``) is priced by :func:`hierarchical_exchanged_bytes`
    as it is; the DCN-path slice (share ``ratio``) by the same formula
    with the hops transposed.  Each slice pads to its ring multiple, as
    the wire does.  The path totals sum to the flat allreduce's figure
    over ``intra * inter`` ranks, and the DCN path's share of it is the
    ratio (exactly, where the split divides cleanly).
    ``dcn_itemsize`` prices the DCN-fabric crossings at another wire
    dtype; the DCN-path chunk's ICI crossing stays fp32 (the exchange
    upcasts it before the fast hop)."""
    elems = n_bytes // itemsize
    if elems * itemsize != n_bytes:
        raise ValueError(
            f"n_bytes={n_bytes} is not a multiple of itemsize={itemsize}")
    ici_elems, dcn_elems = stripe_plan(elems, ratio)
    n_i = -(-ici_elems // intra_size) * intra_size * itemsize
    n_d = -(-dcn_elems // inter_size) * inter_size * itemsize
    dcn_scale = (dcn_itemsize / itemsize) if dcn_itemsize else 1.0
    a = hierarchical_exchanged_bytes(
        n_i, intra_size, inter_size, "psum",
        dcn_n_bytes=int(n_i // intra_size * dcn_scale)
        if dcn_itemsize else None) if n_i else {"ici": 0, "dcn": 0}
    # the transposed chain: its "intra" ring is the DCN axis, its chunk
    # crossing rides ICI at fp32; relabel the hops back to fabrics
    b = hierarchical_exchanged_bytes(
        int(n_d * dcn_scale), inter_size, intra_size, "psum",
        dcn_n_bytes=n_d // itemsize // inter_size * 4) \
        if n_d else {"ici": 0, "dcn": 0}
    ici_path = {"ici": a["ici"], "dcn": a["dcn"]}
    dcn_path = {"dcn": b["ici"], "ici": b["dcn"]}
    for p in (ici_path, dcn_path):
        p["total"] = p["ici"] + p["dcn"]
    return {"ici_path": ici_path, "dcn_path": dcn_path}


def quantized_hop_bytes(chunk_elems, size, collective, wire_dtype):
    """Per-replica wire bytes of the quantized slow hop on a
    ``chunk_elems`` chunk over ``size`` ranks at the wire's itemsize:
    ``"psum"`` (the allreduce's hop, an all-gather of the codewords and a
    dequantize-sum) ``chunk (size-1)``; ``"reduce_scatter"`` (the sharded
    update's hop, an all-to-all of the codeword segments) ``chunk
    (size-1)/size``.  The per-bucket scales are not counted."""
    if size <= 1:
        return 0
    n_bytes = chunk_elems * resolve_grad_dtype(wire_dtype).itemsize
    if collective == "psum":
        return int(n_bytes * (size - 1))
    if collective == "reduce_scatter":
        return int(n_bytes * (size - 1) / size)
    raise ValueError(f"unknown quantized collective {collective!r}")


def moe_dispatch_exchanged_bytes(n_bytes, intra_size, inter_size,
                                 two_stage=True, dcn_n_bytes=None):
    """Per-replica wire bytes of one MoE layer's token exchange, the
    dispatch and combine round trip on an ``n_bytes`` capacity buffer
    (``[E, C, D]`` at the wire dtype).  Two-stage: an all-to-all over the
    intra-node group each way (``n (intra-1)/intra``) and one over the
    inter-node group each way carrying the off-node remainder (``n
    (inter-1)/inter``; ``dcn_n_bytes`` prices a compressed slow crossing,
    the per-segment scales left out): ``{"ici", "dcn"}``.  Flat: one
    all-to-all each way over all ``intra * inter`` ranks:
    ``{"world"}``."""
    if two_stage:
        ici = exchanged_bytes(n_bytes, intra_size, "all_to_all")
        dcn = exchanged_bytes(
            n_bytes if dcn_n_bytes is None else dcn_n_bytes,
            inter_size, "all_to_all")
        return {"ici": 2 * ici, "dcn": 2 * dcn}
    return {"world": 2 * exchanged_bytes(n_bytes, intra_size * inter_size,
                                         "all_to_all")}


def pack_params(params, attr="grad", dtype=None):
    """Pack ``param.<attr>`` of a parameter list into one flat vector:
    ``(flat, spec)``."""
    return tree_pack([getattr(p, attr) for p in params], dtype=dtype)


def unpack_params(params, flat, spec, attr="grad"):
    for p, a in zip(params, tree_unpack(flat, spec)):
        setattr(p, attr, a)


def padded_length(n, size):
    """The sharded update's flat length: ``n`` rounded up to a multiple
    of ``size`` (``n_pad = ceil(n / size) * size``, the JAX layout)."""
    return -(-n // size) * size


def chunk_bounds(n_pad, size, rank):
    """``[start, stop)`` of the flat vector that ``rank`` owns:
    ``[rank * n_pad / size, (rank + 1) * n_pad / size)``."""
    chunk = n_pad // size
    return rank * chunk, (rank + 1) * chunk


def chain_chunk_index(ici_index, dcn_index, dcn_size):
    """The chunk of the flat vector that the hop chain leaves on the rank
    at ``(dcn_index, ici_index)``: the intra-node reduce-scatter keeps
    chunk ``ici_index`` of ``intra``, the inter-node one sub-chunk
    ``dcn_index`` of that, so the chunks are fast-hop-major: ``ici_index *
    dcn_size + dcn_index``.  At a 2 x 2 split ranks 0, 1, 2, 3 own chunks
    0, 2, 1, 3."""
    return ici_index * dcn_size + dcn_index

