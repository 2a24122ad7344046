"""Communicator over a ``torch.distributed`` process group.

The port of ``chainermn_tpu.communicators.mesh_communicator``.  There a
communicator is a device mesh driven by one controller and the gradient
mean is a collective inside the compiled step; here, as in the
reference, it is a process group with one process per device, and every
collective is a ``torch.distributed`` call on this rank's tensor: NCCL for
CUDA tensors, gloo for the CPU.

The gradient exchange (:meth:`MeshCommunicator.multi_node_mean_grad`) is
the JAX ``grad_transform``, run eagerly after backward.  The leaves are
the parameters in sorted path order, as the JAX package flattens its
params tree, so that ``batch_collectives`` ``False`` (one collective per
leaf), ``True`` (one flat bucket) and ``"bucketed"`` (``bucket_mb``-bounded
buckets, :func:`plan_buckets`) plan the same buckets as there.  Per
bucket it is one of:

* the plain path: cast to ``allreduce_grad_dtype``, pack,
  ``all_reduce(SUM)``, divide by ``size`` (the JAX ``pmean`` is a sum,
  then a divide), unpack, cast back.  Packing changes the schedule, not
  the math: the three ``batch_collectives`` give bitwise-equal gradients;
* the quantized path (an int8/fp8 wire on a flat communicator): quantize
  the bucket (plus the carried error-feedback residual) with one
  symmetric scale, all-gather the codewords and the scales, and sum each
  rank's codewords decoded with its own scale, then divide;
* the two-level path of a hierarchical communicator (``hierarchical``,
  ``two_dimensional``, or any fused name with ``intra_size``/
  ``inter_size``): the ranks form ``inter`` nodes of ``intra`` ranks
  (rank ``r`` at ``(dcn_index, ici_index) = divmod(r, intra)``, the JAX
  mesh's ``(dcn, ici)`` layout), with one intra-node subgroup per node
  (the JAX ICI axis) and one inter-node subgroup per intra-node position
  (the DCN axis).  Following :func:`hop_schedule` literally: pad the
  bucket to a multiple of ``intra``, reduce-scatter it over the
  intra-node group, exchange the ``1/intra`` chunk over the inter-node
  group (cast to ``dcn_grad_dtype`` and allreduced, or quantized and
  all-gathered), divide by ``size`` once, and after every bucket's slow
  hop all-gather each chunk over the intra-node group.  The inter-node
  hop carries ``1/intra`` of the bytes.

The sharded update (``zero_sharding`` and ``exchange="reduce_scatter"``)
exchanges one flat padded vector instead: :meth:`MeshCommunicator.
reduce_scatter_grad` reduce-scatters it along the hop chain, fast hop
first (over the intra-node group, then the ``1/intra`` chunk over the
inter-node group; a quantized slow hop is an all-to-all of the codeword
segments, an all-gather of the scales and a dequantize-sum), so each rank
keeps chunk :attr:`MeshCommunicator.chunk_index` (fast-hop-major, not
``rank``); :meth:`MeshCommunicator.allgather_flat` rebuilds the vector
along the reverse chain.  The double-buffered exchange launches its
exchange to run under the next step (:meth:`MeshCommunicator.
allreduce_grad_async`, ``reduce_scatter_grad(async_op=True)``): a single
collective on the backend's stream, a chain of them on a side stream of
the card.

The striped exchange (a hierarchical communicator with a nonzero
``stripe_ratio``) follows ``hop_schedule(k, mode="striped")``: each
bucket splits at :func:`stripe_plan` into an ICI-path slice, exchanged as
above (fast hop first), and a DCN-path slice, exchanged by the
transposed chain (reduce-scatter over the inter-node group in
``dcn_grad_dtype``, the chunk allreduced over the intra-node group in
fp32, all-gather over inter; a quantized ``dcn_grad_dtype`` quantizes
the slice itself with its own residual, all-gathers the codewords and
scales over inter, and sums over intra in fp32).  The DCN path runs on
a second pair of subgroups, so that neither path's collectives queue
behind the other's on one communicator, and on the card each path's
chain runs on its own side stream.  The sharded update's striped layout
is a ``{"ici", "dcn"}`` pair of flat vectors: the ICI-path slice's
chunks land fast-hop-major (:attr:`MeshCommunicator.chunk_index`), the
DCN-path slice's slow-hop-major (:attr:`MeshCommunicator.
striped_chunk_index`).

A quantized exchange takes and returns the error-feedback residual (the
JAX ``transform(grads, residual)``): the residual is added before
quantizing, and the new one, ``v - Q(v)`` per element, is what the
caller carries to the next step.  ``calls`` counts each collective by
hop (``ici_reduce_scatter``, ``dcn_allreduce``, ``dcn_allgather_q``,
``dcn_allgather_scale``, ``ici_allgather``, ...), and each op of the
striped schedule by its name (``dcn_path_scatter``, ...).  With tracing
on (``CHAINERMN_TPU_TRACE``) the communicator stamps its rank into the
tracer; under ``full`` each bucket's hop runs inside
``record_function("train.grad_exchange.bucket{k}.{op}")`` with the JAX
package's op names.

The self-tuned knobs (``autotune=``, :mod:`._autotune`) reach a
communicator through :meth:`MeshCommunicator.retuned`, which fills only
the knobs the caller did not set by hand (``_hand_knobs``, recorded at
construction and carried across clones and :meth:`MeshCommunicator.split`).

The object calls (``send_obj``, ``recv_obj``, ``bcast_obj``,
``allgather_obj``, ``gather_obj``) go over the process group's object
collectives.  :meth:`MeshCommunicator._host_channel` gives the host
channel (:mod:`._host_channel`, over the job's ``torch.distributed``
store) of a communicator over the default world of more than one process:
the control plane that recovery (the abort flag, the generation) and the
elastic membership use.  The object calls ride it only where a
communicator asks for it: :class:`ElasticMeshCommunicator`'s members-only
channel, and the fault-injection wrapper, whose transport faults act on
that channel.

:class:`ElasticMeshCommunicator` is a communicator over the live members
of an elastic job: each membership epoch gets a default process group of
its own, built over a prefix of the job's store, so that no call of it
touches a departed rank.
"""

from __future__ import annotations

import collections
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parameter import is_lazy

from .. import observability
from .._device import resolve_device
from ._communication_utility import (backend_for, gather_hosts,
                                     hierarchy_groups, init_ranks,
                                     initialize_distributed,
                                     resolve_hierarchy)
from ._memory_utility import (DEFAULT_BUCKET_MB, chain_chunk_index,
                              dequantize_sum, hop_schedule,
                              is_quantized_dtype, pad_to_multiple,
                              plan_buckets, quantize_with_feedback,
                              resolve_grad_dtype, stripe_plan, tree_pack,
                              tree_unpack)
from ._host_channel import HostChannel, get_host_channel, reset_host_channel
from .communicator_base import CommunicatorBase

__all__ = ["MeshCommunicator", "ElasticMeshCommunicator", "PendingExchange",
           "STRIPED_OP_PATH"]

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
               "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}

#: wire dtypes sent as their bytes: gloo, and NCCL before 2.24, may
#: refuse fp8 tensors; a gather or an all-to-all only copies bytes
_BYTE_WIRE = (torch.float8_e4m3fn, torch.float8_e5m2)

#: the striped exchange's op names (the JAX package's scope names) by the
#: path whose chain runs them
STRIPED_OP_PATH = {
    "mn_stripe_pack_scatter_dcn": "dcn", "mn_stripe_allreduce_ici": "dcn",
    "mn_stripe_dequant_psum_ici": "dcn", "mn_stripe_ag_dcn": "dcn",
    "mn_stripe_zero_rs_dcn": "dcn", "mn_stripe_zero_ag_dcn": "dcn",
    "mn_stripe_rs_ici": "ici", "mn_stripe_allreduce_dcn": "ici",
    "mn_stripe_quantized_chunk": "ici", "mn_stripe_ag_ici": "ici",
    "mn_stripe_zero_rs_ici": "ici", "mn_stripe_zero_ag_ici": "ici"}

_warned_inert_ef = False


def _bucket_scope(name, bucket):
    """The range of one bucket's hop, ``train.grad_exchange.bucket{k}.
    {name}`` (the JAX ``_bucket_scope``'s name, so a profiler capture
    attributes device time to the span tracer's vocabulary):
    ``observability.scope``."""
    return observability.scope(f"train.grad_exchange.bucket{bucket}.{name}")


def _resolve_stripe(ratio, hierarchical, hand_knobs):
    """The constructor's ``stripe_ratio`` (the JAX rules): the
    ``CHAINERMN_TPU_STRIPE_RATIO`` variable is read only where it can
    matter (a hierarchical communicator) and then counts as set by hand;
    the ratio must lie in [0, 1], and a nonzero one needs a hierarchical
    communicator (a flat one has one fabric)."""
    if ratio is None and hierarchical:
        raw = os.environ.get("CHAINERMN_TPU_STRIPE_RATIO", "").strip()
        if raw:
            ratio = float(raw)
            hand_knobs["stripe_ratio"] = True
    if ratio is None:
        return 0.0
    ratio = float(ratio)
    if not 0.0 <= ratio <= 1.0:
        raise ValueError(f"stripe_ratio must be in [0, 1], got {ratio}")
    if ratio > 0 and not hierarchical:
        raise ValueError(
            "stripe_ratio needs a hierarchical communicator "
            "(name='hierarchical'/'two_dimensional' or an "
            "intra_size/inter_size split): a flat mesh has one "
            "fabric, there is nothing to stripe across")
    return ratio


def _warn_inert_error_feedback():
    """A quantized exchange ran without a residual on a communicator
    with error feedback on: the quantization error of that call is
    dropped.  Once per process."""
    global _warned_inert_ef
    if _warned_inert_ef:
        return
    _warned_inert_ef = True
    warnings.warn(
        "quantized gradient exchange called without a residual while "
        "error_feedback=True: the quantization error is being discarded "
        "(error feedback is inert on this call path).  Pass "
        "error_feedback=False at communicator construction to make the "
        "ablation explicit, or use the multi-node optimizer, which "
        "threads the residual.", UserWarning, stacklevel=3)


def _compress_disabled():
    """``CHAINERMN_TPU_COMPRESS=off``: quantized wires fall back to
    lossless (cast wires are untouched)."""
    return os.environ.get("CHAINERMN_TPU_COMPRESS", "") \
        .strip().lower() in ("off", "0", "none")


def _wire_dtypes(dtype, hierarchical):
    """``(allreduce_grad_dtype, dcn_grad_dtype)`` of the constructor's
    ``allreduce_grad_dtype``, the JAX constructor's rules: a
    ``{"ici": .., "dcn": ..}`` dict sets each hop (a hierarchical
    communicator only; a quantized ICI hop is refused); on a hierarchical
    communicator a scalar cast dtype compresses both hops and a scalar
    quantized one the inter-node hop only."""
    if isinstance(dtype, dict):
        if not hierarchical:
            raise ValueError(
                "per-hop allreduce_grad_dtype={'ici': ..., 'dcn': ...} "
                "needs a hierarchical communicator "
                "(name='hierarchical'/'two_dimensional' or an "
                "intra_size/inter_size split)")
        unknown = set(dtype) - {"ici", "dcn"}
        if unknown:
            raise ValueError(f"unknown per-hop dtype keys {sorted(unknown)} "
                             f"(hops are 'ici' and 'dcn')")
        if is_quantized_dtype(dtype.get("ici")):
            raise ValueError(
                f"quantized ici dtype {dtype.get('ici')!r}: the ICI hop is "
                f"lossless by design — int8/fp8 compression is a "
                f"slow-hop (dcn) knob")
        ici, dcn = (resolve_grad_dtype(dtype.get("ici")),
                    resolve_grad_dtype(dtype.get("dcn")))
    else:
        ici = resolve_grad_dtype(dtype)
        dcn = ici if hierarchical else None
        if hierarchical and is_quantized_dtype(ici):
            ici = None
    if _compress_disabled():
        ici = None if is_quantized_dtype(ici) else ici
        dcn = None if is_quantized_dtype(dcn) else dcn
    return ici, dcn


def _tree_add(a, b):
    """``a + b`` leaf by leaf over dicts, lists and tuples (the JAX
    ``allreduce_obj``'s ``jax.tree.map`` of ``+``)."""
    if isinstance(a, dict):
        return {key: _tree_add(a[key], b[key]) for key in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_tree_add(x, y) for x, y in zip(a, b))
    return a + b


class PendingExchange:
    """A gradient exchange in flight.  :meth:`wait` makes the current
    stream wait for it (a failure raises here) and returns its result; it
    is called once.  ``residual`` is the exchange's new error-feedback
    residual (``None`` without one), a tensor from the moment the
    exchange is launched; on the card it is written in stream order.
    ``work``: a ``Work``, a CUDA event, a list of them (a striped
    exchange: one event per path), a failure to raise, or ``None``."""

    def __init__(self, work, finish, residual=None):
        self._work = work
        self._finish = finish
        self.residual = residual

    def wait(self):
        if isinstance(self._work, BaseException):
            raise self._work
        works = self._work if isinstance(self._work, list) \
            else [self._work]
        for work in works:
            if work is not None:   # a Work, or a CUDA event
                work.wait()
        return self._finish()


class _StripedRun:
    """A striped exchange launched: per bucket the ICI path's gathered
    slice and the DCN path's mean, the CUDA event that ends each path's
    chain on its side stream (``None`` on the CPU, where the chains have
    run), the new error-feedback residual and the fresh DCN-path results
    (``double_buffering="dcn"``'s next stale buffer).  :meth:`assemble`
    runs on the current stream once it waits for what it reads."""

    def __init__(self, buckets, plans, specs, a_full, b_full, events,
                 residual, fresh):
        self.buckets, self.plans, self.specs = buckets, plans, specs
        self.a_full, self.b_full = a_full, b_full
        self.events, self.residual, self.fresh = events, residual, fresh

    def wait(self, path):
        """Make the current stream wait for ``path``'s chain."""
        if self.events is not None:
            self.events[path].wait()

    def assemble(self, n_leaves, stale=None):
        """The mean leaves: per bucket the ICI-path slice and the
        DCN-path slice (this step's, or ``stale``'s part of a flat fp32
        vector of every bucket's DCN-path slice), unpacked."""
        main = torch.cuda.current_stream() if self.events is not None \
            else None
        out = [None] * n_leaves
        for b, idx in enumerate(self.buckets):
            n_i, n_d, _, _, off_s = self.plans[b]
            spec, dtype = self.specs[b]
            parts = []
            if n_i:
                parts.append(self.a_full[b])
            if n_d:
                part = self.b_full[b] if stale is None \
                    else stale[off_s:off_s + n_d]
                parts.append(part.to(dtype))
            if main is not None:   # made on a side stream, read here
                for part in parts:
                    part.record_stream(main)
            flat = parts[0] if len(parts) == 1 else torch.cat(parts)
            for i, g in zip(idx, tree_unpack(flat, spec)):
                out[i] = g
        return out


class MeshCommunicator(CommunicatorBase):
    """Communicator over ``group`` (``None``: the default, world group,
    set up on first use by :func:`initialize_distributed`).

    ``device``: where this rank's tensors live (``None`` means ``cuda``,
    which raises without a card); it also picks the backend of a group
    this communicator sets up.  ``intra_size``/``inter_size`` (or the
    names ``hierarchical``/``two_dimensional``) make it hierarchical:
    sizes given win, else the hosts of the ranks decide
    (:func:`resolve_hierarchy`); the subgroups are built collectively
    here, so every rank constructs its communicators in the same order.
    ``allreduce_grad_dtype``: a dtype or name (cast, or int8/fp8
    quantized), or on a hierarchical communicator a per-hop ``{"ici":
    .., "dcn": ..}`` dict.  ``error_feedback``: carry the quantization
    residual (the optimizer threads it).  ``calls`` counts the
    collectives issued, by kind and hop.  ``stripe_ratio`` (a
    hierarchical communicator only; ``CHAINERMN_TPU_STRIPE_RATIO`` when
    not given): the DCN-path share of each bucket of the striped
    exchange, 0 for the plain two-level one."""

    def __init__(self, device=None, group=None, allreduce_grad_dtype=None,
                 batch_collectives=False, bucket_mb=None, name="jax_ici",
                 intra_size=None, inter_size=None, error_feedback=True,
                 stripe_ratio=None):
        self.name = name
        want_hier = (name in ("hierarchical", "two_dimensional")
                     or intra_size is not None or inter_size is not None)
        # which exchange knobs the caller set by hand (an argument, or an
        # environment variable read below): autotune fills only the others
        self._hand_knobs = {"bucket_mb": bucket_mb is not None,
                            "stripe_ratio": stripe_ratio is not None,
                            "grad_dtype": allreduce_grad_dtype is not None}
        #: the agreed autotune plan applied to this communicator, and the
        #: mode that produced it ("startup" | "online"), if any
        self.autotune_plan = None
        self._autotune_mode = None
        self.stripe_ratio = _resolve_stripe(stripe_ratio, want_hier,
                                            self._hand_knobs)
        self.allreduce_grad_dtype, self.dcn_grad_dtype = _wire_dtypes(
            allreduce_grad_dtype, want_hier)
        self.error_feedback = bool(error_feedback)
        if batch_collectives not in (False, True, "bucketed"):
            raise ValueError(
                f"batch_collectives must be False (per-leaf collectives), "
                f"True (one flat bucket) or 'bucketed' (size-bounded "
                f"buckets); got {batch_collectives!r}")
        self.batch_collectives = batch_collectives
        if bucket_mb is None and batch_collectives == "bucketed":
            raw = os.environ.get("CHAINERMN_TPU_BUCKET_MB")
            self._hand_knobs["bucket_mb"] = bool(raw)
            bucket_mb = float(raw or DEFAULT_BUCKET_MB)
        if bucket_mb is not None:
            bucket_mb = float(bucket_mb)
            if bucket_mb <= 0:
                raise ValueError(
                    f"bucket_mb must be positive, got {bucket_mb}")
        self.bucket_mb = bucket_mb
        dev = resolve_device(device)
        self._owns_world = group is None and initialize_distributed(dev)
        try:
            if dev.type == "cuda" and (device is None
                                       or torch.device(device).index is None):
                dev = torch.device("cuda", torch.cuda.current_device())
            self.device = dev
            self.group = group
            backend = str(dist.get_backend(group))
            if backend_for(dev) not in backend:
                raise ValueError(f"the process group runs {backend}, which "
                                 f"does not serve {dev} tensors")
            self.calls = collections.Counter()
            self._side = None
            self._path_streams = None
            # the reference's init_ranks at construction: a collective, so
            # every rank constructs its communicators in the same order
            hosts = gather_hosts(group)
            self._ranks = init_ranks(group, hosts)
            self.hierarchy = None
            self._hier_sizes = None
            self._hop_groups = ()
            self._path_groups = ()
            if want_hier:
                inter, intra = resolve_hierarchy(self.size, intra_size,
                                                 inter_size, hosts)
                self._hop_groups = hierarchy_groups(inter, intra, group,
                                                    backend=backend)
                if self.stripe_ratio > 0:
                    # the DCN path's own (intra, inter) pair: one
                    # communicator serializes its collectives, and each
                    # path uses both hops
                    self._path_groups = hierarchy_groups(
                        inter, intra, group, backend=backend)
                self.hierarchy = ("dcn", "ici")
                self._hier_sizes = (inter, intra)
            if observability.enabled():
                # every later event carries this rank's lane
                observability.tracer().configure(rank=self.rank)
        except BaseException:
            if self._owns_world:
                dist.destroy_process_group()
                self._owns_world = False
            raise

    # -- topology ------------------------------------------------------------
    @property
    def axis_name(self):
        """The JAX package's axis name of this communicator: ``("dcn",
        "ici")`` when hierarchical, ``"mn_world"`` when flat (the autotune
        plan's ``axis`` label and artifact name)."""
        return self.hierarchy if self.hierarchy is not None else "mn_world"

    def axis_in_scope(self):
        """The JAX query "are this communicator's mesh axes bound here?",
        which its model code asks before taking a parallel layer's
        collective path.  A rank of the port is a process inside its
        world, so it is True while the process group is up; layers never
        fall back to a single-device path on a communicator of the
        port."""
        return dist.is_initialized()

    @property
    def rank(self):
        return dist.get_rank(self.group)

    @property
    def size(self):
        return dist.get_world_size(self.group)

    @property
    def intra_rank(self):
        """This rank's place on its host; on a hierarchical communicator
        its place in its node of the split (:attr:`ici_index`)."""
        if self.hierarchy is not None:
            return self.ici_index
        return self._ranks[1]

    @property
    def intra_size(self):
        """Ranks per host; on a hierarchical communicator the split's
        ranks per node (:attr:`ici_size`), the JAX package's rule, which
        holds under a forced split on one host too."""
        if self.hierarchy is not None:
            return self.ici_size
        return self._ranks[2]

    @property
    def inter_rank(self):
        return self._ranks[3]

    @property
    def inter_size(self):
        """The number of hosts (the host view; on a hierarchical
        communicator the split's own view is :attr:`dcn_size`, which
        differs from it under a forced split on one host)."""
        return self._ranks[4]

    # -- the two-level (intra-node x inter-node) topology ---------------------
    @property
    def dcn_axis(self):
        """The slow hop's name (``None`` on a flat communicator)."""
        return self.hierarchy[0] if self.hierarchy is not None else None

    @property
    def ici_axis(self):
        """The fast hop's name (``None`` on a flat communicator)."""
        return self.hierarchy[1] if self.hierarchy is not None else None

    @property
    def dcn_size(self):
        """Inter-node groups' size: nodes of the split (1 when flat)."""
        return self._hier_sizes[0] if self.hierarchy is not None else 1

    @property
    def ici_size(self):
        """Ranks per node of the split (``size`` when flat)."""
        return self._hier_sizes[1] if self.hierarchy is not None \
            else self.size

    @property
    def dcn_index(self):
        """This rank's node in the split (0 when flat)."""
        return self.rank // self.ici_size

    @property
    def ici_index(self):
        """This rank's position in its node (``rank`` when flat)."""
        return self.rank % self.ici_size

    @property
    def chunk_index(self):
        """The chunk of a flat vector that the reduce-scatter chain leaves
        on this rank: ``ici_index * dcn_size + dcn_index``
        (:func:`chain_chunk_index`; ``rank`` when flat)."""
        return chain_chunk_index(self.ici_index, self.dcn_index,
                                 self.dcn_size)

    @property
    def striped_chunk_index(self):
        """The chunk of a DCN-path slice that the striped sharded update's
        transposed chain (inter-node reduce-scatter first) leaves on this
        rank: slow-hop-major, ``dcn_index * ici_size + ici_index``, which
        is ``rank``.  At a 2 x 2 split it differs from
        :attr:`chunk_index`."""
        return self.dcn_index * self.ici_size + self.ici_index

    def striped_chunk_specs(self):
        """The chunks of the striped sharded update's two slices on this
        rank: ``(fast-hop-major index of the ICI-path slice, slow-hop-major
        index of the DCN-path slice)`` (the JAX package returns the pair
        as partition specs)."""
        if self.hierarchy is None:
            raise ValueError("striped chunk specs need a hierarchical "
                             "communicator")
        return self.chunk_index, self.striped_chunk_index

    def chunk_axes(self):
        """The hops of the reduce-scatter chain, fast first: ``("ici",
        "dcn")``, or ``("mn_world",)`` when flat (the JAX axis name)."""
        if self.hierarchy is not None:
            return (self.ici_axis, self.dcn_axis)
        return ("mn_world",)

    @property
    def quantized(self):
        """True when a hop's wire is int8/fp8: the exchange carries a
        per-bucket scale and, with :attr:`error_feedback`, a residual."""
        return (is_quantized_dtype(self.allreduce_grad_dtype)
                or is_quantized_dtype(self.dcn_grad_dtype))

    @property
    def quantized_wire_dtype(self):
        """The quantized wire dtype (the inter-node hop's on a
        hierarchical communicator, the world's on a flat one), or
        ``None``."""
        dtype = self.dcn_grad_dtype if self.hierarchy is not None \
            else self.allreduce_grad_dtype
        return dtype if is_quantized_dtype(dtype) else None

    @property
    def grad_cast_dtype(self):
        """The dtype the gradient leaves are cast to before the exchange:
        ``allreduce_grad_dtype`` unless it is quantized (quantization
        happens at the wire, never as a pre-cast)."""
        dtype = self.allreduce_grad_dtype
        return None if is_quantized_dtype(dtype) else dtype

    def _global(self, rank):
        """The world rank of this communicator's ``rank`` (torch's
        collectives address peers by world rank)."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} out of range for a communicator "
                             f"of size {self.size}")
        return rank if self.group is None \
            else dist.get_global_rank(self.group, rank)

    # -- tensor collectives ----------------------------------------------------
    def _tensor(self, data):
        """A private contiguous copy of ``data`` on this rank's device."""
        return torch.as_tensor(data, device=self.device).clone(
            memory_format=torch.contiguous_format)

    def allreduce(self, data, op="sum"):
        """``op`` ("sum", "mean", "max", "min") of every rank's ``data``."""
        if op not in _REDUCE_OPS:
            raise ValueError(f"unsupported op {op!r}")
        x = self._tensor(data)
        dist.all_reduce(x, _REDUCE_OPS[op], group=self.group)
        self.calls["allreduce"] += 1
        return x / self.size if op == "mean" else x

    def multi_node_mean(self, data):
        """Reference ``CommunicatorBase.multi_node_mean``: allreduce ÷ size."""
        return self.allreduce(data, op="mean")

    def allgather(self, x):
        """Every rank's ``x``, as a tuple in rank order."""
        x = self._tensor(x)
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x, group=self.group)
        self.calls["allgather"] += 1
        return tuple(out)

    def alltoall(self, xs):
        """``xs[j]`` goes to rank j; returns the tensors received, by
        source rank.  All of ``xs`` share one shape and dtype."""
        if len(xs) != self.size:
            raise ValueError(f"alltoall takes one tensor per rank "
                             f"({self.size}), got {len(xs)}")
        inp = torch.stack([self._tensor(x) for x in xs])
        out = torch.empty_like(inp)
        dist.all_to_all_single(out, inp, group=self.group)
        self.calls["alltoall"] += 1
        return tuple(out.unbind(0))

    def _meta_from(self, root, x):
        """(shape, dtype) of ``x`` on ``root``, on every rank."""
        meta = [(tuple(x.shape), x.dtype) if self.rank == root else None]
        dist.broadcast_object_list(meta, src=self._global(root),
                                   group=self.group,
                                   device=self._object_device())
        return meta[0]

    def bcast(self, data, root=0, shaped=False):
        """``root``'s ``data`` on every rank (other ranks may pass
        ``None``: shape and dtype come from the root).  ``shaped``: every
        rank passes a tensor of the root's shape and dtype, so no
        metadata travels ahead of the broadcast."""
        x = self._tensor(data) if self.rank == root or shaped else None
        if not shaped:
            shape, dtype = self._meta_from(root, x)
            if x is None:
                x = torch.empty(shape, dtype=dtype, device=self.device)
        dist.broadcast(x, src=self._global(root), group=self.group)
        self.calls["bcast"] += 1
        return x

    def gather(self, data, root=0):
        return self.allgather(data)

    def scatter(self, xs, root=0):
        """Rank i receives ``xs[i]`` of ``root``'s ``xs`` (a sequence of
        ``size`` tensors of one shape, or a tensor with leading dim
        ``size``); other ranks may pass ``None``."""
        parts = None
        if self.rank == root:
            parts = [self._tensor(x) for x in xs]
            if len(parts) != self.size:
                raise ValueError(f"scatter takes one tensor per rank "
                                 f"({self.size}), got {len(parts)}")
        shape, dtype = self._meta_from(root, parts[0] if parts else None)
        out = torch.empty(shape, dtype=dtype, device=self.device)
        dist.scatter(out, scatter_list=parts, src=self._global(root),
                     group=self.group)
        self.calls["scatter"] += 1
        return out

    # -- point-to-point -----------------------------------------------------------
    def send(self, data, dest, tag=0):
        """Send a tensor to ``dest``; its shape and dtype go ahead of it on
        the object channel, so :meth:`recv` needs neither."""
        x = self._tensor(data)
        self.send_obj((tuple(x.shape), x.dtype), dest)
        dist.send(x, dst=self._global(dest), group=self.group, tag=tag)
        self.calls["send"] += 1

    def recv(self, source, tag=0):
        shape, dtype = self.recv_obj(source)
        x = torch.empty(shape, dtype=dtype, device=self.device)
        dist.recv(x, src=self._global(source), group=self.group, tag=tag)
        self.calls["recv"] += 1
        return x

    # -- object channel ---------------------------------------------------------
    # Pickled objects over the group (the reference's pickled MPI channel).
    # Point-to-point messages between a pair arrive in the order sent;
    # ``tag`` is accepted for the reference's signature.
    def _object_device(self):
        return self.device if self.device.type == "cuda" else None

    def _host_channel(self):
        """The host channel of this communicator's ranks: the process-
        global one when this communicator spans the default world of more
        than one process (the channel's process ids are this world's
        ranks), else None."""
        if self.group is not None or dist.get_world_size() == 1:
            return None
        ch = get_host_channel()
        if ch is None or (ch.process_id, ch.num_processes) != (
                dist.get_rank(), dist.get_world_size()):
            return None
        return ch

    def send_obj(self, obj, dest, tag=0):
        dist.send_object_list([obj], dst=self._global(dest),
                              group=self.group, device=self._object_device())
        self.calls["send_obj"] += 1

    def recv_obj(self, source, tag=0):
        box = [None]
        dist.recv_object_list(box, src=self._global(source),
                              group=self.group, device=self._object_device())
        self.calls["recv_obj"] += 1
        return box[0]

    def bcast_obj(self, obj, root=0):
        box = [obj]
        dist.broadcast_object_list(box, src=self._global(root),
                                   group=self.group,
                                   device=self._object_device())
        self.calls["bcast_obj"] += 1
        return box[0]

    def gather_obj(self, obj, root=0):
        return self.allgather_obj(obj)

    def allgather_obj(self, obj):
        """Every rank's ``obj``, as a list in rank order."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        self.calls["allgather_obj"] += 1
        return out

    def allreduce_obj(self, obj):
        gathered = self.allgather_obj(obj)
        out = gathered[0]
        for other in gathered[1:]:
            out = _tree_add(out, other)
        return out

    # -- model ops ------------------------------------------------------------------
    def bcast_data(self, model):
        """Copy rank 0's parameters and buffers into every rank's model, in
        place (the JAX package places them replicated on its mesh).  Lazy
        parameters not yet created are skipped, as the JAX package skips
        them."""
        src = self._global(0)
        with torch.no_grad():
            for x in (*model.parameters(), *model.buffers()):
                if is_lazy(x):
                    continue
                dist.broadcast(x.detach(), src=src, group=self.group)
                self.calls["bcast"] += 1
        return model

    @staticmethod
    def _leaf_params(model):
        """``model``'s parameters in the order the exchange plans over:
        sorted parameter path (the JAX params-tree flatten order), NOT
        registration order -- the two orders give different bucket
        plans.  Lazy parameters not yet created are not leaves, as the
        JAX params tree lacks them; nor are the parameters of a
        ``MultiNodeChainList`` component another rank owns (marked
        ``_mn_not_owned``: they take no gradient on this rank)."""
        return [p for _, p in sorted(model.namedparams(),
                                     key=lambda kv: kv[0])
                if not is_lazy(p) and not getattr(p, "_mn_not_owned", False)]

    @classmethod
    def grad_leaf_specs(cls, model):
        """``(shapes, dtypes)`` of the exchange's leaves."""
        leaves = cls._leaf_params(model)
        return [tuple(p.shape) for p in leaves], [p.dtype for p in leaves]

    @property
    def striped(self):
        """True when the exchange stripes each bucket across both fabrics:
        a hierarchical communicator with a nonzero :attr:`stripe_ratio`."""
        return self.hierarchy is not None and self.stripe_ratio > 0

    @property
    def topology(self):
        """``"striped"``, ``"hierarchical"`` or ``"flat"``: the exchange's
        topology, orthogonal to :attr:`exchange` (bucketing composes with
        any)."""
        if self.hierarchy is None:
            return "flat"
        return "striped" if self.striped else "hierarchical"

    @property
    def exchange(self):
        """``"per_leaf"`` | ``"flat"`` | ``"bucketed"``."""
        if self.batch_collectives == "bucketed":
            return "bucketed"
        return "flat" if self.batch_collectives else "per_leaf"

    def grad_buckets(self, shapes, dtypes):
        """The bucket plan of the exchange for leaves of the given shapes
        and (wire) dtypes: index lists in emission order."""
        if self.exchange == "per_leaf":
            return [[i] for i in reversed(range(len(shapes)))]
        if self.exchange == "flat":
            return [list(reversed(range(len(shapes))))] if shapes else []
        return plan_buckets(shapes, dtypes, int(self.bucket_mb * 2 ** 20))

    def grad_buckets_for(self, model):
        """The bucket plan :meth:`multi_node_mean_grad` runs for
        ``model`` (leaves in sorted path order, in the cast dtype: a
        quantized wire plans in the gradient's own dtype)."""
        return self.grad_buckets(*self._wire_leaf_specs(model))

    def grad_residual_len(self, shapes, dtypes):
        """This rank's length of the error-feedback residual of the
        allreduce exchange: per bucket the quantized hop's payload (the
        padded ``1/intra`` chunk on a hierarchical communicator, the whole
        bucket on a flat one; striped, the DCN-path slice and then the
        ICI-path slice's padded ``1/intra`` chunk, the order the schedule
        consumes them in), in plan order.  0 when no wire is quantized."""
        if self.quantized_wire_dtype is None:
            return 0
        total = 0
        for idx in self.grad_buckets(shapes, dtypes):
            elems = sum(int(np.prod(shapes[i])) for i in idx)
            if self.striped:
                n_i, n_d = stripe_plan(elems, self.stripe_ratio)
                total += n_d + -(-n_i // self.ici_size)
            elif self.hierarchy is not None:
                total += -(-elems // self.ici_size)
            else:
                total += elems
        return total

    def _wire_leaf_specs(self, model):
        """``model``'s leaf shapes and their dtypes on the wire (the cast
        dtype; a quantized wire plans in the gradient's own dtype)."""
        shapes, dtypes = self.grad_leaf_specs(model)
        if self.grad_cast_dtype is not None:
            dtypes = [self.grad_cast_dtype] * len(dtypes)
        return shapes, dtypes

    def grad_residual_len_for(self, model):
        """:meth:`grad_residual_len` over ``model``'s gradient leaves,
        planned as :meth:`grad_buckets_for` plans them."""
        return self.grad_residual_len(*self._wire_leaf_specs(model))

    def grad_dcn_stale_len(self, shapes, dtypes):
        """The length of ``double_buffering="dcn"``'s stale buffer: every
        bucket's DCN-path slice, in plan order (a ``stripe_ratio`` share
        of the gradient).  0 when not striped."""
        if not self.striped:
            return 0
        return sum(stripe_plan(sum(int(np.prod(shapes[i])) for i in idx),
                               self.stripe_ratio)[1]
                   for idx in self.grad_buckets(shapes, dtypes))

    def grad_dcn_stale_len_for(self, model):
        """:meth:`grad_dcn_stale_len` over ``model``'s gradient leaves."""
        return self.grad_dcn_stale_len(*self._wire_leaf_specs(model))

    def multi_node_mean_grad(self, model, zero_fill=False, residual=None,
                             stale_dcn=None):
        """Average every rank's ``param.grad`` in place.  A parameter
        without a gradient is skipped, or given zeros first with
        ``zero_fill`` (every rank must skip the same parameters).  On a
        quantized wire ``residual`` is the error-feedback residual
        (:meth:`grad_residual_len_for` long); the new one is returned
        (``None`` without one).

        ``stale_dcn`` (a striped communicator, ``double_buffering="dcn"``):
        a :class:`PendingExchange` of the previous step's DCN-path
        results (:meth:`grad_dcn_stale_len_for` fp32 elements), applied in
        place of this step's, whose DCN path then runs on without being
        waited for.  Returns ``(new_residual, fresh)``: ``fresh`` is the
        pending DCN-path results of this step, the next step's
        ``stale_dcn``."""
        leaves = []
        for p in self._leaf_params(model):
            if p.grad is None:
                if not zero_fill:
                    continue
                p.grad = torch.zeros_like(p)
            leaves.append(p)
        if not leaves:
            return residual if stale_dcn is None else (residual, stale_dcn)
        dtype = self.grad_cast_dtype
        wire = [(p.grad if dtype is None else p.grad.to(dtype)).contiguous()
                for p in leaves]
        with torch.no_grad():
            out, new_residual, *fresh = self._mean_leaves(wire, residual,
                                                          stale_dcn)
            for p, g in zip(leaves, out):
                if g is not p.grad:
                    p.grad = g.to(p.dtype)
        return new_residual if stale_dcn is None \
            else (new_residual, fresh[0])

    def _mean_leaves(self, wire, residual=None, stale_dcn=None):
        """The mean over the ranks of ``wire`` (this rank's gradient
        leaves in the cast dtype), bucket by bucket, on the plain, the
        quantized, the two-level or the striped path: ``(leaves,
        new_residual)``, and with ``stale_dcn`` the pending fresh DCN-path
        results after them."""
        if self.quantized and residual is None and self.error_feedback:
            _warn_inert_error_feedback()
        buckets = self.grad_buckets([tuple(g.shape) for g in wire],
                                    [g.dtype for g in wire])
        if stale_dcn is not None and not self.striped:
            raise ValueError("stale_dcn needs a striped communicator")
        if self.striped:
            run = self._striped_launch(wire, buckets, residual,
                                       fresh=stale_dcn is not None)
            run.wait("ici")
            if stale_dcn is None:
                run.wait("dcn")
                return run.assemble(len(wire)), run.residual
            out = run.assemble(len(wire), stale_dcn.wait())
            return out, run.residual, PendingExchange(
                None if run.events is None else run.events["dcn"],
                lambda: run.fresh)
        if self.hierarchy is not None:
            return self._hierarchical(wire, buckets, residual)
        if self.quantized:
            return self._quantized_flat(wire, buckets, residual)
        out = list(wire)
        for k, idx in enumerate(buckets):
            with _bucket_scope("mn_leaf_pmean" if self.exchange == "per_leaf"
                               else "mn_bucket_pmean", k):
                if len(idx) == 1:   # no pack/unpack copies for one leaf
                    flat, spec = wire[idx[0]], None
                else:
                    flat, spec = tree_pack([wire[i] for i in idx])
                dist.all_reduce(flat, dist.ReduceOp.SUM, group=self.group)
                flat.div_(self.size)
                self.calls["allreduce_grad"] += 1
                if spec is not None:
                    for i, g in zip(idx, tree_unpack(flat, spec)):
                        out[i] = g
        return out, None

    def _gather_rows(self, x, group, size, name=None):
        """Every member's ``x`` (1-D, or a 0-d scale) stacked: ``(size,
        n)``; fp8 crosses as its bytes.  Counted under ``name``."""
        x = x.reshape(-1)
        send = x.view(torch.uint8) if x.dtype in _BYTE_WIRE else x
        out = torch.empty(size * send.numel(), dtype=send.dtype,
                          device=send.device)
        dist.all_gather_into_tensor(out, send, group=group)
        if name is not None:
            self.calls[name] += 1
        return out.view(x.dtype).view(size, -1)

    def _residual_slice(self, residual, offset, n):
        return None if residual is None else residual[offset:offset + n]

    def _quantized_flat(self, wire, buckets, residual):
        """The quantized one-hop exchange: per bucket quantize ``v =
        bucket (+ residual)`` with one symmetric scale, all-gather the
        codewords and the scales, dequantize-sum, divide by ``size``."""
        size, q_dtype = self.size, self.allreduce_grad_dtype
        out = list(wire)
        new_res = []
        offset = 0
        for k, idx in enumerate(buckets):
            with _bucket_scope("mn_q_bucket_exchange", k):
                flat, spec = tree_pack([wire[i] for i in idx])
                n = flat.numel()
                q, scale, nr = quantize_with_feedback(
                    flat, self._residual_slice(residual, offset, n), q_dtype)
                offset += n
                new_res.append(nr)
                mean = dequantize_sum(
                    self._gather_rows(q, self.group, size, "allgather_q"),
                    self._gather_rows(scale, self.group, size,
                                      "allgather_scale")[:, 0]) / size
                for i, g in zip(idx, tree_unpack(mean, spec)):
                    out[i] = g
        return out, None if residual is None else torch.cat(new_res)

    def _hierarchical(self, wire, buckets, residual):
        """The two-level exchange, following :func:`hop_schedule`: per
        bucket a reduce-scatter over the intra-node group of the bucket
        padded to a multiple of ``intra``, then the ``1/intra`` chunk's
        inter-node hop (cast to ``dcn_grad_dtype``, allreduce, cast back;
        or quantize, all-gather codewords and scales, dequantize-sum),
        divided by ``size`` once; after every bucket's slow hop, the
        all-gathers over the intra-node group."""
        intra_g, inter_g = self._hop_groups
        intra, inter, size = self.ici_size, self.dcn_size, self.size
        dcn_dtype = self.dcn_grad_dtype
        q_dcn = is_quantized_dtype(dcn_dtype)
        out = list(wire)
        specs, chunks, new_res = {}, {}, {}
        offset = 0
        for op, b in hop_schedule(len(buckets)):
            idx = buckets[b]
            if op == "ici_reduce_scatter":
                with _bucket_scope("mn_hier_rs_ici", b):
                    flat, spec = tree_pack([wire[i] for i in idx])
                    flat, n_true = pad_to_multiple(flat, intra)
                    specs[b] = (spec, n_true)
                    chunk = flat.new_empty(flat.numel() // intra)
                    dist.reduce_scatter_tensor(chunk, flat,
                                               dist.ReduceOp.SUM,
                                               group=intra_g)
                self.calls["ici_reduce_scatter"] += 1
                chunks[b] = chunk
            elif op == "dcn_exchange" and q_dcn:
                with _bucket_scope("mn_hier_quantized_dcn", b):
                    c = chunks[b]
                    n = c.numel()
                    q, scale, new_res[b] = quantize_with_feedback(
                        c, self._residual_slice(residual, offset, n),
                        dcn_dtype)
                    offset += n
                    total = dequantize_sum(
                        self._gather_rows(q, inter_g, inter,
                                          "dcn_allgather_q"),
                        self._gather_rows(scale, inter_g, inter,
                                          "dcn_allgather_scale")[:, 0])
                    chunks[b] = (total / size).to(c.dtype)
            elif op == "dcn_exchange":
                with _bucket_scope("mn_hier_allreduce_dcn", b):
                    c = chunks[b]
                    w = c if dcn_dtype is None else c.to(dcn_dtype)
                    dist.all_reduce(w, dist.ReduceOp.SUM, group=inter_g)
                    chunks[b] = w.to(c.dtype).div_(size)
                self.calls["dcn_allreduce"] += 1
            else:  # ici_all_gather
                with _bucket_scope("mn_hier_ag_ici", b):
                    c = chunks.pop(b)
                    full = c.new_empty(c.numel() * intra)
                    dist.all_gather_into_tensor(full, c, group=intra_g)
                    spec, n_true = specs[b]
                    for i, g in zip(idx, tree_unpack(full[:n_true], spec)):
                        out[i] = g
                self.calls["ici_allgather"] += 1
        if residual is None or not q_dcn:
            return out, None
        return out, torch.cat([new_res[b] for b in range(len(buckets))])

    # -- the striped exchange ------------------------------------------------------
    def _path_stream(self, path):
        """The side stream of a striped path's chain (``"dcn"`` or
        ``"ici"``) on the card; ``None`` on the CPU."""
        if self.device.type != "cuda":
            return None
        if self._path_streams is None:
            self._path_streams = {p: torch.cuda.Stream(self.device)
                                  for p in ("dcn", "ici")}
        return self._path_streams[path]

    def _fork_paths(self, inputs):
        """Start both paths' side streams after the current stream's work,
        ``inputs`` (tensors made here and read there) marked as used on
        them: ``(streams by path, the current stream)``, ``(None, None)``
        on the CPU."""
        if self.device.type != "cuda":
            return None, None
        main = torch.cuda.current_stream(self.device)
        streams = {p: self._path_stream(p) for p in ("dcn", "ici")}
        for side in streams.values():
            side.wait_stream(main)
            for x in inputs:
                if x is not None:
                    x.record_stream(side)
        return streams, main

    @staticmethod
    def _on(streams, path):
        """The context that runs ``path``'s ops on its side stream."""
        if streams is None:
            return observability.tracing._NOOP
        return torch.cuda.stream(streams[path])

    @staticmethod
    def _join_paths(streams):
        """One event per path, recorded at the end of its chain (``None``
        on the CPU)."""
        if streams is None:
            return None
        events = {}
        for path, side in streams.items():
            events[path] = torch.cuda.Event()
            events[path].record(side)
        return events

    def _striped_launch(self, wire, buckets, residual, fresh=False):
        """Launch the striped exchange of ``wire`` (this rank's leaves in
        the cast dtype), following ``hop_schedule(k, "striped")``: per
        bucket the ICI-path slice ``flat[:n_i]`` (reduce-scatter over the
        intra-node group, the chunk's exchange over the inter-node group
        in ``dcn_grad_dtype`` or quantized, all-gather over intra) and the
        DCN-path slice ``flat[n_i:]`` (the transposed chain on the second
        pair of subgroups: reduce-scatter over inter in
        ``dcn_grad_dtype``, the chunk allreduced over intra in fp32,
        all-gather over inter; quantized: the slice itself quantized
        with its residual, codewords and scales all-gathered over inter,
        dequantize-summed, allreduced over intra in fp32).  The buckets
        are packed on the current stream; each path's chain runs on its
        side stream of the card.  Returns a :class:`_StripedRun`; with
        ``fresh`` it carries every bucket's DCN-path results, flat, in
        fp32."""
        intra_g, inter_g = self._hop_groups
        intra_g2, inter_g2 = self._path_groups
        intra, inter, size = self.ici_size, self.dcn_size, self.size
        dcn_dtype = self.dcn_grad_dtype
        q_dcn = is_quantized_dtype(dcn_dtype)
        sum_ = dist.ReduceOp.SUM
        # per bucket (n_i, n_d, residual offset of its DCN-path slice and
        # of its ICI-path chunk, stale offset): the schedule consumes the
        # buckets out of offset order
        plans, r_off, s_off = [], 0, 0
        flats, specs = {}, {}
        for b, idx in enumerate(buckets):
            with _bucket_scope("mn_stripe_pack", b):
                flats[b], spec = tree_pack([wire[i] for i in idx])
            specs[b] = (spec, flats[b].dtype)
            n_i, n_d = stripe_plan(flats[b].numel(), self.stripe_ratio)
            plans.append((n_i, n_d, r_off, r_off + n_d, s_off))
            r_off += n_d + -(-n_i // intra)
            s_off += n_d
        new_res = None
        if residual is not None and q_dcn:
            new_res = residual.new_empty(r_off)
        streams, _ = self._fork_paths([*flats.values(), residual, new_res])
        a_chunk, b_chunk, a_full, b_full = {}, {}, {}, {}
        for op, b in hop_schedule(len(buckets), mode="striped"):
            n_i, n_d, off_b, off_a, _ = plans[b]
            path = op[:3]
            if not (n_d if path == "dcn" else n_i) \
                    or (op == "dcn_path_gather" and q_dcn):
                continue   # an empty slice; the quantized DCN path is full
            with self._on(streams, path):
                if op == "dcn_path_scatter" and q_dcn:
                    with _bucket_scope("mn_stripe_pack_scatter_dcn", b):
                        q, scale, nr = quantize_with_feedback(
                            flats[b][n_i:],
                            self._residual_slice(residual, off_b, n_d),
                            dcn_dtype)
                        if nr is not None:
                            new_res[off_b:off_b + n_d].copy_(nr)
                        b_chunk[b] = (
                            self._gather_rows(q, inter_g2, inter),
                            self._gather_rows(scale, inter_g2, inter)[:, 0])
                elif op == "dcn_path_scatter":
                    with _bucket_scope("mn_stripe_pack_scatter_dcn", b):
                        g, _ = pad_to_multiple(flats[b][n_i:], inter)
                        if dcn_dtype is not None:
                            g = g.to(dcn_dtype)
                        b_chunk[b] = g.new_empty(g.numel() // inter)
                        dist.reduce_scatter_tensor(b_chunk[b], g, sum_,
                                                   group=inter_g2)
                elif op == "ici_path_scatter":
                    with _bucket_scope("mn_stripe_rs_ici", b):
                        g, _ = pad_to_multiple(flats[b][:n_i], intra)
                        a_chunk[b] = g.new_empty(g.numel() // intra)
                        dist.reduce_scatter_tensor(a_chunk[b], g, sum_,
                                                   group=intra_g)
                elif op == "dcn_path_exchange" and q_dcn:
                    with _bucket_scope("mn_stripe_dequant_psum_ici", b):
                        c = dequantize_sum(*b_chunk.pop(b))
                        dist.all_reduce(c, sum_, group=intra_g2)
                        b_full[b] = c.div_(size)
                elif op == "dcn_path_exchange":
                    # the fast hop is lossless: fp32 before the sum
                    with _bucket_scope("mn_stripe_allreduce_ici", b):
                        c = b_chunk[b].float()
                        dist.all_reduce(c, sum_, group=intra_g2)
                        b_chunk[b] = c.div_(size)
                elif op == "ici_path_exchange" and q_dcn:
                    with _bucket_scope("mn_stripe_quantized_chunk", b):
                        c = a_chunk[b]
                        q, scale, nr = quantize_with_feedback(
                            c, self._residual_slice(residual, off_a,
                                                    c.numel()), dcn_dtype)
                        if nr is not None:
                            new_res[off_a:off_a + c.numel()].copy_(nr)
                        total = dequantize_sum(
                            self._gather_rows(q, inter_g, inter),
                            self._gather_rows(scale, inter_g, inter)[:, 0])
                        a_chunk[b] = (total / size).to(c.dtype)
                elif op == "ici_path_exchange":
                    with _bucket_scope("mn_stripe_allreduce_dcn", b):
                        c = a_chunk[b]
                        w = c if dcn_dtype is None else c.to(dcn_dtype)
                        dist.all_reduce(w, sum_, group=inter_g)
                        a_chunk[b] = w.to(c.dtype).div_(size)
                elif op == "dcn_path_gather":
                    with _bucket_scope("mn_stripe_ag_dcn", b):
                        c = b_chunk.pop(b)
                        if dcn_dtype is not None:
                            c = c.to(dcn_dtype)
                        full = c.new_empty(c.numel() * inter)
                        dist.all_gather_into_tensor(full, c, group=inter_g2)
                        b_full[b] = full[:n_d].float()
                else:  # ici_path_gather
                    with _bucket_scope("mn_stripe_ag_ici", b):
                        c = a_chunk.pop(b)
                        full = c.new_empty(c.numel() * intra)
                        dist.all_gather_into_tensor(full, c, group=intra_g)
                        a_full[b] = full[:n_i]
            self.calls[op] += 1
        fresh_dcn = None
        if fresh:
            # the DCN path's results as applied (rounded to the wire), fp32
            with self._on(streams, "dcn"):
                fresh_dcn = torch.cat(
                    [b_full[b].to(specs[b][1]).float() for b in b_full]) \
                    if b_full else flats[0].new_zeros(0, dtype=torch.float32)
        return _StripedRun(buckets, plans, specs, a_full, b_full,
                           self._join_paths(streams), new_res, fresh_dcn)

    def _striped_reduce_scatter(self, flat):
        """The striped sharded update's gradient exchange: ``flat`` the
        ``{"ici", "dcn"}`` pair of padded slices (lengths multiples of
        ``size``).  The DCN-path slice reduce-scatters over the inter-node
        group (in ``dcn_grad_dtype``) and then, in fp32, over the
        intra-node group, landing slow-hop-major; the ICI-path slice over
        intra and then (in ``dcn_grad_dtype``) over inter, fast-hop-major.
        Slow path first; each path on its side stream of the card.
        Returns ``({"ici", "dcn"} chunks, events)``."""
        intra_g, inter_g = self._hop_groups
        intra_g2, inter_g2 = self._path_groups
        cast, dcn_dtype = self.grad_cast_dtype, self.dcn_grad_dtype
        g = {k: v if cast is None else v.to(cast) for k, v in flat.items()}
        streams, _ = self._fork_paths(g.values())
        chain = {"dcn": [("dcn_path_scatter", inter_g2, self.dcn_size,
                          dcn_dtype),
                         ("dcn_path_exchange", intra_g2, self.ici_size,
                          torch.float32)],
                 "ici": [("ici_path_scatter", intra_g, self.ici_size, None),
                         ("ici_path_exchange", inter_g, self.dcn_size,
                          dcn_dtype)]}
        for k in range(2):
            for path in ("dcn", "ici"):
                name, group, n, dtype = chain[path][k]
                if not g[path].numel():
                    continue
                with self._on(streams, path), _bucket_scope(
                        f"mn_stripe_zero_rs_{path}", 0):
                    x = g[path] if dtype is None else g[path].to(dtype)
                    out = x.new_empty(x.numel() // n)
                    dist.reduce_scatter_tensor(out, x, dist.ReduceOp.SUM,
                                               group=group)
                    g[path] = out
                self.calls[name] += 1
        for path in ("dcn", "ici"):
            with self._on(streams, path):
                g[path] = g[path].float() / self.size
        return g, self._join_paths(streams)

    def _striped_allgather(self, chunks):
        """Every rank's ``{"ici", "dcn"}`` chunks (or either one), each
        slice rebuilt along the reverse of its chain (ICI path: inter,
        then intra; DCN path: intra, then inter) on its side stream; the
        current stream waits for both."""
        intra_g, inter_g = self._hop_groups
        intra_g2, inter_g2 = self._path_groups
        hops = {"ici": [(inter_g, self.dcn_size), (intra_g, self.ici_size)],
                "dcn": [(intra_g2, self.ici_size), (inter_g2, self.dcn_size)]}
        streams, main = self._fork_paths(chunks.values())
        out = {}
        for path in [p for p in ("ici", "dcn") if p in chunks]:
            x = chunks[path].contiguous()
            if x.numel():
                with self._on(streams, path), _bucket_scope(
                        f"mn_stripe_zero_ag_{path}", 0):
                    for group, n in hops[path]:
                        full = x.new_empty(x.numel() * n)
                        dist.all_gather_into_tensor(full, x, group=group)
                        x = full
                self.calls[f"{path}_path_gather"] += 1
            out[path] = x
        if streams is not None:
            for side in streams.values():
                main.wait_stream(side)
            for x in out.values():
                x.record_stream(main)
        return out

    # -- the sharded update's flat exchange ---------------------------------------
    def _hops(self):
        """The reduce-scatter chain, fast hop first: ``(group, size,
        reduce-scatter count, all-gather count, quantized count prefix)``
        per hop."""
        if self.hierarchy is None:
            return [(self.group, self.size, "reduce_scatter_grad",
                     "allgather_flat", "")]
        intra_g, inter_g = self._hop_groups
        return [(intra_g, self.ici_size, "ici_reduce_scatter",
                 "ici_allgather", "ici_"),
                (inter_g, self.dcn_size, "dcn_reduce_scatter",
                 "dcn_allgather", "dcn_")]

    def _reduce_scatter_chain(self, flat, residual):
        """The mean of every rank's ``flat`` over the ranks, scattered
        along the hop chain: ``(chunk in fp32, new_residual)``.  The
        quantized hop (the last one) is an all-to-all of the codeword
        segments, an all-gather of the scales and a dequantize-sum."""
        cast = self.grad_cast_dtype
        q_dtype = self.quantized_wire_dtype
        hops = self._hops()
        g = flat if cast is None else flat.to(cast)
        new_residual = None
        for k, (group, n, rs_name, _, prefix) in enumerate(hops):
            slow = k == len(hops) - 1
            if slow and q_dtype is not None:
                q, scale, new_residual = quantize_with_feedback(
                    g, residual, q_dtype)
                send = q.view(torch.uint8) if q.dtype in _BYTE_WIRE else q
                seg = torch.empty_like(send)
                dist.all_to_all_single(seg, send, group=group)
                self.calls[prefix + "alltoall_q"] += 1
                g = dequantize_sum(
                    seg.view(q.dtype).view(n, -1),
                    self._gather_rows(scale, group, n,
                                      prefix + "allgather_scale")[:, 0])
                continue
            if slow and self.hierarchy is not None \
                    and self.dcn_grad_dtype is not None:
                g = g.to(self.dcn_grad_dtype)
            out = g.new_empty(g.numel() // n)
            dist.reduce_scatter_tensor(out, g, dist.ReduceOp.SUM,
                                       group=group)
            self.calls[rs_name] += 1
            g = out
        return g.float() / self.size, new_residual

    def reduce_scatter_grad(self, flat, async_op=False, residual=None):
        """Start the mean of every rank's flat gradient ``flat`` (fp32,
        its length a multiple of ``size``) over the ranks, scattered:
        this rank receives chunk :attr:`chunk_index` (:func:`chunk_bounds`
        of it), along the hop chain.  The wire is the cast dtype (and
        ``dcn_grad_dtype`` on the inter-node hop, or the quantized slow
        hop with ``residual``); the chunk is cast back to fp32 and divided
        by ``size``, as the JAX package's sharded update does.  Returns a
        :class:`PendingExchange` whose ``residual`` is the new
        error-feedback residual; with ``async_op`` the exchange runs
        until its ``wait()`` (one collective on the backend's stream, a
        chain on a side stream of the card)."""
        if isinstance(flat, dict):
            return self._striped_pending(flat)
        if flat.numel() % self.size:
            raise ValueError(f"flat length {flat.numel()} is not a "
                             f"multiple of the size {self.size}")
        if self.hierarchy is not None or self.quantized:
            return self._launch(
                lambda: self._reduce_scatter_chain(flat, residual),
                async_op, (flat, residual))
        dtype = self.allreduce_grad_dtype
        wire = flat if dtype is None else flat.to(dtype)
        out = torch.empty(flat.numel() // self.size, dtype=wire.dtype,
                          device=wire.device)
        work = dist.reduce_scatter_tensor(out, wire, dist.ReduceOp.SUM,
                                          group=self.group,
                                          async_op=async_op)
        self.calls["reduce_scatter_grad"] += 1
        size = self.size
        return PendingExchange(
            work, lambda: out.to(flat.dtype).div_(size))

    def _striped_pending(self, flat):
        """:meth:`reduce_scatter_grad` of a striped pair: the chains run
        at once (each on its side stream of the card) and ``wait()``
        waits for both paths' events."""
        if not self.striped:
            raise ValueError("a {'ici', 'dcn'} pair of flat slices needs a "
                             "striped communicator")
        for k, v in flat.items():
            if v.numel() % self.size:
                raise ValueError(f"{k} slice length {v.numel()} is not a "
                                 f"multiple of the size {self.size}")
        chunks, events = self._striped_reduce_scatter(flat)
        if events is None:
            return PendingExchange(None, lambda: chunks)

        def finish():
            main = torch.cuda.current_stream(self.device)
            for c in chunks.values():   # made on a side stream
                c.record_stream(main)
            return chunks

        return PendingExchange([events["dcn"], events["ici"]], finish)

    def allgather_flat(self, chunk):
        """Every rank's ``chunk``, concatenated in chunk order (the
        sharded update's parameters, rebuilt): all-gathers along the
        reverse of the hop chain, the inter-node hop first.  A striped
        ``{"ici", "dcn"}`` pair of chunks gives the pair of slices, each
        along its own chain."""
        if isinstance(chunk, dict):
            return self._striped_allgather(chunk)
        out = chunk.contiguous()
        for group, n, _, ag_name, _ in reversed(self._hops()):
            full = out.new_empty(out.numel() * n)
            dist.all_gather_into_tensor(full, out, group=group)
            self.calls[ag_name] += 1
            out = full
        return out

    def allreduce_grad_async(self, flat, shapes=None, residual=None):
        """Start the mean of every rank's ``flat`` (already in the wire
        dtype) over the ranks in place: the double-buffered exchange.
        ``shapes``: the leaves ``flat`` packs, in sorted path order (the
        bucket plan of the two-level and the quantized exchanges follows
        them; ``None`` is one leaf).  A flat lossless communicator issues
        one allreduce on the backend's stream and ``wait()`` divides by
        ``size`` (in the wire dtype, as :meth:`multi_node_mean_grad`);
        the others run :meth:`multi_node_mean_grad`'s exchange on a side
        stream of the card (at once on the CPU) and write the mean back
        into ``flat``.  ``wait()`` on the returned
        :class:`PendingExchange` returns ``flat``."""
        if self.hierarchy is None and not self.quantized:
            work = dist.all_reduce(flat, dist.ReduceOp.SUM,
                                   group=self.group, async_op=True)
            self.calls["allreduce_grad"] += 1
            size = self.size
            return PendingExchange(work, lambda: flat.div_(size))
        shapes = [tuple(flat.shape)] if shapes is None else shapes
        views = [v.view(s) for v, s in zip(
            flat.split([int(np.prod(s)) for s in shapes]), shapes)]
        if self.striped:
            # both paths' chains on their side streams; wait() waits for
            # one event per path, then writes the mean back
            if self.quantized and residual is None and self.error_feedback:
                _warn_inert_error_feedback()
            run = self._striped_launch(views, self.grad_buckets(
                shapes, [flat.dtype] * len(shapes)), residual)

            def finish():
                torch._foreach_copy_(views, run.assemble(len(views)))
                return flat

            return PendingExchange(
                None if run.events is None
                else [run.events["dcn"], run.events["ici"]],
                finish, run.residual)

        def exchange():
            out, new_residual = self._mean_leaves(views, residual)
            torch._foreach_copy_(views, out)
            return flat, new_residual

        return self._launch(exchange, True, (flat, residual))

    def _launch(self, exchange, async_op, inputs):
        """Run ``exchange()`` (returning ``(result, new_residual)``) as a
        :class:`PendingExchange`.  With ``async_op`` on the card it runs
        on this communicator's side stream after the current stream's
        work, and ``wait()`` makes the current stream wait for its event;
        ``inputs`` are marked as used there.  Elsewhere it runs now, and a
        failure raises at ``wait()``."""
        if not (async_op and self.device.type == "cuda"):
            try:
                result, new_residual = exchange()
            except Exception as e:
                if not async_op:
                    raise
                return PendingExchange(e, None)
            return PendingExchange(None, lambda: result, new_residual)
        main = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        side = self._side
        side.wait_stream(main)
        for x in inputs:
            if x is not None:
                x.record_stream(side)
        with torch.cuda.stream(side):
            result, new_residual = exchange()
            event = torch.cuda.Event()
            event.record(side)

        def finish():
            # made on the side stream, used on the current one
            result.record_stream(main)
            if new_residual is not None:
                new_residual.record_stream(main)
            return result

        return PendingExchange(event, finish, new_residual)

    # -- self-tuning ------------------------------------------------------------
    def _clone_kwargs(self):
        """Constructor arguments that build this communicator again (same
        group, split and knobs): the base of :meth:`retuned`'s clone."""
        kwargs = dict(device=self.device, group=self.group,
                      batch_collectives=self.batch_collectives,
                      bucket_mb=self.bucket_mb, name=self.name,
                      error_feedback=self.error_feedback)
        if self.hierarchy is not None:
            kwargs["inter_size"], kwargs["intra_size"] = self._hier_sizes
            if self.allreduce_grad_dtype is not None \
                    or self.dcn_grad_dtype is not None:
                kwargs["allreduce_grad_dtype"] = {
                    "ici": self.allreduce_grad_dtype,
                    "dcn": self.dcn_grad_dtype}
            kwargs["stripe_ratio"] = self.stripe_ratio
        else:
            kwargs["allreduce_grad_dtype"] = self.allreduce_grad_dtype
        return kwargs

    def retuned(self, plan):
        """Apply an agreed autotune plan (the JAX ``retuned``): a clone
        with the plan's ``bucket_mb`` (a bucketed exchange only),
        ``stripe_ratio`` and per-hop ``grad_dtype`` (a hierarchical
        communicator only) in every knob the caller did not set by hand;
        hand knobs win.  When the plan changes nothing, ``self`` with the
        plan attached, so a plan equal to the hand knobs runs the very
        same exchange.  The clone takes over the provenance, the mode,
        the plan, and the world group if this communicator set it up.
        Collective when it builds a clone (the plan itself is agreed, so
        every rank takes the same branch)."""
        hand = self._hand_knobs
        kwargs = self._clone_kwargs()
        changed = False
        if plan.get("bucket_mb") is not None \
                and not hand.get("bucket_mb") \
                and self.batch_collectives == "bucketed":
            bucket = float(plan["bucket_mb"])
            if bucket != self.bucket_mb:
                kwargs["bucket_mb"] = bucket
                changed = True
        if plan.get("stripe_ratio") is not None \
                and not hand.get("stripe_ratio") \
                and self.hierarchy is not None:
            ratio = float(plan["stripe_ratio"])
            if ratio != self.stripe_ratio:
                kwargs["stripe_ratio"] = ratio
                changed = True
        if plan.get("grad_dtype") is not None \
                and not hand.get("grad_dtype") \
                and self.hierarchy is not None:
            want = {hop: resolve_grad_dtype(dt)
                    for hop, dt in plan["grad_dtype"].items()}
            have = {"ici": self.allreduce_grad_dtype,
                    "dcn": self.dcn_grad_dtype}
            if want != have:
                kwargs["allreduce_grad_dtype"] = dict(plan["grad_dtype"])
                changed = True
        if not changed:
            self.autotune_plan = plan
            return self
        clone = type(self)(**kwargs)
        # the clone saw the plan's values as explicit arguments; they must
        # not read as set by hand at the next re-tune
        clone._hand_knobs = dict(hand)
        clone._autotune_mode = self._autotune_mode
        clone.autotune_plan = plan
        clone._owns_world, self._owns_world = self._owns_world, False
        return clone

    # -- topology manipulation ---------------------------------------------------
    def split(self, color, key):
        """Partition the ranks by ``color`` (MPI_Comm_Split): returns the
        flat communicator of this rank's color (a hierarchical one's
        split is flat, with its intra-node wire dtype).  ``color``/``key`` are this
        rank's values, or sequences of ``size`` indexed by rank (the JAX
        package's form).  Collective over this communicator.

        torch.distributed orders a group's ranks by world rank, so a
        ``key`` that orders a color's ranks otherwise is refused."""
        if not np.isscalar(color):
            color = list(color)[self.rank]
        if not np.isscalar(key):
            key = list(key)[self.rank]
        table = self.allgather_obj((color, key, self.rank))
        members = sorted((k, r) for c, k, r in table if c == color)
        ranks = [r for _, r in members]
        orders = {c: [r for _, r in sorted((k, r) for cc, k, r in table
                                           if cc == c)]
                  for c, _, _ in table}
        if any(rs != sorted(rs) for rs in orders.values()):
            raise NotImplementedError(
                "split: a key that orders ranks otherwise than their rank "
                "in the parent communicator is not supported (a "
                "torch.distributed group orders its members by world rank)")
        group = dist.new_group([self._global(r) for r in ranks],
                               use_local_synchronization=True)
        sub = MeshCommunicator(
            device=self.device, group=group,
            allreduce_grad_dtype=self.allreduce_grad_dtype,
            batch_collectives=self.batch_collectives,
            bucket_mb=self.bucket_mb,
            # a hierarchical name would build a split over the color's ranks
            name="jax_ici" if self.hierarchy is not None else self.name,
            error_feedback=self.error_feedback)
        sub._hand_knobs = dict(self._hand_knobs)
        sub._autotune_mode = self._autotune_mode
        sub.autotune_plan = self.autotune_plan
        return sub

    def finalize(self):
        """Tear down the process groups this communicator set up (a
        split's group, the hierarchy's subgroups, or the world group it
        initialized, with the host channel over its store); the
        communicator is unusable afterwards.  Point-to-point sends still
        in flight (``functions.send`` never waits) are waited for first,
        as ``MPI_Finalize`` does: torn down under them, a send is lost
        and its receiver fails on a closed connection."""
        for work, _ in self.__dict__.pop("_p2p_pending", ()):
            work.wait()
        if self._owns_world:
            reset_host_channel()
            dist.destroy_process_group()
        else:
            for group in (*self._hop_groups, *self._path_groups,
                          self.group):
                if group is not None:
                    dist.destroy_process_group(group)
        self._hop_groups = self._path_groups = ()
        self._owns_world = False

    def __repr__(self):
        split = "" if self.hierarchy is None \
            else f" split={self.dcn_size}x{self.ici_size}" \
            f" dcn_dtype={self.dcn_grad_dtype}"
        if self.striped:
            split += f" stripe_ratio={self.stripe_ratio}"
        return (f"<{type(self).__name__} name={self.name!r} "
                f"size={self.size} device={self.device} "
                f"exchange={self.exchange} "
                f"grad_dtype={self.allreduce_grad_dtype}{split}>")


#: the elastic world this process's default process group is, as
#: ``(store namespace, epoch, members)``; None when it is not one
_elastic_world = None


def _replace_world(store, slot, n, backend, epoch_key):
    """Make the default process group a new world of ``n`` ranks over
    ``store``, this process at ``slot``: the old default world and every
    group of it are torn down first (aborted on NCCL, whose destroy can
    block on a dead peer).  Collective over the new world's ranks only."""
    global _elastic_world
    from torch.distributed import distributed_c10d as c10d

    from ._communication_utility import TIMEOUT
    if dist.is_initialized():
        abort = getattr(c10d, "_abort_process_group", None)
        if "nccl" in str(dist.get_backend()) and abort is not None:
            abort()
        else:
            dist.destroy_process_group()
    _elastic_world = None
    dist.init_process_group(backend, store=store, rank=slot, world_size=n,
                            timeout=TIMEOUT)
    _elastic_world = epoch_key


class ElasticMeshCommunicator(MeshCommunicator):
    """A :class:`MeshCommunicator` over the live subset of the job's
    processes (the JAX ``ElasticMeshCommunicator``): the rebuilt transport
    after an elastic shrink or grow.

    ``members`` are stable ranks (the boot world's ranks, the identities
    membership decides over); the communicator maps them to dense slots
    0..n-1: ``rank`` is the slot, :attr:`stable_rank` the identity
    (checkpoint files key on it, so a process reads its own snapshots
    across any number of resizes).  ``epoch`` is the membership epoch the
    set was decided at.

    ``torch.distributed.new_group`` is collective over the boot world and
    hangs once a member is gone, so each epoch gets a default world of its
    own: the process's old default world is torn down (aborted on NCCL)
    and ``init_process_group`` builds the members' world over
    ``PrefixStore("<ns>/el<epoch>/pg", store)``, where ``store`` is the
    job's store, which must outlive every rank (under ``torchrun`` the
    agent hosts it; the job ends with it).  ``group=None`` then means the
    members' world, and the hierarchical subgroups are built inside it.
    Construction is collective over the members (every live member builds
    the communicator for the same view); a departed rank takes no part.
    A clone of the same epoch (``retuned``) keeps the world.

    ``channel``: a :class:`~._host_channel.HostChannel` over the job's
    store, the template of the members-only object channel (namespace
    ``<ns>/el<epoch>``, process ids remapped to slots) and the source of
    the store and of this process's stable rank (its ``stable_rank``, else
    its ``process_id``); default: the process-global channel.  With one
    member the object channel is the process group's.  ``device`` and the
    other arguments are :class:`MeshCommunicator`'s.
    """

    def __init__(self, members, epoch=0, channel=None, device=None,
                 **kwargs):
        members = tuple(sorted(int(m) for m in members))
        if not members:
            raise ValueError("an elastic communicator needs >= 1 member")
        if len(set(members)) != len(members):
            raise ValueError(f"duplicate members: {members!r}")
        template = channel if channel is not None else get_host_channel()
        if template is None or not hasattr(template._client, "store"):
            raise ValueError(
                "an elastic communicator needs a host channel over the "
                "job's torch.distributed store (channel=, or a default "
                "world of more than one process)")
        me = int(getattr(template, "stable_rank", template.process_id))
        if me not in members:
            raise ValueError(
                f"process {me} is not in the elastic view {members}; "
                f"non-members must re-join through the membership "
                f"protocol before constructing the communicator")
        self.members = members
        self.epoch = int(epoch)
        self._member_slot = members.index(me)
        self._stable_rank = me
        self._template = template
        self._elastic_channel = self._derive_channel(template)
        ns_root = template._ns.split("/el", 1)[0]
        key = (ns_root, self.epoch, members)
        dev = resolve_device(device)
        if _elastic_world != key or not dist.is_initialized():
            if dev.type == "cuda":
                torch.cuda.set_device(dev.index if dev.index is not None
                                      else torch.cuda.current_device())
            _replace_world(
                dist.PrefixStore(f"{ns_root}/el{self.epoch}/pg",
                                 template._client.store),
                self._member_slot, len(members), backend_for(dev), key)
        super().__init__(device=device, group=None, **kwargs)
        self._owns_world = True

    def _derive_channel(self, template):
        """Members-only sub-channel: the template's store and tolerance
        knobs, its namespace scoped by the membership epoch (keys of any
        other incarnation never match), process ids remapped to the view's
        slots.  None for a single member."""
        if len(self.members) <= 1:
            return None
        client = template._client
        if hasattr(client, "with_parties"):
            client = client.with_parties(len(self.members))
        ns_root = template._ns.split("/el", 1)[0]
        ch = HostChannel(
            namespace=f"{ns_root}/el{self.epoch}", client=client,
            chunk_bytes=template._chunk, timeout_ms=template._timeout_ms,
            op_timeouts=dict(template._op_timeouts),
            max_retries=template.max_retries,
            backoff_base_s=template.backoff_base_s,
            backoff_max_s=template.backoff_max_s,
            clock=template._clock, sleep=template._sleep,
            process_id=self._member_slot, num_processes=len(self.members))
        ch.stable_rank = self._stable_rank
        return ch

    def _host_channel(self):
        return self._elastic_channel

    # the object calls ride the members' channel (slots are its process
    # ids): a departed member surfaces as a typed channel error there
    def send_obj(self, obj, dest, tag=0):
        if self._elastic_channel is None:
            return super().send_obj(obj, dest, tag)
        self._elastic_channel.send_obj(obj, dest, tag)
        self.calls["send_obj"] += 1

    def recv_obj(self, source, tag=0):
        if self._elastic_channel is None:
            return super().recv_obj(source, tag)
        obj = self._elastic_channel.recv_obj(source, tag)
        self.calls["recv_obj"] += 1
        return obj

    def bcast_obj(self, obj, root=0):
        if self._elastic_channel is None:
            return super().bcast_obj(obj, root)
        out = self._elastic_channel.bcast(obj, root=root)
        self.calls["bcast_obj"] += 1
        return out

    def allgather_obj(self, obj):
        if self._elastic_channel is None:
            return super().allgather_obj(obj)
        out = self._elastic_channel.allgather(obj)
        self.calls["allgather_obj"] += 1
        return out

    def _clone_kwargs(self):
        # a retuned clone is the same incarnation (members, epoch, world)
        # with other exchange knobs
        kwargs = super()._clone_kwargs()
        kwargs.pop("group", None)
        kwargs.update(members=self.members, epoch=self.epoch,
                      channel=self._template)
        return kwargs

    @property
    def stable_rank(self):
        """This process's boot rank: the same across resizes (snapshot
        files and membership announcements key on it, never on the
        slot)."""
        return self._stable_rank

    def finalize(self):
        global _elastic_world
        if self._owns_world:
            _elastic_world = None
        super().finalize()

    def __repr__(self):
        return (f"<ElasticMeshCommunicator epoch={self.epoch} "
                f"members={self.members} size={self.size} "
                f"device={self.device}>")
