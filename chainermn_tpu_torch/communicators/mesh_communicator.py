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

A quantized exchange takes and returns the error-feedback residual (the
JAX ``transform(grads, residual)``): the residual is added before
quantizing, and the new one, ``v - Q(v)`` per element, is what the
caller carries to the next step.  ``calls`` counts each collective by
hop (``ici_reduce_scatter``, ``dcn_allreduce``, ``dcn_allgather_q``,
``dcn_allgather_scale``, ``ici_allgather``, ...).

Not ported yet (they raise ``NotImplementedError``): ``stripe_ratio``
and ``autotune`` (ROADMAP A10), and the elastic subclass (A11).
"""

from __future__ import annotations

import collections
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parameter import is_lazy

from .._device import resolve_device
from ._communication_utility import (backend_for, gather_hosts,
                                     hierarchy_groups, init_ranks,
                                     initialize_distributed,
                                     resolve_hierarchy)
from ._memory_utility import (DEFAULT_BUCKET_MB, chain_chunk_index,
                              dequantize_sum, hop_schedule,
                              is_quantized_dtype, pad_to_multiple,
                              plan_buckets, quantize_with_feedback,
                              resolve_grad_dtype, tree_pack, tree_unpack)
from .communicator_base import CommunicatorBase

__all__ = ["MeshCommunicator", "ElasticMeshCommunicator", "PendingExchange"]

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
               "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}

#: wire dtypes sent as their bytes: gloo, and NCCL before 2.24, may
#: refuse fp8 tensors; a gather or an all-to-all only copies bytes
_BYTE_WIRE = (torch.float8_e4m3fn, torch.float8_e5m2)

_warned_inert_ef = False


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
    exchange is launched; on the card it is written in stream order."""

    def __init__(self, work, finish, residual=None):
        self._work = work
        self._finish = finish
        self.residual = residual

    def wait(self):
        if isinstance(self._work, BaseException):
            raise self._work
        if self._work is not None:   # a Work, or a CUDA event
            self._work.wait()
        return self._finish()


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
    collectives issued, by kind and hop."""

    def __init__(self, device=None, group=None, allreduce_grad_dtype=None,
                 batch_collectives=False, bucket_mb=None, name="jax_ici",
                 intra_size=None, inter_size=None, error_feedback=True):
        self.name = name
        want_hier = (name in ("hierarchical", "two_dimensional")
                     or intra_size is not None or inter_size is not None)
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
            bucket_mb = float(os.environ.get("CHAINERMN_TPU_BUCKET_MB")
                              or DEFAULT_BUCKET_MB)
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
            # the reference's init_ranks at construction: a collective, so
            # every rank constructs its communicators in the same order
            hosts = gather_hosts(group)
            self._ranks = init_ranks(group, hosts)
            self.hierarchy = None
            self._hier_sizes = None
            self._hop_groups = ()
            if want_hier:
                inter, intra = resolve_hierarchy(self.size, intra_size,
                                                 inter_size, hosts)
                self._hop_groups = hierarchy_groups(inter, intra, group,
                                                    backend=backend)
                self.hierarchy = ("dcn", "ici")
                self._hier_sizes = (inter, intra)
        except BaseException:
            if self._owns_world:
                dist.destroy_process_group()
                self._owns_world = False
            raise

    # -- topology ------------------------------------------------------------
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

    def bcast(self, data, root=0):
        """``root``'s ``data`` on every rank (other ranks may pass
        ``None``: shape and dtype come from the root)."""
        x = self._tensor(data) if self.rank == root else None
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
        JAX params tree lacks them."""
        return [p for _, p in sorted(model.namedparams(),
                                     key=lambda kv: kv[0])
                if not is_lazy(p)]

    @classmethod
    def grad_leaf_specs(cls, model):
        """``(shapes, dtypes)`` of the exchange's leaves."""
        leaves = cls._leaf_params(model)
        return [tuple(p.shape) for p in leaves], [p.dtype for p in leaves]

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
        shapes, dtypes = self.grad_leaf_specs(model)
        if self.grad_cast_dtype is not None:
            dtypes = [self.grad_cast_dtype] * len(dtypes)
        return self.grad_buckets(shapes, dtypes)

    def grad_residual_len(self, shapes, dtypes):
        """This rank's length of the error-feedback residual of the
        allreduce exchange: per bucket the quantized hop's payload (the
        padded ``1/intra`` chunk on a hierarchical communicator, the whole
        bucket on a flat one), in plan order.  0 when no wire is
        quantized."""
        if self.quantized_wire_dtype is None:
            return 0
        total = 0
        for idx in self.grad_buckets(shapes, dtypes):
            elems = sum(int(np.prod(shapes[i])) for i in idx)
            total += -(-elems // self.ici_size) if self.hierarchy \
                else elems
        return total

    def grad_residual_len_for(self, model):
        """:meth:`grad_residual_len` over ``model``'s gradient leaves,
        planned as :meth:`grad_buckets_for` plans them."""
        shapes, dtypes = self.grad_leaf_specs(model)
        if self.grad_cast_dtype is not None:
            dtypes = [self.grad_cast_dtype] * len(dtypes)
        return self.grad_residual_len(shapes, dtypes)

    def multi_node_mean_grad(self, model, zero_fill=False, residual=None):
        """Average every rank's ``param.grad`` in place.  A parameter
        without a gradient is skipped, or given zeros first with
        ``zero_fill`` (every rank must skip the same parameters).  On a
        quantized wire ``residual`` is the error-feedback residual
        (:meth:`grad_residual_len_for` long); the new one is returned
        (``None`` without one)."""
        leaves = []
        for p in self._leaf_params(model):
            if p.grad is None:
                if not zero_fill:
                    continue
                p.grad = torch.zeros_like(p)
            leaves.append(p)
        if not leaves:
            return residual
        dtype = self.grad_cast_dtype
        wire = [(p.grad if dtype is None else p.grad.to(dtype)).contiguous()
                for p in leaves]
        with torch.no_grad():
            out, new_residual = self._mean_leaves(wire, residual)
            for p, g in zip(leaves, out):
                if g is not p.grad:
                    p.grad = g.to(p.dtype)
        return new_residual

    def _mean_leaves(self, wire, residual=None):
        """The mean over the ranks of ``wire`` (this rank's gradient
        leaves in the cast dtype), bucket by bucket, on the plain, the
        quantized or the two-level path: ``(leaves, new_residual)``."""
        if self.quantized and residual is None and self.error_feedback:
            _warn_inert_error_feedback()
        buckets = self.grad_buckets([tuple(g.shape) for g in wire],
                                    [g.dtype for g in wire])
        if self.hierarchy is not None:
            return self._hierarchical(wire, buckets, residual)
        if self.quantized:
            return self._quantized_flat(wire, buckets, residual)
        out = list(wire)
        for idx in buckets:
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

    def _gather_rows(self, x, group, size, name):
        """Every member's ``x`` (1-D, or a 0-d scale) stacked: ``(size,
        n)``; fp8 crosses as its bytes."""
        x = x.reshape(-1)
        send = x.view(torch.uint8) if x.dtype in _BYTE_WIRE else x
        out = torch.empty(size * send.numel(), dtype=send.dtype,
                          device=send.device)
        dist.all_gather_into_tensor(out, send, group=group)
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
        for idx in buckets:
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
                flat, spec = tree_pack([wire[i] for i in idx])
                flat, n_true = pad_to_multiple(flat, intra)
                specs[b] = (spec, n_true)
                chunk = flat.new_empty(flat.numel() // intra)
                dist.reduce_scatter_tensor(chunk, flat, dist.ReduceOp.SUM,
                                           group=intra_g)
                self.calls["ici_reduce_scatter"] += 1
                chunks[b] = chunk
            elif op == "dcn_exchange" and q_dcn:
                c = chunks[b]
                n = c.numel()
                q, scale, new_res[b] = quantize_with_feedback(
                    c, self._residual_slice(residual, offset, n), dcn_dtype)
                offset += n
                total = dequantize_sum(
                    self._gather_rows(q, inter_g, inter, "dcn_allgather_q"),
                    self._gather_rows(scale, inter_g, inter,
                                      "dcn_allgather_scale")[:, 0])
                chunks[b] = (total / size).to(c.dtype)
            elif op == "dcn_exchange":
                c = chunks[b]
                w = c if dcn_dtype is None else c.to(dcn_dtype)
                dist.all_reduce(w, dist.ReduceOp.SUM, group=inter_g)
                self.calls["dcn_allreduce"] += 1
                chunks[b] = w.to(c.dtype).div_(size)
            else:  # ici_all_gather
                c = chunks.pop(b)
                full = c.new_empty(c.numel() * intra)
                dist.all_gather_into_tensor(full, c, group=intra_g)
                self.calls["ici_allgather"] += 1
                spec, n_true = specs[b]
                for i, g in zip(idx, tree_unpack(full[:n_true], spec)):
                    out[i] = g
        if residual is None or not q_dcn:
            return out, None
        return out, torch.cat([new_res[b] for b in range(len(buckets))])

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

    def allgather_flat(self, chunk):
        """Every rank's ``chunk``, concatenated in chunk order (the
        sharded update's parameters, rebuilt): all-gathers along the
        reverse of the hop chain, the inter-node hop first."""
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
        return MeshCommunicator(
            device=self.device, group=group,
            allreduce_grad_dtype=self.allreduce_grad_dtype,
            batch_collectives=self.batch_collectives,
            bucket_mb=self.bucket_mb, name=self.name,
            error_feedback=self.error_feedback)

    def finalize(self):
        """Tear down the process groups this communicator set up (a
        split's group, the hierarchy's subgroups, or the world group it
        initialized); the communicator is unusable afterwards."""
        if self._owns_world:
            dist.destroy_process_group()
        else:
            for group in (*self._hop_groups, self.group):
                if group is not None:
                    dist.destroy_process_group(group)
        self._hop_groups = ()
        self._owns_world = False

    def __repr__(self):
        split = "" if self.hierarchy is None \
            else f" split={self.dcn_size}x{self.ici_size}" \
            f" dcn_dtype={self.dcn_grad_dtype}"
        return (f"<{type(self).__name__} name={self.name!r} "
                f"size={self.size} device={self.device} "
                f"exchange={self.exchange} "
                f"grad_dtype={self.allreduce_grad_dtype}{split}>")


class ElasticMeshCommunicator(MeshCommunicator):
    """The elastic communicator (membership epochs, resize) of the JAX
    package; not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ElasticMeshCommunicator (elastic membership and resize) is "
            "not ported yet (ROADMAP A11)")
