"""Communicator over a ``torch.distributed`` process group.

The port of ``chainermn_tpu.communicators.mesh_communicator``'s flat path.
There a communicator is a 1-D device mesh driven by one controller and the
gradient mean is a ``pmean`` inside the compiled step; here, as in the
reference, it is a process group with one process per device, and every
collective is a ``torch.distributed`` call on this rank's tensor: NCCL for
CUDA tensors, gloo for the CPU.

The gradient exchange (:meth:`MeshCommunicator.multi_node_mean_grad`) is
the JAX ``grad_transform``'s allreduce path, run eagerly after backward:
cast to ``allreduce_grad_dtype``, pack each bucket, ``all_reduce(SUM)``,
divide by ``size`` (the JAX ``pmean`` is a sum, then a divide), unpack,
cast back.  The leaves are the parameters in sorted path order, as the
JAX package flattens its params tree, so that ``batch_collectives``
``False`` (one collective per leaf), ``True`` (one flat bucket) and
``"bucketed"`` (``bucket_mb``-bounded buckets, :func:`plan_buckets`) plan
the same buckets as there.  All three give bitwise-equal gradients: the
sum is elementwise, packing changes the schedule, not the math.

The sharded update (``zero_sharding`` and ``exchange="reduce_scatter"``)
exchanges one flat padded vector instead: :meth:`MeshCommunicator.
reduce_scatter_grad` (``reduce_scatter_tensor``, each rank keeping its
chunk) and :meth:`MeshCommunicator.allgather_flat`
(``all_gather_into_tensor``); the double-buffered exchange launches its
allreduce on the backend's stream (:meth:`MeshCommunicator.
allreduce_grad_async`) and is waited for one step later.

Not ported yet (they raise ``NotImplementedError``): the quantized wires,
``stripe_ratio``, the hierarchical schedule and ``autotune`` (ROADMAP
A10), and the elastic subclass (A11).
"""

from __future__ import annotations

import collections
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parameter import is_lazy

from .._device import resolve_device
from ._communication_utility import (backend_for, init_ranks,
                                     initialize_distributed)
from ._memory_utility import (DEFAULT_BUCKET_MB, is_quantized_dtype,
                              plan_buckets, resolve_grad_dtype, tree_pack,
                              tree_unpack)
from .communicator_base import CommunicatorBase

__all__ = ["MeshCommunicator", "ElasticMeshCommunicator", "PendingExchange"]

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
               "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


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
    stream wait for the collective (a failure raises here) and returns
    its result; it is called once."""

    def __init__(self, work, finish):
        self._work = work
        self._finish = finish

    def wait(self):
        if self._work is not None:
            self._work.wait()
        return self._finish()


class MeshCommunicator(CommunicatorBase):
    """Communicator over ``group`` (``None``: the default, world group,
    set up on first use by :func:`initialize_distributed`).

    ``device``: where this rank's tensors live (``None`` means ``cuda``,
    which raises without a card); it also picks the backend of a group
    this communicator sets up.  ``calls`` counts the collectives issued,
    by kind (``allreduce_grad`` counts the gradient buckets)."""

    def __init__(self, device=None, group=None, allreduce_grad_dtype=None,
                 batch_collectives=False, bucket_mb=None, name="jax_ici"):
        self.name = name
        if isinstance(allreduce_grad_dtype, dict) \
                or is_quantized_dtype(allreduce_grad_dtype):
            raise NotImplementedError(
                f"allreduce_grad_dtype={allreduce_grad_dtype!r}: per-hop "
                "and quantized (int8/fp8) wires are not ported yet "
                "(ROADMAP A10)")
        self.allreduce_grad_dtype = resolve_grad_dtype(allreduce_grad_dtype)
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
        # the reference's init_ranks at construction: a collective, so
        # every rank constructs its communicators in the same order
        self._ranks = init_ranks(group)

    # -- topology ------------------------------------------------------------
    @property
    def rank(self):
        return dist.get_rank(self.group)

    @property
    def size(self):
        return dist.get_world_size(self.group)

    @property
    def intra_rank(self):
        return self._ranks[1]

    @property
    def intra_size(self):
        return self._ranks[2]

    @property
    def inter_rank(self):
        return self._ranks[3]

    @property
    def inter_size(self):
        return self._ranks[4]

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
        ``model`` (leaves in sorted path order, in the wire dtype)."""
        shapes, dtypes = self.grad_leaf_specs(model)
        if self.allreduce_grad_dtype is not None:
            dtypes = [self.allreduce_grad_dtype] * len(dtypes)
        return self.grad_buckets(shapes, dtypes)

    def multi_node_mean_grad(self, model, zero_fill=False):
        """Average every rank's ``param.grad`` in place.  A parameter
        without a gradient is skipped, or given zeros first with
        ``zero_fill`` (every rank must skip the same parameters)."""
        leaves = []
        for p in self._leaf_params(model):
            if p.grad is None:
                if not zero_fill:
                    continue
                p.grad = torch.zeros_like(p)
            leaves.append(p)
        if not leaves:
            return
        dtype = self.allreduce_grad_dtype
        wire = [(p.grad if dtype is None else p.grad.to(dtype)).contiguous()
                for p in leaves]
        out = list(wire)
        with torch.no_grad():
            for idx in self.grad_buckets([tuple(g.shape) for g in wire],
                                         [g.dtype for g in wire]):
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
            for p, g in zip(leaves, out):
                if g is not p.grad:
                    p.grad = g.to(p.dtype)

    # -- the sharded update's flat exchange ---------------------------------------
    def reduce_scatter_grad(self, flat, async_op=False):
        """Start the mean of every rank's flat gradient ``flat`` (fp32,
        its length a multiple of ``size``) over the ranks, scattered:
        this rank receives its chunk (:func:`chunk_bounds`).  The wire
        is ``allreduce_grad_dtype`` (``flat`` is cast to it, as the
        allreduce path casts); the chunk is summed, cast back to fp32
        and divided by ``size``, as the JAX package's sharded update
        does.  Returns a :class:`PendingExchange`; with ``async_op``
        the collective runs on the backend's stream until its
        ``wait()``."""
        if flat.numel() % self.size:
            raise ValueError(f"flat length {flat.numel()} is not a "
                             f"multiple of the size {self.size}")
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
        """Every rank's ``chunk``, concatenated in rank order (the
        sharded update's parameters, rebuilt)."""
        out = torch.empty(chunk.numel() * self.size, dtype=chunk.dtype,
                          device=chunk.device)
        dist.all_gather_into_tensor(out, chunk.contiguous(),
                                    group=self.group)
        self.calls["allgather_flat"] += 1
        return out

    def allreduce_grad_async(self, flat):
        """Start the mean of every rank's ``flat`` (already in the wire
        dtype) over the ranks in place, on the backend's stream: the
        double-buffered exchange.  ``wait()`` on the returned
        :class:`PendingExchange` divides by ``size`` (in the wire dtype,
        as :meth:`multi_node_mean_grad`) and returns ``flat``."""
        work = dist.all_reduce(flat, dist.ReduceOp.SUM, group=self.group,
                               async_op=True)
        self.calls["allreduce_grad"] += 1
        size = self.size
        return PendingExchange(work, lambda: flat.div_(size))

    # -- topology manipulation ---------------------------------------------------
    def split(self, color, key):
        """Partition the ranks by ``color`` (MPI_Comm_Split): returns the
        communicator of this rank's color.  ``color``/``key`` are this
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
            bucket_mb=self.bucket_mb, name=self.name)

    def finalize(self):
        """Tear down the process group this communicator set up (a
        split's group, or the world group it initialized); the
        communicator is unusable afterwards."""
        if self.group is not None:
            dist.destroy_process_group(self.group)
        elif self._owns_world:
            dist.destroy_process_group()
        self._owns_world = False

    def __repr__(self):
        return (f"<{type(self).__name__} name={self.name!r} "
                f"size={self.size} device={self.device} "
                f"exchange={self.exchange} "
                f"grad_dtype={self.allreduce_grad_dtype}>")


class ElasticMeshCommunicator(MeshCommunicator):
    """The elastic communicator (membership epochs, resize) of the JAX
    package; not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ElasticMeshCommunicator (elastic membership and resize) is "
            "not ported yet (ROADMAP A11)")
