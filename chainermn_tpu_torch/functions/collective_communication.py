"""Differentiable collective communication.

The port of ``chainermn_tpu.functions.collective_communication``
(reference: ``chainermn/functions/collective_communication.py ·
AllGather, AllToAll, Bcast, Gather, Scatter, Allreduce``): each function
is a ``torch.autograd.Function`` over the communicator's collectives,
whose backward runs the transposed communication, on every rank, in the
same order:

* ``allreduce``: the gradient is allreduced (sum; mean for ``"mean"``);
* ``allgather`` / ``gather``: each rank receives the sum over the ranks
  of the gradients of its own slot (a reduce-scatter);
* ``alltoall``: the reverse alltoall;
* ``bcast``: the gradients summed on the root, zero elsewhere;
* ``scatter``: the gradients gathered on the root, zero elsewhere;
* ``psum_gradient``: identity forward, mean-allreduce backward.

The scaling is the JAX package's: there a rank is a device of a
``shard_map`` and the loss is computed on every rank, so the transpose
of a sum over ranks hands each rank ``size`` cotangent copies; here a
rank is a process running its own backward of its own copy of the loss,
and these backwards give the same numbers (pinned against the JAX
functions in ``tests/test_torch_collective_functions.py``).
"""

from __future__ import annotations

import torch

__all__ = ["allgather", "alltoall", "bcast", "gather", "scatter",
           "allreduce", "psum_gradient"]


def _reduce_scatter(comm, grads):
    """``sum_r grads_r[me]``: rank ``j`` receives every rank's
    ``grads[j]`` and sums them."""
    return torch.stack(comm.alltoall(list(grads))).sum(0)


def _zeros_for(grads, like):
    return [torch.zeros_like(like) if g is None else g for g in grads]


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x, op):
        ctx.comm, ctx.op = comm, op
        return comm.allreduce(x, op=op)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.allreduce(g, op=ctx.op), None


class _PsumGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.allreduce(g, op="mean")


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return tuple(comm.allgather(x))

    @staticmethod
    def backward(ctx, *grads):
        like = next(g for g in grads if g is not None)
        return None, _reduce_scatter(ctx.comm, _zeros_for(grads, like))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, *xs):
        ctx.comm = comm
        return tuple(comm.alltoall(list(xs)))

    @staticmethod
    def backward(ctx, *grads):
        like = next(g for g in grads if g is not None)
        return (None, *ctx.comm.alltoall(_zeros_for(grads, like)))


class _Bcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x, root):
        ctx.comm, ctx.root = comm, root
        return comm.bcast(x if comm.rank == root else None, root=root)

    @staticmethod
    def backward(ctx, g):
        total = ctx.comm.allreduce(g)
        if ctx.comm.rank != ctx.root:
            return None, None, None
        return None, total, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, xs, root):
        ctx.comm, ctx.root = comm, root
        return comm.scatter(xs if comm.rank == root else None, root=root)

    @staticmethod
    def backward(ctx, g):
        parts = ctx.comm.allgather(g)
        if ctx.comm.rank != ctx.root:
            return None, None, None
        return None, torch.stack(parts), None


class _BcastFromOwner(torch.autograd.Function):
    """``root``'s ``x`` on every rank (the others pass any tensor that
    keeps their graph: its value is not read); backward: the mean over
    the ranks of the output's gradient, on ``root``, zeros elsewhere."""

    @staticmethod
    def forward(ctx, comm, root, x):
        ctx.comm, ctx.root, ctx.shape = comm, root, x.shape
        return comm.bcast(x.detach() if comm.rank == root else None,
                          root=root)

    @staticmethod
    def backward(ctx, g):
        mean = ctx.comm.allreduce(g.contiguous(), op="mean")
        if ctx.comm.rank != ctx.root:
            return None, None, mean.new_zeros(ctx.shape)
        return None, None, mean


def _bcast_from_owner(communicator, x, root):
    """:func:`bcast` for a value every rank then computes the same loss
    on, replication-aware in reverse (the JAX pipeline's
    ``_bcast_from_owner``): each rank backpropagates its own copy of the
    loss, so the owner takes the mean of their gradients, not the sum
    ``size`` times the single-process one.  Every rank runs the backward
    (an allreduce)."""
    return _BcastFromOwner.apply(communicator, root, x)


def allreduce(communicator, x, op="sum"):
    """``op`` ("sum" or "mean") of every rank's ``x``, on every rank."""
    if op not in ("sum", "mean"):
        raise ValueError(f"unsupported op {op!r}")
    return _AllReduce.apply(communicator, x, op)


def psum_gradient(communicator, x):
    """Identity forward, mean-allreduce backward: the "copy into a
    tensor-parallel region" primitive.  A replicated tensor consumed
    slice-wise by the ranks gets from each only its slice's gradient;
    the backward reassembles the whole one (a mean, because every rank
    computes the loss, as in the JAX package)."""
    return _PsumGradient.apply(communicator, x)


def allgather(communicator, x):
    """Every rank's ``x``, as a tuple in rank order."""
    return _AllGather.apply(communicator, x)


def gather(communicator, x, root=0):
    """Every rank's ``x`` as a tuple (meaningful on ``root``; computed on
    every rank, as the JAX function)."""
    return _AllGather.apply(communicator, x)


def alltoall(communicator, xs):
    """``xs[j]`` (a tuple of ``size`` tensors of one shape, or a tensor
    with leading dim ``size``) goes to rank ``j``; returns the tensors
    received, by source rank."""
    if isinstance(xs, torch.Tensor):
        xs = tuple(xs.unbind(0))
    if len(xs) != communicator.size:
        raise ValueError(
            f"alltoall expects {communicator.size} slices, got {len(xs)}")
    return _AllToAll.apply(communicator, *xs)


def bcast(communicator, x, root=0):
    """``root``'s ``x`` on every rank (others pass a tensor of the same
    shape, or ``None``)."""
    return _Bcast.apply(communicator, x, root)


def scatter(communicator, xs, root=0):
    """Rank ``i`` receives ``xs[i]`` of ``root``'s ``xs`` (a tensor with
    leading dim ``size``, or a sequence of ``size`` tensors)."""
    if isinstance(xs, (tuple, list)):
        xs = torch.stack(list(xs))
    return _Scatter.apply(communicator, xs, root)
