"""Differentiable point-to-point communication.

The port of ``chainermn_tpu.functions.point_to_point_communication``
(reference: ``chainermn/functions/point_to_point_communication.py · Send,
Recv, send, recv, pseudo_connect``).  The JAX package is SPMD: every rank
traces one program and a transfer is one ``lax.ppermute``, whose
transpose carries the gradient back.  The port is MPMD, as the
reference: each rank runs its own graph, and the reference's machinery
comes back, as ``torch.autograd.Function``\\ s over ``torch.distributed``
point-to-point calls on the communicator's group:

* :func:`send` posts the tensor (``isend``, a header with its shape,
  dtype and whether it needs a gradient going ahead) and returns a
  zero-valued scalar **delegate**; the delegate's backward receives the
  gradient from the peer ("backward triggers a recv");
* :func:`recv` receives it; its backward sends the gradient back;
* :func:`pseudo_connect` fuses a delegate into other tensors, so that a
  rank's backward reaches a send whose output it does not use.

Every rank of a transfer must run its backward: the sender's delegate
waits for the gradient its receiver sends.  Sends never wait: the
request (``isend``) and its buffer stay on the communicator until the
request completes, so that no rank blocks in a send on a receiver that
is itself waiting for it.
A self-edge (``src == dst``, the JAX ``ppermute`` over ``[(r, r)]``, the
identity) is a local hand-off through the communicator with no
collective: the receiving side gets the sent tensor itself, graph and
all.  ``tag`` keeps several transfers between one pair of ranks apart
(``MultiNodeChainList`` numbers each pair's transfers).

:func:`point_to_point` is the SPMD form of the JAX function: every rank
calls it with the same ``(src, dst)``; rank ``dst`` gets ``src``'s ``x``,
the others zeros, and the gradient takes the reversed edge.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["point_to_point", "send", "recv", "pseudo_connect"]


# -- the transfers ---------------------------------------------------------------
#: dtypes a transfer's header can name, by code
_DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.float64,
           torch.int64, torch.int32, torch.int8, torch.uint8, torch.bool)
_MAX_DIMS = 8


def _isend(comm, x, dst, tag):
    """Post ``x`` to ``dst`` without waiting.  The request and its buffer
    stay on the communicator until the request completes: waiting here
    could block on a receiver that is itself waiting for this rank."""
    pending = comm.__dict__.setdefault("_p2p_pending", [])
    pending[:] = [(w, b) for w, b in pending if not w.is_completed()]
    x = x.detach().contiguous()
    pending.append((dist.isend(x, dst=comm._global(dst), group=comm.group,
                               tag=tag), x))
    comm.calls["send"] += 1


def _recv_into(comm, buf, src, tag):
    dist.recv(buf, src=comm._global(src), group=comm.group, tag=tag)
    comm.calls["recv"] += 1
    return buf


def _send_header(comm, x, dst, tag, needs_grad):
    """Shape, dtype and whether the receiver sends a gradient back, ahead
    of the tensor on the same tag (one pair's messages on one tag arrive
    in the order sent)."""
    if x.dim() > _MAX_DIMS:
        raise ValueError(f"send takes at most {_MAX_DIMS} dimensions")
    head = [int(needs_grad), _DTYPES.index(x.dtype), x.dim(), *x.shape]
    head += [0] * (3 + _MAX_DIMS - len(head))
    _isend(comm, torch.tensor(head, dtype=torch.int64, device=comm.device),
           dst, tag)


def _recv_header(comm, src, tag):
    head = _recv_into(comm, torch.empty(3 + _MAX_DIMS, dtype=torch.int64,
                                        device=comm.device), src, tag)
    head = head.tolist()
    return tuple(head[3:3 + head[2]]), _DTYPES[head[1]], bool(head[0])


def _stash(comm):
    return comm.__dict__.setdefault("_p2p_stash", {})


class _Send(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, dst, tag, needs_grad, x):
        ctx.comm, ctx.dst, ctx.tag = comm, dst, tag
        ctx.shape, ctx.dtype = x.shape, x.dtype
        _send_header(comm, x, dst, tag, needs_grad)
        _isend(comm, x, dst, tag)
        return x.new_zeros((), dtype=x.dtype if x.is_floating_point()
                           else torch.float32)

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        grad = torch.empty(ctx.shape, dtype=ctx.dtype, device=comm.device)
        return None, None, None, None, _recv_into(comm, grad, ctx.dst,
                                                  ctx.tag)


class _Recv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, src, tag, shape, dtype, anchor):
        ctx.comm, ctx.src, ctx.tag = comm, src, tag
        ctx.anchor_shape = anchor.shape
        return _recv_into(comm, torch.empty(shape, dtype=dtype,
                                            device=comm.device), src, tag)

    @staticmethod
    def backward(ctx, g):
        _isend(ctx.comm, g, ctx.src, ctx.tag)
        return (None, None, None, None, None,
                g.new_zeros(ctx.anchor_shape))


def send(x, communicator, rank, *, self_rank=None, tag=0):
    """Send ``x`` from this rank to ``rank``; returns the delegate, a
    zero-valued scalar whose backward receives ``x``'s gradient from
    ``rank`` (connect it to this rank's loss, or call its ``backward``).
    ``self_rank`` (the JAX signature's sending stage) must be this rank
    when given.  A send to this rank itself is handed to the matching
    :func:`recv` locally."""
    comm = communicator
    me = comm.rank
    if self_rank is not None and int(self_rank) != me:
        raise ValueError(f"send from stage {self_rank} called on rank {me}: "
                         f"a rank sends only its own tensors")
    rank = int(rank)
    if rank == me:
        _stash(comm).setdefault((tag, me, me), []).append(x)
        return x.reshape(-1).sum() * 0 if x.is_floating_point() \
            else torch.zeros((), device=x.device)
    needs_grad = bool(x.requires_grad and torch.is_grad_enabled())
    return _Send.apply(comm, rank, tag, needs_grad, x)


def recv(communicator, rank, delegate_variable=None, *, self_rank=None,
         tag=0, force_tuple=False):
    """Receive the tensor ``rank`` sent to this rank.  Its backward sends
    the gradient back, when the sender's tensor needed one.  With
    ``delegate_variable`` (a delegate of this rank's earlier sends) the
    result is fused with it (:func:`pseudo_connect`), so this rank's
    graph stays connected through them.  ``self_rank`` must be this rank
    when given."""
    comm = communicator
    me = comm.rank
    if self_rank is not None and int(self_rank) != me:
        raise ValueError(f"recv into stage {self_rank} called on rank {me}")
    rank = int(rank)
    if rank == me:
        queue = _stash(comm).get((tag, me, me))
        if not queue:
            raise RuntimeError(
                f"recv from rank {rank} to {me} (tag {tag}) with no "
                f"matching send: a self-edge hands off locally, so its "
                f"send must come first")
        y = queue.pop(0)
    else:
        shape, dtype, needs_grad = _recv_header(comm, rank, tag)
        if needs_grad and torch.is_grad_enabled():
            anchor = delegate_variable if delegate_variable is not None \
                and delegate_variable.requires_grad \
                else torch.zeros((), device=comm.device, requires_grad=True)
            y = _Recv.apply(comm, rank, tag, shape, dtype, anchor)
        else:
            y = _recv_into(comm, torch.empty(shape, dtype=dtype,
                                             device=comm.device), rank, tag)
    if delegate_variable is not None:
        y = pseudo_connect(delegate_variable, y)
    return (y,) if force_tuple else y


def pseudo_connect(delegate_variable, *actual_variables):
    """Fuse a delegate into ``actual_variables``: each plus zero times
    the delegate, so that backward from them reaches the delegate (and
    the send behind it).  With no actual variable, the delegate."""
    if not actual_variables:
        return delegate_variable
    zero = delegate_variable.reshape(-1).sum() * 0
    connected = tuple(v + zero.to(v.dtype) for v in actual_variables)
    return connected[0] if len(connected) == 1 else connected


# -- the SPMD edge ------------------------------------------------------------------
def permute(comm, x, perm):
    """Every rank's ``x`` moved along the pairs ``perm`` (``[(src, dst),
    ...]``, each rank at most once as a source and once as a
    destination): this rank's result is its source's ``x``, or zeros when
    no pair ends here.  Every rank calls it with the same ``perm`` and an
    ``x`` of one shape and dtype (the JAX ``lax.ppermute``).  Not
    differentiable; :func:`point_to_point` is."""
    me = comm.rank
    dst = next((d for s, d in perm if s == me), None)
    src = next((s for s, d in perm if d == me), None)
    if src == me:
        return x.clone()
    out = torch.zeros_like(x)
    work = None
    if src is not None:
        work = dist.irecv(out, src=comm._global(src), group=comm.group)
        comm.calls["recv"] += 1
    if dst is not None:
        _isend(comm, x, dst, 0)
    if work is not None:
        work.wait()
    return out


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, perm, x):
        ctx.comm, ctx.perm = comm, perm
        return permute(comm, x.detach(), perm)

    @staticmethod
    def backward(ctx, g):
        back = [(d, s) for s, d in ctx.perm]
        return None, None, permute(ctx.comm, g.contiguous(), back)


def point_to_point(x, communicator, src, dst):
    """One transfer edge, called by every rank: rank ``dst`` receives rank
    ``src``'s ``x``, every other rank zeros.  Differentiable: the gradient
    takes the reversed edge.  ``src == dst`` is the identity there."""
    return _Permute.apply(communicator, [(int(src), int(dst))], x)


def ring_shift(x, communicator, offset=1):
    """Differentiable shift around the ring of ranks: rank ``r`` receives
    rank ``r - offset``'s ``x`` (the pipelines' stage-to-stage move)."""
    size = communicator.size
    return _Permute.apply(communicator,
                          [(r, (r + offset) % size) for r in range(size)], x)
