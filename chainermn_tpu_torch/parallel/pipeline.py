"""Microbatched (GPipe) pipeline parallelism.

The port of ``chainermn_tpu.parallel.pipeline``.  The reference's
``MultiNodeChainList`` runs a minibatch through its stages one after
another; here ``M`` microbatches stream through ``S`` stage ranks (one
stage a rank of ``comm``) over ``M + S - 1`` ticks, the activations
moving one stage on every tick over the differentiable ring shift of
:mod:`~..functions.point_to_point_communication`.  Every rank runs the
same tick loop (the JAX package's SPMD program, one process a rank), so
each tick's shift is one collective step on every rank, and torch's
backward runs the shifts' reversed transfers in the reverse order on
every rank.  A stage computes only on its active ticks; an inactive one
passes its input on, so a stage singular at the padding value never
evaluates there.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..functions.collective_communication import _bcast_from_owner
from ..functions.point_to_point_communication import ring_shift

__all__ = ["gpipe_apply", "split_microbatches", "merge_microbatches"]


def split_microbatches(x, n_microbatches):
    """``[B, ...]`` -> ``[M, B/M, ...]``."""
    B = x.shape[0]
    if B % n_microbatches != 0:
        raise ValueError(f"batch {B} not divisible by M={n_microbatches}")
    return x.reshape((n_microbatches, B // n_microbatches) + x.shape[1:])


def merge_microbatches(x):
    return x.reshape((-1,) + x.shape[2:])


def gpipe_apply(comm, stage_fn, stage_params, x_microbatches, remat=False):
    """Run ``x_microbatches`` (``[M, mb, ...]``, the same on every rank)
    through the pipeline; every rank of ``comm`` calls it, rank ``s``
    with its stage's ``stage_params``.  ``stage_fn(params, h) -> h`` must
    keep ``h``'s shape.  Returns the last stage's outputs ``[M, mb,
    ...]`` on every rank, differentiable: each rank's backward gives its
    own ``stage_params`` their gradient (every rank runs the backward).

    Schedule: at tick ``t`` stage ``s`` runs microbatch ``t - s`` when
    ``0 <= t - s < M``.  ``remat=True`` recomputes each stage call in the
    backward (``torch.utils.checkpoint``) instead of keeping its
    activations."""
    S = comm.size
    stage = comm.rank
    M = x_microbatches.shape[0]
    mb_shape = x_microbatches.shape[1:]
    if remat:
        def run(params, h):
            return checkpoint(lambda h_, *p: stage_fn(p, h_), h, *params,
                              use_reentrant=False)
    else:
        run = stage_fn
    first = torch.tensor(stage == 0, device=x_microbatches.device)
    # a leaf that needs a gradient whenever the pipeline does: a stage
    # idle at tick 0 must still record its first shift, whose backward
    # every rank runs
    h_in = x_microbatches.new_zeros(mb_shape).requires_grad_(
        torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_microbatches, *stage_params)))
    outputs = [None] * M
    for t in range(M + S - 1):
        feed = x_microbatches[min(t, M - 1)]
        # stage 0 takes the microbatch; the others their predecessor's
        # output (a tensor select: every rank's shift stays in its graph)
        h = torch.where(first, feed, h_in)
        mb = t - stage
        if 0 <= mb < M:
            h_out = run(stage_params, h)
            if h_out.shape != mb_shape:
                raise ValueError(
                    "gpipe stages must preserve activation shape "
                    f"(got {tuple(h_out.shape)} from {tuple(mb_shape)}); "
                    "fold input/output projections into the first/last "
                    "stage params")
            if stage == S - 1:
                outputs[mb] = h_out
        else:
            h_out = h
        if t < M + S - 2:
            h_in = ring_shift(h_out, comm)
    # the last stage's outputs on every rank; the others hand over their
    # last shift's output, which keeps every shift on their backward
    mine = torch.stack(outputs) if stage == S - 1 else h_in
    return _bcast_from_owner(comm, mine, S - 1)
