"""1F1B pipeline schedule: O(S) stored activations.

The port of ``chainermn_tpu.parallel.one_f_one_b``.  GPipe keeps every
microbatch's activations until the backward; 1F1B interleaves each
stage's backward with later microbatches' forwards.  The schedule is the
backward itself: a loop over ``M + 2S - 1`` ticks in which each stage may
run one forward (storing only the stage's input, in a ring of ``2S``
slots) and one backward (the stage recomputed from the stored input,
``torch.autograd.grad`` pulling the cotangent back).  Activations move
one stage forward and cotangents one stage back on every tick, by ring
shifts every rank makes (:func:`~..functions.point_to_point_communication.
permute`), and each rank accumulates its own stage's gradients.

Tick algebra (the JAX package's): the forward of microbatch ``i`` on
stage ``s`` runs at tick ``i + s``, its backward at tick ``i + 2S - 1 -
s``; an input lives ``2(S - s) - 1`` ticks, so ``2S`` slots hold it.
Stage computation runs on valid ticks only (no collective hangs on it),
so a stage singular at the padding value never evaluates there.
"""

from __future__ import annotations

import torch

from ..functions.point_to_point_communication import permute

__all__ = ["one_f_one_b", "make_pipeline_train_step",
           "heterogeneous_stage_fn"]


def heterogeneous_stage_fn(stage_fns, comm):
    """One ``stage_fn`` out of per-stage callables: each rank runs its own
    stage's (``stage_fns[comm.rank]``).  The JAX package switches on the
    stage index inside one SPMD program; a rank here is a process, so the
    switch is made once.  Stages still share the activation shape."""
    fn = stage_fns[comm.rank]

    def stage_fn(params, h):
        return fn(params, h)
    return stage_fn


def one_f_one_b(comm, stage_fn, loss_fn, stage_params, x_microbatches,
                y_microbatches):
    """Run the 1F1B schedule; every rank of ``comm`` calls it, rank ``s``
    with its stage's ``stage_params`` (a sequence of tensors).
    ``stage_fn(params, h) -> h`` keeps ``h``'s shape; ``loss_fn(out, y)
    -> scalar`` runs on the last stage per microbatch.
    ``x_microbatches`` ``[M, mb, ...]`` and ``y_microbatches`` ``[M,
    ...]``, the same on every rank.

    Returns ``(loss, grads)``: the mean per-microbatch loss (on every
    rank) and this rank's stage gradients (d mean loss / d params), fp32
    -- a gradient function, not a differentiable forward."""
    S = comm.size
    stage = comm.rank
    is_last = stage == S - 1
    M = x_microbatches.shape[0]
    zeros_mb = x_microbatches.new_zeros(x_microbatches.shape[1:])
    perm_fwd = [(i, (i + 1) % S) for i in range(S)]
    perm_bwd = [((i + 1) % S, i) for i in range(S)]
    RING = 2 * S
    params = [p.detach().requires_grad_(p.is_floating_point())
              for p in stage_params]
    ring = [None] * RING
    fwd_msg = bwd_msg = zeros_mb
    grad_acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=x_microbatches.device)
    for t in range(M + 2 * S - 1):
        # forward half: stage s runs microbatch f = t - s
        f = t - stage
        fwd_send = zeros_mb
        if 0 <= f < M:
            act_in = x_microbatches[f] if stage == 0 else fwd_msg
            ring[f % RING] = act_in
            with torch.no_grad():
                fwd_send = stage_fn(params, act_in)
        # backward half: stage s backs microbatch b, recomputed from its
        # stored input
        b = t - (2 * S - 1 - stage)
        bwd_send = zeros_mb
        if 0 <= b < M:
            with torch.enable_grad():
                act = ring[b % RING].detach().requires_grad_(True)
                out = stage_fn(params, act)
                if is_last:
                    loss_b = loss_fn(out, y_microbatches[b])
                    cot = torch.autograd.grad(loss_b, out,
                                              retain_graph=True)[0]
                    loss_sum = loss_sum + loss_b.detach().float()
                else:
                    cot = bwd_msg
                *dparams, dact = torch.autograd.grad(
                    out, params + [act], cot, allow_unused=True)
            for acc, g in zip(grad_acc, dparams):
                if g is not None:
                    acc.add_(g.float())
            bwd_send = dact
        # neighbour exchanges: the same two shifts on every rank, every
        # tick
        fwd_msg = permute(comm, fwd_send.contiguous(), perm_fwd)
        bwd_msg = permute(comm, bwd_send.contiguous(), perm_bwd)
    loss = comm.allreduce(loss_sum if is_last else torch.zeros_like(
        loss_sum)) / M
    return loss, [g / M for g in grad_acc]


def make_pipeline_train_step(comm, stage_fn, loss_fn, tx, n_microbatches):
    """A 1F1B training step with an optimizer: ``step(stage_params, x, y)
    -> loss`` splits the batch ``(x, y)`` (the same on every rank) into
    ``n_microbatches``, runs :func:`one_f_one_b` and applies ``tx``'s rule
    to this rank's ``stage_params`` in place (its state kept under the
    parameters' indices).  ``tx`` is an optimizer of
    :mod:`~..core.optimizer` (the JAX function takes an optax
    transform)."""
    from .pipeline import split_microbatches

    def step(stage_params, x, y):
        xm = split_microbatches(x, n_microbatches)
        ym = split_microbatches(y, n_microbatches)
        loss, grads = one_f_one_b(comm, stage_fn, loss_fn, stage_params,
                                  xm, ym)
        tx._apply_to([f"/{i}" for i in range(len(stage_params))],
                     list(stage_params),
                     [g.to(p.dtype) for g, p in zip(grads, stage_params)])
        return loss
    return step
