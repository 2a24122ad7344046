"""Ring attention: sequence (context) parallelism over a communicator.

The port of ``chainermn_tpu.parallel.ring_attention``.  The sequence is
sharded over the ranks (``[B, H, T/n, D]`` each).  Each rank keeps its
query block and the key/value blocks travel round the ring; each arriving
block's contribution comes from :func:`~..ops.flash_attention.
attention_with_lse` (the lse forward and backward kernels on the card,
the blockwise plain version on the CPU; neither holds a ``[Tq, Tk]``
score matrix) and is merged into the running result exactly through the
row log-sum-exp:

    lse' = logaddexp(lse, lse_b)
    out' = out exp(lse - lse') + out_b exp(lse_b - lse')

so the result is attention over the whole sequence.  The merge weights
depend on ``lse``, so the backward hands each block a non-zero lse
cotangent (the kernels fold it into the delta pass).

Causal masking follows the chunks, with two schedules:

* ``"naive"``: contiguous shards (rank ``i`` holds chunk ``i``).  Rank 0
  computes one block, rank ``n - 1`` all ``n``: the step time is the last
  rank's.
* ``"zigzag"``: rank ``i`` holds half-chunks ``i`` and ``2n - 1 - i`` of
  ``2n`` (:func:`zigzag_shard` / :func:`zigzag_unshard`), and every rank
  computes two half-block equivalents at every step.

The port is MPMD: each rank runs its own graph, and the ranks of the
naive schedule take different branches.  So that every rank issues the
backward's transfers in one order, the keys and values travel as ONE
stacked ``[2, B, H, T/n, D]`` tensor (one :func:`ring_shift` a step, one
chain of transfers in the backward), and a branch that reads no key
(``skip``) still ties the block to its result with a zero, so that every
rank runs every transfer's backward.  The branch bodies and the step
(:func:`_ring_step`) are functions of plain tensors with the rotation
outside them, so one process can replay an ``n``-rank schedule.
"""

from __future__ import annotations

import numpy as np
import torch

from ..functions.point_to_point_communication import ring_shift
from ..ops.flash_attention import _scale, attention_with_lse

__all__ = ["ring_self_attention", "ring_attention", "zigzag_shard",
           "zigzag_unshard"]

_NEG_INF = float("-inf")


def _masked(x, keep):
    """``x`` where ``keep``, else 0: what enters an ``exp`` there is
    finite, so the backward of the branch ``torch.where`` drops stays
    finite (``exp(-inf - -inf)`` would send NaN through it)."""
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _merge_blocks(out, lse, out_b, lse_b):
    """Exact merge of two attention partials by their lse weights.  A
    partial with lse ``-inf`` (no live key) weighs exactly 0, and two of
    them merge to out 0, lse ``-inf``, with finite gradients (the JAX
    ``logaddexp`` has them; ``torch.logaddexp(-inf, -inf)`` does not)."""
    m = torch.maximum(lse, lse_b)
    live = torch.isfinite(m)
    m0 = _masked(m, live)
    s = torch.exp(lse - m0) + torch.exp(lse_b - m0)
    lse_new = torch.where(live, m0 + torch.log(torch.where(live, s, 1.0)),
                          _NEG_INF)
    fa, fb = torch.isfinite(lse), torch.isfinite(lse_b)
    w_a = torch.where(fa, torch.exp(_masked(lse, fa) - _masked(lse_new, fa)),
                      0.0)
    w_b = torch.where(fb, torch.exp(_masked(lse_b, fb)
                                    - _masked(lse_new, fb)), 0.0)
    return out * w_a[..., None] + out_b * w_b[..., None], lse_new


# -- zigzag layout -------------------------------------------------------------

def _zigzag_perm(T, size):
    """Global index permutation, contiguous order -> zigzag order
    (rank-major: rank ``i``'s slice is half-chunks ``i`` and
    ``2n - 1 - i``)."""
    if T % (2 * size):
        raise ValueError(f"zigzag layout needs T ({T}) divisible by "
                         f"2·size ({2 * size})")
    h = T // (2 * size)
    chunks = np.arange(T).reshape(2 * size, h)
    return np.concatenate([
        np.concatenate([chunks[i], chunks[2 * size - 1 - i]])
        for i in range(size)])


def zigzag_shard(x, size, axis=2):
    """Reorder a whole sequence axis into the zigzag layout, so that an
    even split over ``size`` ranks gives each rank its two half-chunks
    (host-side data preparation; position ids and targets too)."""
    perm = torch.from_numpy(_zigzag_perm(x.shape[axis], size))
    return torch.index_select(x, axis, perm.to(x.device))


def zigzag_unshard(x, size, axis=2):
    """Inverse of :func:`zigzag_shard` on the gathered sequence axis."""
    perm = _zigzag_perm(x.shape[axis], size)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return torch.index_select(x, axis, torch.from_numpy(inv).to(x.device))


def _causal_branch(schedule, kv_chunk, my_chunk):
    """The branch of a ring step, shared with the schedule-balance test.

    naive: 0 past (dense), 1 diagonal (causal), 2 future (skip);
    zigzag: 0 past rank (all q x the early KV half), 1 self (the
    diagonals), 2 future rank (the late q half x all KV).  In dense
    half-block units the naive branches weigh {4, 2, 0} and the zigzag
    ones {2, 2, 2}: the zigzag row is constant, which is its balance.
    The selector is the same for both schedules; ``schedule`` is kept for
    the balance test's weights."""
    del schedule
    if kv_chunk == my_chunk:
        return 1
    return 0 if kv_chunk < my_chunk else 2


# -- the branches: functions of plain tensors -----------------------------------

def _att(q, k, v, causal, scale):
    o, s = attention_with_lse(q, k, v, causal=causal, scale=scale)
    return o.float(), s


def _dense(q, k, v, scale):
    return _att(q, k, v, False, scale)


def _diag(q, k, v, scale):
    return _att(q, k, v, True, scale)


def _skip(q, k, v, scale):
    """No live key: out 0 and lse ``-inf``, built here (a kernel gives a
    fully masked row a finite lse).  The zero tie keeps k and v in the
    graph, so this rank still runs the rotation's backward."""
    B, H, Tq, D = q.shape
    tie = (k[0, 0, 0, 0] + v[0, 0, 0, 0]).float() * 0
    return (q.new_zeros((B, H, Tq, D), dtype=torch.float32) + tie,
            q.new_full((B, H, Tq), _NEG_INF, dtype=torch.float32) + tie)


def _past(q, k, v, scale):
    """A KV rank before mine: both my half-chunks lie after its early
    half and before its late one: all of q, dense, on the early half."""
    h = q.shape[2] // 2
    return _att(q, k[:, :, :h], v[:, :, :h], False, scale)


def _future(q, k, v, scale):
    """A KV rank after mine: only my late half-chunk lies after its
    halves: the late q half, dense, on all of KV; the early half gets no
    live key."""
    B, H, Tq, D = q.shape
    h = Tq // 2
    o, s = _att(q[:, :, h:], k, v, False, scale)
    return (torch.cat([o.new_zeros((B, H, h, D)), o], dim=2),
            torch.cat([s.new_full((B, H, h), _NEG_INF), s], dim=2))


def _diagonal(q, k, v, scale):
    """My own KV: the early diagonal (causal), late x early (dense) and
    the late diagonal (causal)."""
    h = q.shape[2] // 2
    o1, s1 = _att(q[:, :, :h], k[:, :, :h], v[:, :, :h], True, scale)
    o2a, s2a = _att(q[:, :, h:], k[:, :, :h], v[:, :, :h], False, scale)
    o2b, s2b = _att(q[:, :, h:], k[:, :, h:], v[:, :, h:], True, scale)
    o2, s2 = _merge_blocks(o2a, s2a, o2b, s2b)
    return torch.cat([o1, o2], dim=2), torch.cat([s1, s2], dim=2)


_BRANCHES = {"naive": (_dense, _diag, _skip),
             "zigzag": (_past, _diagonal, _future)}


def _ring_step(q, k, v, kv_chunk, my_chunk, schedule, causal, scale):
    """One ring step: ``(out_b, lse_b)`` (fp32 out) of this rank's q
    against the KV block of chunk ``kv_chunk``."""
    if not causal:
        return _dense(q, k, v, scale)
    branch = _causal_branch(schedule, kv_chunk, my_chunk)
    return _BRANCHES[schedule][branch](q, k, v, scale)


def _ring_replay(q, k, v, n, schedule="naive", causal=False, scale=None):
    """One process's replay of an ``n``-rank ring on whole ``[B, H, T,
    D]`` tensors in the ranks' layout (zigzag-sharded for ``"zigzag"``):
    every rank's chunk against each step's KV chunk through
    :func:`_ring_step`, merged in the ring's order.  Returns the ranks'
    output blocks concatenated; differentiable.  The ring itself runs one
    rank a process; this runs its arithmetic where the ranks cannot be
    put side by side (NCCL takes one rank a card)."""
    scale = _scale(scale, q.shape[-1])
    qs, ks, vs = ([c.contiguous() for c in x.chunk(n, dim=2)]
                  for x in (q, k, v))
    outs = []
    for me in range(n):
        out = lse = None
        for step in range(n):
            c = (me - step) % n
            out_b, lse_b = _ring_step(qs[me], ks[c], vs[c], c, me, schedule,
                                      causal, scale)
            if out is None:
                out, lse = out_b, lse_b
            else:
                out, lse = _merge_blocks(out, lse, out_b, lse_b)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=2)


def ring_self_attention(comm, q, k, v, causal=False, scale=None,
                        schedule="naive"):
    """Exact self-attention over a sequence sharded on ``comm``'s ranks.

    ``q``/``k``/``v``: this rank's ``[B, H, T_local, D]`` blocks (every
    rank calls this); returns its ``[B, H, T_local, D]`` output block.
    ``schedule`` (causal only): ``"naive"`` (contiguous chunks) or
    ``"zigzag"`` (the balanced layout of :func:`zigzag_shard`)."""
    B, H, Tq, D = q.shape
    if causal and k.shape[2] != Tq:
        raise ValueError(
            "causal ring attention requires equal local q/KV lengths "
            f"(got Tq={Tq}, Tk={k.shape[2]}); unequal lengths are "
            "supported for causal=False (cross-attention)")
    if schedule not in _BRANCHES:
        raise ValueError(f"unknown ring schedule {schedule!r}")
    if causal and schedule == "zigzag" and Tq % 2:
        raise ValueError(f"zigzag schedule needs an even local length "
                         f"(got {Tq}); see zigzag_shard")
    scale = _scale(scale, D)
    size, me = comm.size, comm.rank
    kv = torch.stack((k, v))
    out = lse = None
    for step in range(size):
        if step:
            kv = ring_shift(kv, comm)
        # the block held now came from rank (me - step) mod size
        out_b, lse_b = _ring_step(q, kv[0], kv[1], (me - step) % size, me,
                                  schedule, causal, scale)
        if out is None:
            out, lse = out_b, lse_b
        else:
            out, lse = _merge_blocks(out, lse, out_b, lse_b)
    return out.to(q.dtype)


def ring_attention(comm, q, k, v, causal=False, scale=None):
    """Cross-attention form: the same rotation; ``q`` and KV may have
    different local lengths (``causal=False`` only)."""
    return ring_self_attention(comm, q, k, v, causal=causal, scale=scale)
