"""Ulysses sequence parallelism: an all-to-all between sequence and head
shards.

The port of ``chainermn_tpu.parallel.ulysses``.  The sequence is sharded
over the ranks; for attention an all-to-all re-shards ``[B, H, T/n, D]``
(sequence-split) into ``[B, H/n, T, D]`` (head-split), each rank attends
its head group over the whole sequence, and the reverse all-to-all
restores the sequence split.  Two collectives a layer, each moving the
activations once.  The all-to-all is the port's differentiable
:func:`~..functions.alltoall` (the ``lax.all_to_all(tiled=True)`` twin:
heads split, time concatenated in rank order), whose backward is the
reverse exchange; q, k and v travel in one call, so every rank issues one
exchange each way.
"""

from __future__ import annotations

import torch

from ..functions.collective_communication import alltoall
from ..ops.flash_attention import blockwise_attention

__all__ = ["ulysses_attention", "seq_to_head_shard", "head_to_seq_shard"]


def seq_to_head_shard(comm, x):
    """``[..., H, T_local, D]`` (sequence-sharded) -> ``[..., H/n, T, D]``
    (head-sharded); every rank calls it.  Head group ``j`` goes to rank
    ``j``, the received time blocks concatenate in rank order.  ``H`` must
    divide by ``n``."""
    n = comm.size
    *lead, H, Tl, D = x.shape
    if H % n:
        raise ValueError(f"head count {H} not divisible by axis size {n}")
    parts = x.reshape(*lead, n, H // n, Tl, D).movedim(-4, 0)
    got = torch.stack(alltoall(comm, parts))      # [n (source), ..., H/n, Tl, D]
    return got.movedim(0, -3).reshape(*lead, H // n, n * Tl, D)


def head_to_seq_shard(comm, x):
    """``[..., H/n, T, D]`` (head-sharded) -> ``[..., H, T_local, D]``
    (sequence-sharded): time block ``j`` goes to rank ``j``, the received
    head groups concatenate in rank order."""
    n = comm.size
    *lead, Hn, T, D = x.shape
    parts = x.reshape(*lead, Hn, n, T // n, D).movedim(-3, 0)
    got = torch.stack(alltoall(comm, parts))      # [n (source), ..., H/n, Tl, D]
    return got.movedim(0, -4).reshape(*lead, n * Hn, T // n, D)


def ulysses_attention(comm, q, k, v, causal=False, scale=None):
    """Exact attention with Ulysses sequence parallelism: this rank's
    ``[B, H, T_local, D]`` shards in, its output shard out.  The head
    group's attention over the whole sequence runs through
    :func:`~..ops.flash_attention.blockwise_attention` (the kernels on
    the card, the blockwise plain version on the CPU): no ``[T, T]``
    score matrix."""
    qh, kh, vh = seq_to_head_shard(comm, torch.stack((q, k, v))).unbind(0)
    out = blockwise_attention(qh, kh, vh, causal=causal, scale=scale)
    return head_to_seq_shard(comm, out)
