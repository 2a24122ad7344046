"""Multi-node (sync) batch normalization.

Reference: ``chainermn/links/batch_normalization.py ·
MultiNodeBatchNormalization``; the port of ``chainermn_tpu.links.
batch_normalization``.  The statistics cover the global batch: the two
fp32 accumulators of ``F.batch_moments`` (``E[x]`` and ``E[x^2]``) are
averaged over the communicator in ONE allreduce of the stacked vectors,
and the variance is formed after it.  The allreduce is differentiable: its
backward averages the cotangents over the ranks, the transpose the JAX
package gets from ``lax.pmean`` (and the reference's hand-written
backward communication).  In a world of one it is the base link.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nn.links import BatchNormalization

__all__ = ["MultiNodeBatchNormalization"]


class _AllreduceMean(torch.autograd.Function):
    """``comm``'s mean of ``x`` over the ranks; the backward is the mean
    of the cotangents (every rank runs it, in the same order)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.allreduce(x, op="mean")

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.allreduce(g, op="mean"), None


class MultiNodeBatchNormalization(BatchNormalization):
    def __init__(self, size, comm, decay=0.9, eps=2e-5, dtype=None,
                 use_gamma=True, use_beta=True, initial_gamma=None,
                 initial_beta=None, communication_backend="auto",
                 axis=None, device=None):
        # communication_backend: the reference's signature (mpi or nccl
        # there); the communicator's process group decides here
        super().__init__(size, decay=decay, eps=eps,
                         dtype=dtype or np.float32, use_gamma=use_gamma,
                         use_beta=use_beta, initial_gamma=initial_gamma,
                         initial_beta=initial_beta, axis=axis,
                         device=device)
        self.comm = comm
        self.communication_backend = communication_backend

    def _sync_moments(self, mean, sq_mean, x):
        if self.comm.size == 1:
            return mean, sq_mean
        both = _AllreduceMean.apply(torch.stack([mean, sq_mean]), self.comm)
        return both[0], both[1]

    def _moment_count(self, x, axis):
        return super()._moment_count(x, axis) * self.comm.size
