"""Differentiable communication (reference: ``chainermn.functions``).
The point-to-point functions are not ported yet (ROADMAP A7)."""

from .collective_communication import (allgather, allreduce, alltoall, bcast,
                                       gather, psum_gradient, scatter)

__all__ = ["allgather", "alltoall", "bcast", "gather", "scatter",
           "allreduce", "psum_gradient"]
