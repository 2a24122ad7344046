"""Differentiable communication (reference: ``chainermn.functions``): the
point-to-point transfers and the collectives."""

from .collective_communication import (allgather, allreduce, alltoall, bcast,
                                       gather, psum_gradient, scatter)
from .point_to_point_communication import (point_to_point, pseudo_connect,
                                           recv, send)

__all__ = ["point_to_point", "send", "recv", "pseudo_connect",
           "allgather", "alltoall", "bcast", "gather", "scatter",
           "allreduce", "psum_gradient"]
