"""Communicator abstract base.

The port of ``chainermn_tpu.communicators.communicator_base``: the
reference's method vocabulary -- properties ``rank/size/intra_rank/
intra_size/inter_rank/inter_size``, tensor collectives
``send/recv/bcast/gather/allgather/alltoall/allreduce/scatter``, the
pickled-object variants ``*_obj``, the model ops ``bcast_data`` and
``multi_node_mean_grad`` (alias ``allreduce_grad``), and ``split``.

Semantics: the reference's, MPMD.  Each process owns one device and runs
its own copy of the script; ``rank`` is its ``torch.distributed`` rank,
and a collective takes this rank's value and returns what this rank
receives.  (The JAX package is single-controller SPMD, where a rank is a
device along a mesh axis and eager collectives take stacked arrays; the
port does not need that translation.)  One convention is kept from the
JAX package rather than the reference, because the port is held against
it: ``gather`` and ``gather_obj`` return the gathered list on EVERY rank
(root-symmetric), where MPI's gather returns it on ``root`` and ``None``
elsewhere.
"""

from __future__ import annotations

__all__ = ["CommunicatorBase"]


class CommunicatorBase:
    # -- topology ----------------------------------------------------------
    @property
    def rank(self) -> int:
        """This process's rank in the communicator."""
        raise NotImplementedError

    @property
    def size(self) -> int:
        """Number of ranks (the data-parallel degree)."""
        raise NotImplementedError

    @property
    def intra_rank(self) -> int:
        """Rank within the local host (reference: GPU index within node)."""
        raise NotImplementedError

    @property
    def intra_size(self) -> int:
        raise NotImplementedError

    @property
    def inter_rank(self) -> int:
        """Host index (reference: node index)."""
        raise NotImplementedError

    @property
    def inter_size(self) -> int:
        """Number of hosts (reference: number of nodes)."""
        raise NotImplementedError

    # -- tensor collectives --------------------------------------------------
    def send(self, data, dest, tag=0):
        raise NotImplementedError

    def recv(self, source, tag=0):
        raise NotImplementedError

    def bcast(self, data, root=0):
        raise NotImplementedError

    def gather(self, data, root=0):
        """Gather one tensor per rank; EVERY rank receives the tuple.

        Root-symmetric return, as in the JAX package (MPI ``gather``
        returns the list on ``root`` and ``None`` elsewhere).  ``root`` is
        accepted for signature compatibility; code guarding on ``if
        comm.rank == root:`` before using the result works unchanged."""
        raise NotImplementedError

    def allgather(self, x):
        raise NotImplementedError

    def alltoall(self, xs):
        raise NotImplementedError

    def scatter(self, xs, root=0):
        raise NotImplementedError

    def allreduce(self, data, op="sum"):
        raise NotImplementedError

    # -- object (pickle) channel ----------------------------------------------
    def send_obj(self, obj, dest, tag=0):
        raise NotImplementedError

    def recv_obj(self, source, tag=0):
        raise NotImplementedError

    def bcast_obj(self, obj, root=0):
        raise NotImplementedError

    def gather_obj(self, obj, root=0):
        """Gather one picklable object per rank; EVERY rank receives the
        list (root-symmetric, as :meth:`gather`)."""
        raise NotImplementedError

    def allgather_obj(self, obj):
        raise NotImplementedError

    def allreduce_obj(self, obj):
        raise NotImplementedError

    # -- model ops -------------------------------------------------------------
    def bcast_data(self, model):
        """Replicate the model's parameters (and buffers) from rank 0.

        Reference: ``CommunicatorBase.bcast_data``, called once before
        training so that every rank starts from the same weights."""
        raise NotImplementedError

    def multi_node_mean_grad(self, model, zero_fill=False, residual=None):
        """Average ``param.grad`` across ranks in place.  A quantized
        wire takes the error-feedback ``residual`` and returns the new
        one."""
        raise NotImplementedError

    # historical alias (the reference kept both names through the rename)
    def allreduce_grad(self, model, zero_fill=False, residual=None):
        return self.multi_node_mean_grad(model, zero_fill, residual)

    # -- topology manipulation ---------------------------------------------------
    def split(self, color, key):
        """Partition ranks into disjoint sub-communicators (MPI_Comm_Split)."""
        raise NotImplementedError

    # -- lifecycle ------------------------------------------------------------
    def finalize(self):
        pass
