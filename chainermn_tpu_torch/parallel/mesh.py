"""Named axes over process subgroups, for hybrid parallelism.

The port of ``chainermn_tpu.parallel.mesh`` (reference: hybrid DP x MP by
``CommunicatorBase.split`` and two communicators).  The JAX package
builds one N-D device mesh with named axes; here a rank is a process, so
a mesh is the world's ranks laid out row-major over the named axes (the
JAX ``devices.reshape(sizes)``), and each axis's communicator is a
:meth:`~..communicators.MeshCommunicator.split` of the world into the
lines of ranks that differ only along that axis.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Mesh", "make_mesh", "axis_communicators", "shard_batch",
           "replicate"]


class Mesh:
    """Ranks ``0 .. size-1`` of ``comm`` laid out row-major over
    ``axis_names`` (``ranks`` is the array, the JAX ``mesh.devices``)."""

    def __init__(self, comm, ranks, axis_names):
        self.comm = comm
        self.ranks = ranks
        self.axis_names = tuple(axis_names)

    def coords(self, rank=None):
        """``{axis: index}`` of ``rank`` (default: this rank)."""
        rank = self.comm.rank if rank is None else rank
        where = np.argwhere(self.ranks == rank)[0]
        return dict(zip(self.axis_names, (int(i) for i in where)))


def make_mesh(axis_sizes, comm):
    """``make_mesh({"data": 4, "model": 2}, comm)`` over ``comm``'s ranks.
    One size may be -1 (inferred); the product must be ``comm.size``."""
    names = list(axis_sizes)
    sizes = [axis_sizes[n] for n in names]
    unknown = [i for i, s in enumerate(sizes) if s == -1]
    if len(unknown) > 1:
        raise ValueError("at most one axis may be -1")
    known = int(np.prod([s for s in sizes if s != -1]))
    if unknown:
        if comm.size % known:
            raise ValueError(f"{comm.size} ranks not divisible by {known}")
        sizes[unknown[0]] = comm.size // known
    if int(np.prod(sizes)) != comm.size:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} != {comm.size} ranks")
    return Mesh(comm, np.arange(comm.size).reshape(sizes), names)


def axis_communicators(mesh):
    """One communicator per axis, in the mesh's axis order: for axis ``a``
    the ranks that share every other coordinate (a collective split per
    axis, made by every rank in the same order)."""
    comms = {}
    for i, name in enumerate(mesh.axis_names):
        others = np.moveaxis(mesh.ranks, i, -1).reshape(-1,
                                                        mesh.ranks.shape[i])
        color = next(c for c, line in enumerate(others)
                     if mesh.comm.rank in line)
        comms[name] = mesh.comm.split(color, mesh.comm.rank)
    return comms


def shard_batch(x, mesh, axis):
    """This rank's block of ``x``'s leading dim along ``axis`` (the JAX
    function places the whole batch sharded; a rank holds its block)."""
    n = mesh.ranks.shape[mesh.axis_names.index(axis)]
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} not divisible by {n}")
    rows = x.shape[0] // n
    i = mesh.coords()[axis]
    return x[i * rows:(i + 1) * rows]


def replicate(x, mesh):
    """``x`` itself: every rank holds the whole of a replicated value."""
    return x
