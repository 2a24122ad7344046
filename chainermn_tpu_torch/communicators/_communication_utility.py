"""Process-group set-up and rank topology.

The port of ``chainermn_tpu.communicators._communication_utility``.  The
JAX package is single-controller SPMD (one process drives every device of
a host, ``jax.distributed.initialize`` joins the hosts); the port goes
back to the reference's model, one process per GPU, so these helpers set
up a ``torch.distributed`` process group and read the reference's rank
quintuple off it: NCCL serves CUDA tensors, gloo the CPU.
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

__all__ = ["init_ranks", "initialize_distributed", "backend_for",
           "gather_hosts", "resolve_hierarchy", "hierarchy_groups"]

#: how long a collective may wait for its peers before it fails
TIMEOUT = datetime.timedelta(seconds=300)


def backend_for(device):
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(device):
    """Join the default process group if it is not set up yet; returns
    True when this call created it.

    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` (what
    ``torchrun`` sets) join a world of several processes; with none of
    them set this process is a world of one, the counterpart of the JAX
    package's single controller.  The backend follows ``device``.  On a
    CUDA device each process takes the card ``LOCAL_RANK`` names (0 by
    default): NCCL cannot put two ranks on one card."""
    if dist.is_initialized():
        return False
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", device.index
                                                 or 0)))
    backend = backend_for(device)
    if "RANK" in os.environ or "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)
    return True


def gather_hosts(group=None):
    """Every rank's host name, in rank order (an allgather over
    ``group``; collective)."""
    hosts = [None] * dist.get_world_size(group)
    dist.all_gather_object(hosts, socket.gethostname(), group=group)
    return hosts


def init_ranks(group=None, hosts=None):
    """This process's ``(global_rank, intra_rank, intra_size, inter_rank,
    inter_size)`` in ``group``: the reference's quintuple, a host's ranks
    found by an allgather of the host names (the reference's ``init_ranks``
    does the same over MPI; ``hosts`` takes a list :func:`gather_hosts`
    already made).  Collective unless ``hosts`` is given: every rank of
    the group calls it."""
    if hosts is None:
        hosts = gather_hosts(group)
    me = dist.get_rank(group)
    order = list(dict.fromkeys(hosts))    # hosts by first appearance
    mine = hosts[me]
    return (me, hosts[:me].count(mine), hosts.count(mine),
            order.index(mine), len(order))


def resolve_hierarchy(world, intra_size=None, inter_size=None, hosts=None):
    """``(inter, intra)`` of the two-level split of ``world`` ranks, the
    JAX ``MeshCommunicator._resolve_hierarchy`` with its errors: sizes
    given win (the forced split of the CPU tests); without them the hosts
    decide, one inter-node group member per host and the ranks of a host
    as its intra-node group.  ``hosts``: every rank's host name, in rank
    order.  A layout that is not ``inter`` hosts of ``intra`` consecutive
    ranks each (a ragged or interleaved one) has no canonical split and
    raises.  Rank ``r`` sits at ``(dcn_index, ici_index) = divmod(r,
    intra)``, as the JAX mesh ``devices.reshape(inter, intra)``."""
    if intra_size is not None and inter_size is not None:
        if intra_size * inter_size != world:
            raise ValueError(
                f"intra_size({intra_size}) × inter_size({inter_size})"
                f" != device count {world}")
        return int(inter_size), int(intra_size)
    if inter_size is not None:
        if inter_size < 1 or world % inter_size:
            raise ValueError(
                f"inter_size={inter_size} does not divide the "
                f"device count {world}")
        return int(inter_size), world // int(inter_size)
    if intra_size is not None:
        if intra_size < 1 or world % intra_size:
            raise ValueError(
                f"intra_size={intra_size} does not divide the "
                f"device count {world}")
        return world // int(intra_size), int(intra_size)
    order = list(dict.fromkeys(hosts))
    inter = len(order)
    intra = world // inter
    if world % inter or any(hosts[r] != order[r // intra]
                            for r in range(world)):
        raise ValueError(
            f"cannot infer a (dcn, ici) split: {world} ranks over {inter} "
            f"hosts, not {inter} runs of equal length; pass "
            f"intra_size=/inter_size=")
    return inter, intra


def hierarchy_groups(inter, intra, group=None, backend=None):
    """The two sets of subgroups of the split, built collectively:
    ``(intra_group, inter_group)`` of this rank.  The intra-node groups
    are the runs ``[d * intra, (d + 1) * intra)``, the inter-node groups
    the strides ``{d * intra + i}``, in ranks of ``group``, which must
    span the world (a ``torch.distributed`` group made without local
    synchronization is created by every rank): every rank creates every
    group, intra-node ones first, in one fixed order."""
    if group is not None and dist.get_world_size(group) \
            != dist.get_world_size():
        raise ValueError(
            "a hierarchical communicator needs a group over the whole "
            f"world ({dist.get_world_size()} ranks), got one of "
            f"{dist.get_world_size(group)}")
    to_world = (lambda r: r) if group is None \
        else (lambda r: dist.get_global_rank(group, r))
    out = []
    for sets in ([[d * intra + i for i in range(intra)]
                  for d in range(inter)],
                 [[d * intra + i for d in range(inter)]
                  for i in range(intra)]):
        mine, _ = dist.new_subgroups_by_enumeration(
            [[to_world(r) for r in s] for s in sets], backend=backend)
        out.append(mine)
    return tuple(out)
