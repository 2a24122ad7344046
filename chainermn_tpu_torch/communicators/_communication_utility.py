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

__all__ = ["init_ranks", "initialize_distributed", "backend_for"]

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


def init_ranks(group=None):
    """This process's ``(global_rank, intra_rank, intra_size, inter_rank,
    inter_size)`` in ``group``: the reference's quintuple, a host's ranks
    found by an allgather of the host names (the reference's ``init_ranks``
    does the same over MPI).  Collective: every rank of the group calls
    it."""
    hosts = [None] * dist.get_world_size(group)
    me = dist.get_rank(group)
    dist.all_gather_object(hosts, socket.gethostname(), group=group)
    order = list(dict.fromkeys(hosts))    # hosts by first appearance
    mine = hosts[me]
    return (me, hosts[:me].count(mine), hosts.count(mine),
            order.index(mine), len(order))
