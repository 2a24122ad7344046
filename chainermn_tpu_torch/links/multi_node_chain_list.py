"""Model-parallel chain composition.

The port of ``chainermn_tpu.links.multi_node_chain_list`` (reference:
``chainermn/links/multi_node_chain_list.py · MultiNodeChainList``).
Components registered with ``add_link(link, rank_in=, rank_out=,
rank=)`` run on their owner rank, receive their inputs from ``rank_in``
and send their output to ``rank_out`` over the differentiable
point-to-point functions; rank lists fan out and in.

The JAX package runs the whole list as one SPMD program on every rank.
The port is MPMD, as the reference, with the JAX package's conventions:

* every rank constructs the whole list (``add_link``'s ``rank`` defaults
  to the registration order), so parameter paths (``/mn_component_0/...``)
  and npz snapshots match the JAX package's;
* each rank runs only the components it owns, receiving and sending on
  the registered edges; each ``(src, dst)`` pair numbers its transfers
  (the ``tag``), so several edges between one pair stay apart;
* the terminal component's output is broadcast from its owner, so every
  rank returns it (the loss).  Its backward averages the ranks'
  gradients of the output onto the owner: every rank runs the backward
  of its own copy of the loss, so a sum would hand the owner ``size``
  times the gradient.  This rank's send delegates are fused into the
  broadcast's input (:func:`pseudo_connect`), so that its backward runs
  first on every rank (it is a collective) and then reaches every send;
* a component's floating persistent values (batch norm's statistics) are
  broadcast from its owner after a training forward (the JAX
  ``_fix_persistent_to_owner``).

Every rank calls the list and the backward of what it returns.  The
parameters of a component another rank owns get no gradient here: they
are marked (``_mn_not_owned``), and the multi-node optimizer leaves them
out of its exchange and update, as ``Optimizer.update`` leaves out
parameters without a gradient.  A rank therefore holds the initial
values of the components it does not own.
"""

from __future__ import annotations

import torch

from ..core.config import config
from ..core.link import Chain
from ..functions.collective_communication import _bcast_from_owner
from ..functions.point_to_point_communication import (pseudo_connect, recv,
                                                      send)

__all__ = ["MultiNodeChainList"]


def _as_list(x):
    if x is None:
        return None
    return list(x) if isinstance(x, (list, tuple)) else [x]


class MultiNodeChainList(Chain):
    """A chain of components, each owned by one rank of ``comm``."""

    def __init__(self, comm):
        super().__init__()
        self._comm = comm
        self._components = []   # (name, owner, rank_in, rank_out, pass_inputs)

    def add_link(self, link, rank_in=None, rank_out=None, rank=None,
                 pass_inputs=False):
        """Register a component.  ``rank``: its owner (default: the
        registration order).  ``rank_in``: the rank(s) whose outputs feed
        it, in order (``None``: the list's own inputs).  ``rank_out``: the
        rank(s) its output goes to (``None``: the terminal output).
        ``pass_inputs``: the list's inputs follow the received values
        (the decoder's teacher-forcing batch)."""
        index = len(self._components)
        name = f"mn_component_{index}"
        setattr(self, name, link)
        owner = index if rank is None else int(rank)
        self._components.append((name, owner, _as_list(rank_in),
                                 _as_list(rank_out), pass_inputs))
        if owner != self._comm.rank:
            for p in link.parameters():
                p._mn_not_owned = True
        return link

    def forward(self, *inputs):
        comm = self._comm
        terminals = [c for c in self._components if c[3] is None]
        if not terminals:
            raise ValueError("no terminal component (rank_out=None)")
        if len(terminals) > 1:
            raise ValueError(
                "multiple terminal components (rank_out=None); fan-in the "
                "graph explicitly instead")
        me = comm.rank
        send_seq, recv_seq = {}, {}

        def next_tag(table, src, dst):
            n = table.get((src, dst), 0)
            table[(src, dst)] = n + 1
            return n

        delegates = []
        terminal = None
        for name, owner, rank_in, rank_out, pass_inputs in self._components:
            # every rank numbers every edge, so the tags agree
            in_tags = [(src, next_tag(recv_seq, src, owner))
                       for src in rank_in or ()]
            out_tags = [(dst, next_tag(send_seq, owner, dst))
                        for dst in rank_out or ()]
            if owner != me:
                continue
            if rank_in is None:
                x_in = inputs
            else:
                x_in = tuple(recv(comm, src, self_rank=owner, tag=tag)
                             for src, tag in in_tags)
                if pass_inputs:
                    x_in = x_in + inputs
            y = getattr(self, name)(*x_in)
            if rank_out is None:
                terminal = y
            for dst, tag in out_tags:
                delegates.append(send(y, comm, dst, self_rank=owner,
                                      tag=tag))
        if config.train:
            self._fix_persistent_to_owner()
        root = terminals[0][1]
        if me != root:
            terminal = torch.zeros((), device=comm.device,
                                   requires_grad=torch.is_grad_enabled())
        for d in delegates:
            terminal = pseudo_connect(d, terminal)
        return _bcast_from_owner(comm, terminal, root)

    def _fix_persistent_to_owner(self):
        """Every component's floating persistent values from its owner, on
        every rank (in registration order: a collective per value)."""
        comm = self._comm
        with torch.no_grad():
            for name, owner, *_ in self._components:
                for _, value in getattr(self, name).namedpersistent():
                    if value.is_floating_point():
                        value.copy_(comm.bcast(
                            value if comm.rank == owner else None,
                            root=owner))
