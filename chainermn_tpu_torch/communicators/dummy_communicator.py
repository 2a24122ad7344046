"""No-op communicator.

The port of ``chainermn_tpu.communicators.dummy_communicator`` (reference:
``DummyCommunicator``), used to measure the non-communication share of a
run and in API-shape tests.  Every collective is the size-1 identity and
``multi_node_mean_grad`` does nothing, so a training loop built for a real
communicator runs unchanged with no communication at all.
"""

from __future__ import annotations

import torch

from .communicator_base import CommunicatorBase

__all__ = ["DummyCommunicator"]


class DummyCommunicator(CommunicatorBase):
    def __init__(self):
        self.name = "dummy"
        self._mailbox = []
        self._obj_mailbox = []

    rank = property(lambda self: 0)
    size = property(lambda self: 1)
    intra_rank = property(lambda self: 0)
    intra_size = property(lambda self: 1)
    inter_rank = property(lambda self: 0)
    inter_size = property(lambda self: 1)

    def send(self, data, dest, tag=0):
        self._mailbox.append(torch.as_tensor(data))

    def recv(self, source, tag=0):
        return self._mailbox.pop(0)

    def bcast(self, data, root=0):
        return torch.as_tensor(data)

    def gather(self, data, root=0):
        return (torch.as_tensor(data),)

    def allgather(self, x):
        return (torch.as_tensor(x),)

    def alltoall(self, xs):
        return tuple(xs)

    def scatter(self, xs, root=0):
        return torch.as_tensor(xs[0])

    def allreduce(self, data, op="sum"):
        return torch.as_tensor(data)

    def multi_node_mean(self, data):
        return torch.as_tensor(data)

    def send_obj(self, obj, dest, tag=0):
        self._obj_mailbox.append(obj)

    def recv_obj(self, source, tag=0):
        return self._obj_mailbox.pop(0)

    def bcast_obj(self, obj, root=0):
        return obj

    def gather_obj(self, obj, root=0):
        return [obj]

    def allgather_obj(self, obj):
        return [obj]

    def allreduce_obj(self, obj):
        return obj

    def bcast_data(self, model):
        return model

    def multi_node_mean_grad(self, model, zero_fill=False, residual=None):
        return residual

    def split(self, color, key):
        return self
