"""Parameter containers on ``torch.nn.Module``.

The JAX package's ``Link`` / ``Chain`` / ``ChainList`` keep Chainer's
shape (named parameters and child links, ``namedparams``) over pytrees
for ``jit``.  Here a link is an ``nn.Module`` and a chain list an
``nn.ModuleList``; what stays is the Chainer vocabulary, and in
particular the parameter paths: ``namedparams()`` yields the JAX paths
(``/blocks/0/attn/qkv/W``) so that weights map one to one between the two
packages (``serializers.npz``).  A parameter is a ``torch.nn.Parameter``
and its gradient is its ``.grad``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["Link", "Chain", "ChainList"]


class Link(nn.Module):
    """Base parameter container (``chainer.Link`` on ``nn.Module``)."""

    def namedparams(self, prefix=""):
        """``(path, parameter)`` pairs, the path in the JAX package's form:
        ``/`` + the module path with ``/`` separators."""
        for name, p in self.named_parameters():
            yield prefix + "/" + name.replace(".", "/"), p

    def params(self):
        for _, p in self.namedparams():
            yield p

    def namedlinks(self, skipself=False):
        """``(path, link)`` pairs in the JAX form (``/`` for this link,
        ``/blocks/0/attn`` below it)."""
        for name, module in self.named_modules():
            if name:
                yield "/" + name.replace(".", "/"), module
            elif not skipself:
                yield "/", module

    def cleargrads(self):
        for p in self.params():
            p.grad = None

    def zerograds(self):
        for p in self.params():
            p.grad = torch.zeros_like(p)

    def serialize(self, serializer):
        """The Chainer serializer protocol over the parameters
        (``serializer(name, value)`` and ``serializer[child]``): a writer
        receives host arrays, a reader's arrays are copied in place."""
        for name, p in self._parameters.items():
            if p is None:
                continue
            data = serializer(name, p.detach().cpu().numpy())
            if data is not None and not serializer.is_writer:
                data = np.asarray(data)
                if data.shape != tuple(p.shape):
                    raise ValueError(f"{name}: shape {data.shape} does not "
                                     f"match the parameter's "
                                     f"{tuple(p.shape)}")
                with torch.no_grad():
                    p.copy_(torch.from_numpy(np.array(data, np.float32)))
        for cname, child in self._modules.items():
            if isinstance(child, Link):
                child.serialize(serializer[cname])


class Chain(Link):
    """Link composed of named child links (``chainer.Chain``)."""


class ChainList(nn.ModuleList, Link):
    """Ordered list of child links (``chainer.ChainList``); child ``i`` is
    named ``str(i)``, as in the JAX package."""

    def __init__(self, *links):
        super().__init__(links)
