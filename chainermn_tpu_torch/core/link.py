"""Parameter containers on ``torch.nn.Module``.

The JAX package's ``Link`` / ``Chain`` / ``ChainList`` keep Chainer's
shape (named parameters and child links, ``namedparams``) over pytrees
for ``jit``.  Here a link is an ``nn.Module`` and a chain list an
``nn.ModuleList``; what stays is the Chainer vocabulary, and in
particular the parameter paths: ``namedparams()`` yields the JAX paths
(``/blocks/0/attn/qkv/W``) so that weights map one to one between the two
packages (``serializers.npz``).
"""

from __future__ import annotations

from torch import nn

__all__ = ["Link", "Chain", "ChainList"]


class Link(nn.Module):
    """Base parameter container (``chainer.Link`` on ``nn.Module``)."""

    def namedparams(self, prefix=""):
        """``(path, parameter)`` pairs, the path in the JAX package's form:
        ``/`` + the module path with ``/`` separators."""
        for name, p in self.named_parameters():
            yield prefix + "/" + name.replace(".", "/"), p


class Chain(Link):
    """Link composed of named child links (``chainer.Chain``)."""


class ChainList(nn.ModuleList, Link):
    """Ordered list of child links (``chainer.ChainList``); child ``i`` is
    named ``str(i)``, as in the JAX package."""

    def __init__(self, *links):
        super().__init__(links)
