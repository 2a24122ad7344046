"""Parameter containers on ``torch.nn.Module``.

The JAX package's ``Link`` / ``Chain`` / ``ChainList`` keep Chainer's
shape (named parameters and child links, ``namedparams``) over pytrees
for ``jit``.  Here a link is an ``nn.Module`` and a chain list an
``nn.ModuleList``; what stays is the Chainer vocabulary, and in
particular the paths: ``namedparams()`` and ``namedpersistent()`` yield
the JAX paths (``/blocks/0/attn/qkv/W``, ``/res2/0/a/bn/avg_mean``) so
that weights and running statistics map one to one between the two
packages (``serializers.npz``).  A parameter is a ``torch.nn.Parameter``
and its gradient is its ``.grad``; a lazy parameter (its shape known at
the first call) is an ``UninitializedParameter`` until then.  A
persistent value (``add_persistent``) is a registered buffer.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import is_lazy

__all__ = ["Parameter", "Link", "Chain", "ChainList"]


class Parameter(nn.Parameter):
    """A trainable array (``chainer.Parameter``; the JAX package's
    ``Parameter(array, name=None)``): a ``torch.nn.Parameter`` made from
    a host array (or a tensor) on ``device``, fp32 as given.  A link that
    holds raw parameters (the MoE layer's expert bank) assigns them as
    attributes, and their paths are the attribute names, as in the JAX
    package.  ``array`` is the tensor itself; the gradient is ``.grad``.
    ``name`` is kept as ``param_name`` (a tensor's ``name`` is torch's
    named-dimension attribute)."""

    def __new__(cls, array=None, name=None, device=None,
                requires_grad=True):
        if array is None:
            data = torch.empty(0, device=device)
        elif isinstance(array, torch.Tensor):
            data = array.detach().to(device)
        else:
            data = torch.from_numpy(np.array(array)).to(device)
        self = super().__new__(cls, data, requires_grad)
        self.param_name = name
        return self

    def __deepcopy__(self, memo):
        if id(self) not in memo:
            memo[id(self)] = type(self)(
                self.data.clone(memory_format=torch.preserve_format),
                name=self.param_name, requires_grad=self.requires_grad)
        return memo[id(self)]

    @property
    def array(self):
        return self

    def cleargrad(self):
        self.grad = None

    def zerograd(self):
        self.grad = torch.zeros_like(self)


def _copy_array(dst, data, name):
    """Copy host ``data`` into the tensor ``dst`` in place, in ``dst``'s
    dtype; a lazy parameter takes ``data``'s shape first."""
    data = np.asarray(data)
    if is_lazy(dst):
        dst.materialize(data.shape)
    if data.shape != tuple(dst.shape):
        raise ValueError(f"{name}: shape {data.shape} does not match "
                         f"the model's {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(data)).to(dst.dtype))


class Link(nn.Module):
    """Base parameter container (``chainer.Link`` on ``nn.Module``)."""

    @contextlib.contextmanager
    def init_scope(self):
        """Chainer's registration scope.  ``nn.Module`` registers the
        parameters and child links assigned to it anywhere, so this only
        keeps model code written for the JAX package unchanged."""
        yield

    def add_persistent(self, name, value):
        """Register ``value`` (a tensor or a number) as the persistent
        value ``name``: a buffer, serialized with the parameters."""
        self.register_buffer(name, torch.as_tensor(value))
        return getattr(self, name)

    def namedparams(self, prefix=""):
        """``(path, parameter)`` pairs, the path in the JAX package's form:
        ``/`` + the module path with ``/`` separators."""
        for name, p in self.named_parameters():
            yield prefix + "/" + name.replace(".", "/"), p

    def namedpersistent(self, prefix=""):
        """``(path, tensor)`` pairs of the persistent values, in the JAX
        form (``/res2/0/a/bn/avg_mean``)."""
        for path, link in self.named_modules():
            base = prefix + "/" + (path.replace(".", "/") + "/" if path
                                   else "")
            for name, buf in link._buffers.items():
                if buf is not None \
                        and name not in link._non_persistent_buffers_set:
                    yield base + name, buf

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

    def count_params(self):
        return sum(p.numel() for p in self.params() if not is_lazy(p))

    def cleargrads(self):
        for p in self.params():
            p.grad = None

    def zerograds(self):
        for p in self.params():
            p.grad = torch.zeros_like(p)

    def serialize(self, serializer):
        """The Chainer serializer protocol over the parameters and the
        persistent values (``serializer(name, value)`` and
        ``serializer[child]``): a writer receives host arrays, a reader's
        arrays are copied in place."""
        own = [(n, p) for n, p in self._parameters.items() if p is not None]
        own += [(n, b) for n, b in self._buffers.items()
                if b is not None and n not in self._non_persistent_buffers_set]
        for name, value in own:
            data = serializer(name, None if is_lazy(value)
                              else value.detach().cpu().numpy())
            if data is not None and not serializer.is_writer:
                _copy_array(value, data, name)
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
