"""Built-in links (the subset of the Chainer ``L`` surface the serving slice
runs).

Parameters are initialized on the host with the JAX package's numpy
initializers and seeds, then placed on ``device``, so a port link and a
JAX link built with the same arguments hold bit-identical weights.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..core.link import Link
from . import functions as F
from . import initializers as I

__all__ = ["Linear", "LayerNormalization", "EmbedID"]

_default_rng = np.random.RandomState(817)


def _rng(seed=None):
    return _default_rng if seed is None else np.random.RandomState(seed)


def _param(array, device):
    return nn.Parameter(torch.from_numpy(np.ascontiguousarray(array))
                        .to(device))


class Linear(Link):
    """Fully-connected layer, weight ``(out, in)``.  Parameters are stored
    fp32; under bf16/fp16 activations they are cast to the activation dtype
    (the JAX package's mixed-precision convention)."""

    def __init__(self, in_size, out_size, nobias=False, initialW=None,
                 initial_bias=None, seed=None, device=None):
        super().__init__()
        device = resolve_device(device)
        rng = _rng(seed)
        initW = I._get_initializer(initialW, I.LeCunNormal())
        initb = I._get_initializer(initial_bias, I.Zero())
        self.W = _param(initW((out_size, in_size), np.float32, rng), device)
        self.b = None if nobias else _param(
            initb((out_size,), np.float32, rng), device)

    def forward(self, x):
        W, b = self.W, self.b
        if x.dtype in (torch.bfloat16, torch.float16) and W.dtype != x.dtype:
            W = W.to(x.dtype)
            b = None if b is None else b.to(x.dtype)
        return F.linear(x, W, b)


class LayerNormalization(Link):
    def __init__(self, size, eps=1e-5, device=None):
        super().__init__()
        device = resolve_device(device)
        self.eps = eps
        self.gamma = _param(np.ones(size, np.float32), device)
        self.beta = _param(np.zeros(size, np.float32), device)

    def forward(self, x):
        return F.layer_normalization(x, self.gamma, self.beta, self.eps)


class EmbedID(Link):
    """Embedding lookup, table ``(in_size, out_size)``."""

    def __init__(self, in_size, out_size, initialW=None, seed=None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        initW = I._get_initializer(initialW, I.Normal(1.0))
        self.W = _param(initW((in_size, out_size), np.float32, _rng(seed)),
                        device)

    def forward(self, x):
        return F.embed_id(x, self.W)
