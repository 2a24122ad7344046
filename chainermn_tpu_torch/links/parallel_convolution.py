"""Channel-parallel (tensor-parallel) convolution.

The port of ``chainermn_tpu.links.parallel_convolution`` (reference:
``examples/parallel_convolution/``, ChainerMN's tensor parallelism by
hand): each rank computes its block of the output channels and the
blocks are stitched by the differentiable ``allgather``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import functions as mnfn
from .._device import resolve_device
from ..core.link import Link
from ..nn import functions as F
from ..nn import initializers as I

__all__ = ["ParallelConvolution2D"]


class ParallelConvolution2D(Link):
    """Filter-split convolution: rank ``r`` computes output-channel block
    ``r`` (``out_channels // size`` filters).

    The parameters are the whole filter bank ``W`` ``(out, in, kh, kw)``
    and ``b``, with the JAX link's paths, seed and initializers, the same
    on every rank.  Each rank convolves with its block of them, and
    :func:`~..functions.allgather` stitches the blocks along the channel
    axis; the allgather's backward hands each rank the gradient of its
    block, and :func:`~..functions.psum_gradient` on the bank makes every
    rank's ``W.grad`` the whole bank's gradient (the mean over ranks of
    each rank's block gradient, as the JAX link).  In a world of one the
    whole bank is applied directly."""

    def __init__(self, comm, in_channels, out_channels, ksize, stride=1,
                 pad=0, nobias=False, initialW=None, initial_bias=None,
                 seed=None, device=None):
        super().__init__()
        if out_channels % comm.size != 0:
            raise ValueError(
                f"out_channels {out_channels} not divisible by "
                f"comm.size {comm.size}")
        device = resolve_device(device)
        self.comm = comm
        self.out_channels = out_channels
        self.stride = stride
        self.pad = pad
        self.nobias = nobias
        rng = np.random.RandomState(seed) if seed is not None else np.random
        initW = I._get_initializer(initialW, I.HeNormal())
        initb = I._get_initializer(initial_bias, I.Zero())
        kh, kw = (ksize, ksize) if np.isscalar(ksize) else ksize
        self.W = torch.nn.Parameter(torch.from_numpy(initW(
            (out_channels, in_channels, kh, kw), np.float32, rng)).to(device))
        self.b = None if nobias else torch.nn.Parameter(torch.from_numpy(
            initb((out_channels,), np.float32, rng)).to(device))

    def forward(self, x):
        comm = self.comm
        if comm.size == 1:
            return F.convolution_2d(x, self.W, self.b, self.stride, self.pad)
        block = self.out_channels // comm.size
        lo = comm.rank * block
        W = mnfn.psum_gradient(comm, self.W)[lo:lo + block]
        b = None if self.b is None \
            else mnfn.psum_gradient(comm, self.b)[lo:lo + block]
        y_local = F.convolution_2d(x, W, b, self.stride, self.pad)
        return torch.cat(mnfn.allgather(comm, y_local), dim=1)
