"""Built-in links (the subset of the Chainer ``L`` surface the ported
slices run).

Parameters are initialized on the host with the JAX package's numpy
initializers and seeds, then placed on ``device``, so a port link and a
JAX link built with the same arguments hold bit-identical weights.  A
``Linear`` or ``Convolution2D`` built without its input size holds
``UninitializedParameter``s on ``device`` until its first call, which
draws them from the same seed.  ``BatchNormalization``'s running
statistics are persistent values (buffers).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import UninitializedParameter, is_lazy

from .._device import resolve_device
from ..core.config import config
from ..core.link import Link, _copy_array
from . import functions as F
from . import initializers as I

__all__ = ["Linear", "Convolution2D", "BatchNormalization",
           "LayerNormalization", "EmbedID", "StatelessLSTM", "LSTM",
           "StatelessGRU", "GRU", "NStepLSTM", "NStepGRU"]

_default_rng = np.random.RandomState(817)


def _rng(seed=None):
    return _default_rng if seed is None else np.random.RandomState(seed)


def _param(array, device):
    return nn.Parameter(torch.from_numpy(np.ascontiguousarray(array))
                        .to(device))


def _torch_dtype(dtype):
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class Linear(Link):
    """Fully-connected layer, weight ``(out, in)``.  ``Linear(out)`` and
    ``Linear(None, out)`` take ``in`` from the first input (the product
    of its axes after the batch axes).  Parameters are stored fp32;
    under bf16/fp16 activations they are cast to the activation dtype
    (the JAX package's mixed-precision convention)."""

    def __init__(self, in_size, out_size=None, nobias=False, initialW=None,
                 initial_bias=None, seed=None, device=None):
        super().__init__()
        if out_size is None:
            in_size, out_size = None, in_size
        device = resolve_device(device)
        self.in_size = in_size
        self.out_size = out_size
        self._initW = I._get_initializer(initialW, I.LeCunNormal())
        self._initb = I._get_initializer(initial_bias, I.Zero())
        self._seed = seed
        self.W = UninitializedParameter(device=device)
        self.b = None if nobias else UninitializedParameter(device=device)
        if in_size is not None:
            self._init_params(in_size)

    def _init_params(self, in_size):
        rng = _rng(self._seed)
        self.in_size = in_size
        _copy_array(self.W, self._initW((self.out_size, in_size),
                                        np.float32, rng), "W")
        if self.b is not None:
            _copy_array(self.b, self._initb((self.out_size,), np.float32,
                                            rng), "b")

    def forward(self, x, n_batch_axes=1):
        if is_lazy(self.W):
            self._init_params(int(np.prod(x.shape[n_batch_axes:])))
        W, b = self.W, self.b
        if x.dtype in (torch.bfloat16, torch.float16) and W.dtype != x.dtype:
            W = W.to(x.dtype)
            b = None if b is None else b.to(x.dtype)
        return F.linear(x, W, b, n_batch_axes=n_batch_axes)


class Convolution2D(Link):
    """2-D convolution, kernel ``(out, in / groups, kh, kw)`` whatever the
    activation ``layout`` ("NCHW" or "NHWC"), so weights carry across
    layouts.  ``Convolution2D(out, ksize)`` and ``in_channels=None`` take
    ``in`` from the first input.  Each call casts the fp32 kernel to the
    activation dtype, channels-last for NHWC, in one copy."""

    def __init__(self, in_channels, out_channels=None, ksize=None, stride=1,
                 pad=0, nobias=False, initialW=None, initial_bias=None,
                 dilate=1, groups=1, seed=None, layout="NCHW", device=None):
        super().__init__()
        if ksize is None:
            in_channels, out_channels, ksize = None, in_channels, out_channels
        F._spatial_dims(layout)
        device = resolve_device(device)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.ksize = ksize
        self.stride = stride
        self.pad = pad
        self.dilate = dilate
        self.groups = groups
        self.layout = layout
        self._initW = I._get_initializer(initialW, I.HeNormal())
        self._initb = I._get_initializer(initial_bias, I.Zero())
        self._seed = seed
        self.W = UninitializedParameter(device=device)
        self.b = None if nobias else UninitializedParameter(device=device)
        if in_channels is not None:
            self._init_params(in_channels)

    def _init_params(self, in_channels):
        rng = _rng(self._seed)
        kh, kw = F._pair(self.ksize)
        self.in_channels = in_channels
        shape = (self.out_channels, in_channels // self.groups, kh, kw)
        _copy_array(self.W, self._initW(shape, np.float32, rng), "W")
        if self.b is not None:
            _copy_array(self.b, self._initb((self.out_channels,),
                                            np.float32, rng), "b")

    def forward(self, x):
        if is_lazy(self.W):
            self._init_params(x.shape[F._spatial_dims(self.layout)[2]])
        fmt = (torch.channels_last if self.layout == "NHWC"
               else torch.contiguous_format)
        W = self.W.to(dtype=x.dtype, memory_format=fmt)
        b = None if self.b is None else self.b.to(x.dtype)
        return F.convolution_2d(x, W, b, self.stride, self.pad, self.dilate,
                                self.groups, layout=self.layout)


class BatchNormalization(Link):
    """Batch normalization with running statistics as persistent values.

    Under ``config.train`` the batch moments (``F.batch_moments``: fp32,
    one pass) normalize, and the running statistics move by Chainer's
    ``decay`` (``avg = decay avg + (1 - decay) batch``; the variance is
    the unbiased ``m / (m - 1)`` one), or with ``finetune`` by the
    cumulative ``decay = 1 - 1 / N``.  Otherwise the running statistics
    normalize.  ``axis`` is the reduced axes (default all but axis 1).
    ``_sync_moments`` and ``_moment_count`` are the hooks the multi-node
    subclass overrides (``links.MultiNodeBatchNormalization``)."""

    def __init__(self, size, decay=0.9, eps=2e-5, dtype=np.float32,
                 use_gamma=True, use_beta=True, initial_gamma=None,
                 initial_beta=None, axis=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.size = size
        self.decay = decay
        self.eps = eps
        self.axis = axis
        self.use_gamma = use_gamma
        self.use_beta = use_beta
        if use_gamma:
            ig = I._get_initializer(initial_gamma, I.One())
            self.gamma = _param(ig((size,), dtype), device)
        if use_beta:
            ib = I._get_initializer(initial_beta, I.Zero())
            self.beta = _param(ib((size,), dtype), device)
        self.add_persistent("avg_mean",
                            torch.zeros(size, dtype=_torch_dtype(dtype),
                                        device=device))
        self.add_persistent("avg_var",
                            torch.ones(size, dtype=_torch_dtype(dtype),
                                       device=device))
        self.add_persistent("N", torch.zeros((), dtype=torch.int64,
                                             device=device))

    def _gamma_beta(self):
        ref = self.avg_mean
        gamma = self.gamma if self.use_gamma else torch.ones_like(ref)
        beta = self.beta if self.use_beta else torch.zeros_like(ref)
        return gamma, beta

    def _moments(self, x, axis):
        mean, sq_mean = self._sync_moments(*F._raw_moments(x, axis), x)
        return mean, F._variance(mean, sq_mean)

    def _sync_moments(self, mean, sq_mean, x):
        """Cross-rank moment hook: the identity here."""
        return mean, sq_mean

    def _moment_count(self, x, axis):
        """The number of elements each moment reduces over."""
        return int(np.prod([x.shape[a] for a in axis]))

    def forward(self, x, finetune=False):
        axis = F._default_axis(x, self.axis)
        gamma, beta = self._gamma_beta()
        if not config.train:
            return F._apply_bn(x, gamma, beta, self.avg_mean, self.avg_var,
                               self.eps, axis)
        mean, var = self._moments(x, axis)
        y = F._apply_bn(x, gamma, beta, mean, var, self.eps, axis)
        m = self._moment_count(x, axis)
        with torch.no_grad():
            if finetune:
                self.N += 1
                # in float64, as the JAX link's Python scalars
                decay = 1.0 - 1.0 / self.N.double()
            else:
                decay = self.decay
            self.avg_mean.mul_(decay).add_((1 - decay) * mean.detach())
            self.avg_var.mul_(decay).add_(
                (1 - decay) * (var.detach() * (m / max(m - 1, 1))))
        return y


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
    """Embedding lookup, table ``(in_size, out_size)``; ids equal to
    ``ignore_label`` embed to zeros (:func:`F.embed_id`)."""

    def __init__(self, in_size, out_size, initialW=None, ignore_label=None,
                 seed=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.ignore_label = ignore_label
        initW = I._get_initializer(initialW, I.Normal(1.0))
        self.W = _param(initW((in_size, out_size), np.float32, _rng(seed)),
                        device)

    def forward(self, x):
        return F.embed_id(x, self.W, self.ignore_label)


class StatelessLSTM(Link):
    """One LSTM step, ``(c, h, x) -> (c, h)`` (``L.StatelessLSTM``).  The
    four gates ``[input, forget, cell, output]`` are packed along axis 1
    of one ``upward`` product (``in -> 4 out``) plus one ``lateral`` one
    (``out -> 4 out``, no bias), as in the JAX link; the forget gate's
    pre-activation gets +1 before its sigmoid.  ``h`` ``None`` skips
    ``lateral``, ``c`` ``None`` starts from zeros."""

    def __init__(self, in_size, out_size, seed=None, device=None):
        super().__init__()
        self.out_size = out_size
        self.upward = Linear(in_size, 4 * out_size, seed=seed,
                             device=device)
        self.lateral = Linear(out_size, 4 * out_size, nobias=True,
                              seed=None if seed is None else seed + 1,
                              device=device)

    def forward(self, c, h, x):
        gates = self.upward(x)
        if h is not None:
            gates = gates + self.lateral(h)
        i, f, g, o = gates.chunk(4, dim=1)
        i = F.sigmoid(i)
        f = F.sigmoid(f + 1.0)
        g = F.tanh(g)
        o = F.sigmoid(o)
        if c is None:
            c = x.new_zeros((x.shape[0], self.out_size))
        c_next = f * c + i * g
        return c_next, o * F.tanh(c_next)


class LSTM(StatelessLSTM):
    """The LSTM step holding ``(c, h)`` between calls (``L.LSTM``)."""

    def __init__(self, in_size, out_size, seed=None, device=None):
        super().__init__(in_size, out_size, seed=seed, device=device)
        self.c = None
        self.h = None

    def reset_state(self):
        self.c = None
        self.h = None

    def set_state(self, c, h):
        self.c = c
        self.h = h

    def forward(self, x):
        self.c, self.h = super().forward(self.c, self.h, x)
        return self.h


# the recurrent links over sequences (they build on Linear and
# StatelessLSTM above)
from .rnn import GRU, NStepGRU, NStepLSTM, StatelessGRU  # noqa: E402


def __getattr__(name):
    # L.Classifier lives with the models (a module-level import would be
    # circular); served here for ``L.Classifier(...)``, as the JAX
    # package serves it
    if name == "Classifier":
        from ..models.mlp import Classifier
        return Classifier
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
