"""Functions on tensors (the subset of the Chainer ``F`` surface the
ported slices run), with the JAX package's numerics.

Convolutions and pooling take the JAX package's ``layout=`` ("NCHW" or
"NHWC"); kernels are OIHW in both.  An NHWC activation reaches
``torch.nn.functional`` as the NCHW view ``x.permute(0, 3, 1, 2)``, which
is channels-last in memory, so cuDNN runs its NHWC kernels on it and the
result is permuted back without a copy.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ..core import rng as rng_module
from ..core.config import config

__all__ = ["relu", "sigmoid", "tanh", "linear", "embed_id", "layer_normalization", "gelu",
           "softmax", "log_softmax", "softmax_cross_entropy", "accuracy",
           "dropout", "convolution_2d", "max_pooling_2d",
           "average_pooling_2d", "global_average_pooling_2d",
           "local_response_normalization", "concat", "batch_moments",
           "batch_normalization", "fixed_batch_normalization"]


def relu(x):
    """``max(x, 0)`` as the JAX function computes it: the gradient at
    exactly 0 is 1/2, as ``torch.maximum`` splits a tie."""
    return torch.maximum(x, x.new_zeros(()))


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def linear(x, W, b=None, n_batch_axes=1):
    """``x @ W.T + b`` with ``W`` shaped ``(out, in)``, Chainer's rule for
    ``x`` of more than two axes: the first ``n_batch_axes`` axes are the
    batch, every later axis is flattened into ``in``, and the batch shape
    comes back on the output (a single batch axis stays flat)."""
    if n_batch_axes > 1:
        batch_shape = x.shape[:n_batch_axes]
        y = TF.linear(x.reshape(batch_shape.numel(), -1), W, b)
        return y.reshape(*batch_shape, W.shape[0])
    if x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    return TF.linear(x, W, b)


def embed_id(x, W, ignore_label=None):
    """Rows of ``W`` by the ids in ``x``.  An id equal to
    ``ignore_label`` gathers row 0 and is then zeroed, so it contributes
    nothing to the output or to ``W``'s gradient (the JAX function's
    rule)."""
    if ignore_label is None:
        return TF.embedding(x, W)
    ignored = x == ignore_label
    emb = TF.embedding(torch.where(ignored, torch.zeros_like(x), x), W)
    return torch.where(ignored.unsqueeze(-1), emb.new_zeros(()), emb)


def gelu(x):
    """GELU, tanh approximation: the default of ``jax.nn.gelu``."""
    return TF.gelu(x, approximate="tanh")


def layer_normalization(x, gamma, beta, eps=1e-5):
    """Statistics in fp32 (population variance), output in the activation
    dtype -- the JAX package's discipline."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return y.to(x.dtype)


def softmax(x, axis=1):
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=1):
    return torch.log_softmax(x, dim=axis)


def softmax_cross_entropy(x, t, ignore_label=-1, reduce="mean",
                          normalize=True, class_weight=None):
    """Softmax + NLL with ignore-label masking (``F.softmax_cross_entropy``).

    ``t`` holds int class ids; entries equal to ``ignore_label`` add zero
    loss and leave the normalizer; ``class_weight`` (``[n_classes]``)
    scales each example's loss by its target's weight.  The log-softmax
    runs in fp32, also for bf16 logits."""
    logp = torch.log_softmax(x.float(), dim=1)
    t = t.long()
    mask = t != ignore_label
    t_safe = torch.where(mask, t, torch.zeros_like(t))
    nll = -torch.gather(logp, 1, t_safe.unsqueeze(1)).squeeze(1)
    if class_weight is not None:
        nll = nll * torch.as_tensor(class_weight, dtype=nll.dtype,
                                    device=nll.device)[t_safe]
    nll = torch.where(mask, nll, torch.zeros_like(nll))
    if reduce == "no":
        return nll
    if normalize:
        count = mask.sum().clamp_min(1)
    else:
        count = x.shape[0]
    return nll.sum() / count


def accuracy(y, t, ignore_label=None):
    pred = torch.argmax(y, dim=1)
    if ignore_label is not None:
        mask = t != ignore_label
        correct = (pred == t) & mask
        return correct.sum() / mask.sum().clamp_min(1)
    return (pred == t).float().mean()


# -- stochastic -------------------------------------------------------------

def dropout(x, ratio=0.5, key=None, train=None):
    """Zero each element with probability ``ratio`` and scale the rest by
    ``1 / (1 - ratio)``, in ``x.dtype``; the identity when ``train`` (by
    default ``config.train``) is off or ``ratio`` is 0.  The mask is
    drawn on ``x``'s device from ``key`` (a ``torch.Generator``), else
    from the training step's generator (``core.rng.key_scope``), else
    from torch's global RNG (the reference's hidden one)."""
    if train is None:
        train = config.train
    if not train or ratio == 0.0:
        return x
    if key is None:
        key = rng_module.next_key()
    keep = 1.0 - ratio
    mask = torch.rand(x.shape, generator=key, device=x.device) < keep
    return torch.where(mask, x / keep, x.new_zeros(())).to(x.dtype)


# -- convolutions and pooling --------------------------------------------

def _pair(v):
    return (v, v) if np.isscalar(v) else tuple(v)


def _spatial_dims(layout):
    """(h_dim, w_dim, channel_dim) for a 4-D activation layout string."""
    if layout == "NCHW":
        return 2, 3, 1
    if layout == "NHWC":
        return 1, 2, 3
    raise ValueError(f"unsupported activation layout {layout!r}")


def _to_nchw(x, layout):
    """The logical NCHW view torch's functions take (channels-last in
    memory for an NHWC tensor)."""
    _spatial_dims(layout)
    return x.permute(0, 3, 1, 2) if layout == "NHWC" else x


def _from_nchw(y, layout):
    return y.permute(0, 2, 3, 1) if layout == "NHWC" else y


def convolution_2d(x, W, b=None, stride=1, pad=0, dilate=1, groups=1,
                   layout="NCHW"):
    """2-D convolution, ``W`` shaped ``(out, in / groups, kh, kw)`` in
    either activation layout.  For NHWC give ``W`` in channels-last memory
    (``W.to(memory_format=torch.channels_last)``), or cuDNN converts it on
    every call."""
    y = TF.conv2d(_to_nchw(x, layout), W, b, stride=_pair(stride),
                  padding=_pair(pad), dilation=_pair(dilate), groups=groups)
    return _from_nchw(y, layout)


def _pool_input(x, layout, k, pads, fill):
    """``x`` as NCHW and the symmetric padding to hand torch's pooling.
    Padding torch cannot express (more than half the window, or the
    extra high-side rows of ``cover_all``) is applied here with
    ``fill``."""
    (kh, kw), ((ph, ph_hi), (pw, pw_hi)) = k, pads
    xc = _to_nchw(x, layout)
    if ph_hi != ph or pw_hi != pw or 2 * ph > kh or 2 * pw > kw:
        return TF.pad(xc, (pw, pw_hi, ph, ph_hi), value=fill), (0, 0)
    return xc, (ph, pw)


def max_pooling_2d(x, ksize, stride=None, pad=0, cover_all=True,
                   layout="NCHW"):
    """Max pooling; ``cover_all`` pads the high side until every element
    is covered (Chainer's output size).  The gradient goes to the first
    maximum of each window in row-major tap order, as the JAX package's
    ``_max_pool_argmax`` routes it (torch's kernels keep the first
    maximum by a strict ``>``)."""
    kh, kw = _pair(ksize)
    sy, sx = _pair(stride if stride is not None else ksize)
    ph, pw = _pair(pad)
    hd, wd, _ = _spatial_dims(layout)
    eh = ew = 0
    if cover_all:
        h, w = x.shape[hd], x.shape[wd]
        eh = -(h + 2 * ph - kh) % sy if sy > 1 else 0
        ew = -(w + 2 * pw - kw) % sx if sx > 1 else 0
    xc, padding = _pool_input(x, layout, (kh, kw),
                              ((ph, ph + eh), (pw, pw + ew)), float("-inf"))
    return _from_nchw(TF.max_pool2d(xc, (kh, kw), (sy, sx), padding),
                      layout)


def average_pooling_2d(x, ksize, stride=None, pad=0, layout="NCHW"):
    """Average pooling divided by the full window (padding included), in
    ``x.dtype``."""
    kh, kw = _pair(ksize)
    sy, sx = _pair(stride if stride is not None else ksize)
    ph, pw = _pair(pad)
    xc, padding = _pool_input(x, layout, (kh, kw), ((ph, ph), (pw, pw)),
                              0.0)
    return _from_nchw(TF.avg_pool2d(xc, (kh, kw), (sy, sx), padding,
                                    count_include_pad=True,
                                    divisor_override=kh * kw), layout)


def global_average_pooling_2d(x, layout="NCHW"):
    """The mean over H and W, reduced in ``x.dtype`` (torch accumulates
    a bf16 mean in fp32 and rounds once)."""
    hd, wd, _ = _spatial_dims(layout)
    return x.mean(dim=(hd, wd))


def local_response_normalization(x, n=5, k=2.0, alpha=1e-4, beta=0.75):
    """Cross-channel LRN on NCHW: ``x / (k + alpha S)^beta`` with ``S``
    the sum of ``x^2`` over ``n`` channels around each one (zero
    outside).  ``alpha`` multiplies the sum, as in Chainer; torch's
    ``local_response_norm`` scales it by ``1 / n``, another function."""
    half = n // 2
    c = x.shape[1]
    padded = TF.pad(x * x, (0, 0, 0, 0, half, half))
    window = padded[:, 0:c]
    for i in range(1, n):
        window = window + padded[:, i:i + c]
    return x / (k + alpha * window) ** beta


def concat(xs, axis=1):
    return torch.cat(list(xs), dim=axis)


# -- batch normalization -------------------------------------------------

def _raw_moments(x, axis):
    """``(E[x], E[x^2])`` over ``axis`` in fp32, in one pass over an fp32
    copy of ``x``."""
    x32 = x.float()
    return x32.mean(dim=axis), (x32 * x32).mean(dim=axis)


def _variance(mean, sq_mean):
    """``max(E[x^2] - mean^2, 0)``: the clamp guards fp32 cancellation."""
    return torch.maximum(sq_mean - torch.square(mean),
                         sq_mean.new_zeros(()))


def batch_moments(x, axis):
    """Single-pass batch moments: fp32 mean and E[x^2] side by side,
    ``var = max(E[x^2] - mean^2, 0)``.  Returns ``(mean, var)``."""
    mean, sq_mean = _raw_moments(x, axis)
    return mean, _variance(mean, sq_mean)


def _default_axis(x, axis):
    return (0,) + tuple(range(2, x.dim())) if axis is None else tuple(axis)


def batch_normalization(x, gamma, beta, eps=2e-5, axis=None):
    axis = _default_axis(x, axis)
    mean, var = batch_moments(x, axis)
    return _apply_bn(x, gamma, beta, mean, var, eps, axis)


def fixed_batch_normalization(x, gamma, beta, mean, var, eps=2e-5,
                              axis=None):
    return _apply_bn(x, gamma, beta, mean, var, eps, _default_axis(x, axis))


def _apply_bn(x, gamma, beta, mean, var, eps, axis):
    """``gamma (x - mean) / sqrt(var + eps) + beta`` with the per-channel
    scale ``a`` in fp32.  fp32 activations keep the unfolded ``(x - m) a
    + b``, which does not cancel when ``|mean| >> std``; other dtypes fold
    to ``x a + (beta - mean a)`` with ``a`` and the shift cast to
    ``x.dtype``: one multiply-add over the activation, rounded once."""
    f32 = torch.float32
    a = gamma.to(f32) * torch.rsqrt(var.to(f32) + eps)
    shape = [1 if d in axis else n for d, n in enumerate(x.shape)]
    if x.dtype == f32:
        return ((x - mean.to(f32).reshape(shape)) * a.reshape(shape)
                + beta.to(f32).reshape(shape))
    b = beta.to(f32) - mean.to(f32) * a
    return torch.addcmul(b.reshape(shape).to(x.dtype), x,
                         a.reshape(shape).to(x.dtype))
