"""Batch normalization in training with its activation, fused: the Hopper
kernels, their plain version and the differentiable dispatch.

``csrc/batch_norm_act_sm90.cu`` holds two passes each way over
channel-innermost activations (NHWC, or ``(N, C)``): the forward's
statistics (``bn_fw_stats``) and its apply (``bn_fw_apply``), the
backward's reduction (``bn_bw_reduce``) and its dx (``bn_bw_dx``), in
three variants: plain, with ReLU, and with a residual added before the
ReLU (a bottleneck block's ``relu(bn(c) + shortcut)``).  Statistics,
parameters, running statistics and every sum are fp32; activations are
read and written in their own dtype (bf16 or fp32) and rounded once.  No
TPU kernel is replaced: the JAX package's batch norm is plain ``jnp``.

* :func:`batch_norm_act` -- the one entry, for CUDA tensors: the kernels
  under autograd (:class:`_BatchNormAct`: :func:`batch_norm_act_fwd`,
  then :func:`batch_norm_act_bwd` in the backward).  It copies an input
  that is not contiguous or 16-byte aligned, and raises for anything else
  the kernels cannot take: it never falls back to the plain version.
* :func:`batch_norm_act_plain` -- the plain version: the arithmetic of
  ``nn/functions.py`` (``batch_moments``, ``_apply_bn``, ``relu``) and of
  ``L.BatchNormalization``'s running statistics, which the tests hold the
  kernels to.

``L.BatchNormalization`` decides which calls come here: training on a
CUDA tensor whose reduced axes are every axis but the last, with no hook
on the moments.
"""

from __future__ import annotations

import functools

import torch

from ..nn import functions as F

__all__ = ["batch_norm_act", "batch_norm_act_fwd", "batch_norm_act_bwd",
           "batch_norm_act_plain", "activate", "move_running",
           "batch_norm_act_bytes"]

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_ACT_NONE, _ACT_RELU, _ACT_RESIDUAL = 0, 1, 2

#: the kernels' block: 256 threads, 8 channels a thread, 4 rows in flight
_THREADS, _VEC, _UNROLL = 256, 8, 4
#: SMs of the card the grid is sized for (H100 SXM)
_SMS = 132


@functools.lru_cache(maxsize=None)
def _geometry(R, C):
    """The kernels' grid for ``R`` rows of ``C`` channels: ``(tx, splits,
    rows_per_split)``.  A block is ``tx`` groups of 8 channels (8, or the
    power of two that covers a narrower C) by ``256 / tx`` rows; the grid is
    ``ceil(C / (8 tx))`` channel tiles by ``splits`` row splits, about four
    blocks an SM, at most two splits an SM (the last block of a tile merges
    every split's partials) and at least 4 rows a thread."""
    tx = min(8, 1 << (C // _VEC - 1).bit_length())
    tiles = -(-C // (tx * _VEC))
    splits = max(1, min(-(-4 * _SMS // tiles), 2 * _SMS,
                        -(-R // (_THREADS // tx * _UNROLL))))
    rps = -(-R // splits)
    return tx, -(-R // rps), rps


def _like(t, x):
    """``t`` has x's shape, dtype and device, contiguous, 16-byte aligned."""
    return (t.shape == x.shape and t.dtype is x.dtype and t.device == x.device
            and t.is_contiguous() and t.data_ptr() % 16 == 0)


def _dense(t):
    """``t`` if it is contiguous and 16-byte aligned, else such a copy
    (differentiable, as ``clone``)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _refusal(x, gamma, beta, avg_mean, avg_var, residual):
    """Why the kernels cannot take these tensors, or None.  They take ``x``
    bf16 or fp32, at least 2-D and not empty, its channels (the last axis)
    a multiple of 8, on a CUDA device; gamma and beta fp32 ``[C]`` on its
    device; the running statistics both or neither, fp32 contiguous
    ``[C]`` there; ``residual`` None or of x's shape, dtype and device."""
    if x.dtype not in _DTYPES:
        return f"x is {x.dtype}, not bf16 or fp32"
    if x.dim() < 2 or x.numel() == 0:
        return f"x has the shape {tuple(x.shape)}"
    C = x.shape[-1]
    if C % _VEC:
        return f"its {C} channels are not a multiple of {_VEC}"
    if (avg_mean is None) != (avg_var is None):
        return "avg_mean and avg_var come together"
    for name, p in (("gamma", gamma), ("beta", beta), ("avg_mean", avg_mean),
                    ("avg_var", avg_var)):
        if p is not None and not (p.dtype is torch.float32
                                  and p.shape == (C,) and p.device == x.device):
            return (f"{name} is {p.dtype} {tuple(p.shape)} on {p.device}, "
                    f"not fp32 [{C}] on {x.device}")
    if avg_mean is not None and not (avg_mean.is_contiguous()
                                     and avg_var.is_contiguous()):
        return "the running statistics, moved in place, are not contiguous"
    if residual is not None and not (residual.shape == x.shape
                                     and residual.dtype is x.dtype
                                     and residual.device == x.device):
        return (f"the residual is {residual.dtype} {tuple(residual.shape)} "
                f"on {residual.device}, not like x")
    if x.device.type != "cuda":
        return f"x is on {x.device}, not a CUDA device"
    return None


def activate(y, relu=False, residual=None):
    """The plain activation after batch norm: ``relu(y + residual)``,
    ``relu(y)`` or ``y``, with ``F.relu`` (gradient 1/2 at exactly 0)."""
    if residual is not None:
        return F.relu(y + residual)
    return F.relu(y) if relu else y


def move_running(avg_mean, avg_var, mean, var, decay, m):
    """Chainer's move of the running statistics, in place:
    ``avg = decay avg + (1 - decay) batch``, the variance the unbiased
    ``m / (m - 1)`` one (``decay`` a float or a tensor)."""
    with torch.no_grad():
        avg_mean.mul_(decay).add_((1 - decay) * mean.detach())
        avg_var.mul_(decay).add_(
            (1 - decay) * (var.detach() * (m / max(m - 1, 1))))


def _check_act(relu, residual):
    if residual is not None and not relu:
        raise ValueError("the residual is added before the ReLU: pass "
                         "relu=True with it")


def batch_norm_act_plain(x, gamma, beta, avg_mean=None, avg_var=None,
                         eps=2e-5, decay=0.9, relu=False, residual=None):
    """Plain version of :func:`batch_norm_act`: fp32 batch moments over
    every axis but the last (``F.batch_moments``), ``F._apply_bn``, then
    :func:`activate`; the running statistics (when given) move by
    :func:`move_running`.  Returns ``(y, mean, var)``."""
    _check_act(relu, residual)
    axis = tuple(range(x.dim() - 1))
    mean, var = F.batch_moments(x, axis)
    y = activate(F._apply_bn(x, gamma, beta, mean, var, eps, axis), relu,
                 residual)
    if avg_mean is not None:
        move_running(avg_mean, avg_var, mean, var, decay,
                     x.numel() // x.shape[-1])
    return y, mean.detach(), var.detach()


_launchers = {}
_workspaces = {}


def _call(name, index, stream, *args):
    """Call the library's launcher ``name`` (looked up once) with ``args``
    on ``stream`` of CUDA device ``index``, made current only when it is
    not; raise on a CUDA error."""
    fn = _launchers.get(name)
    if fn is None:
        from .._build import load_library
        fn = _launchers[name] = getattr(load_library(), name)
    if index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _workspace(x):
    """``(index, stream, R, C, tx, splits, rps, partials, counters)`` for a
    launch on ``x``.  The partials (fp32) and the last-block counters
    (int32, zero between launches: each kernel's last block resets its
    own) belong to the current stream, whose order keeps its launches
    from sharing them at once; they grow as a launch needs."""
    C = x.shape[-1]
    R = x.numel() // C
    tx, splits, rps = _geometry(R, C)
    index = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    floats, tiles = splits * C * 2, -(-C // (tx * _VEC))
    ws = _workspaces.get((index, stream))
    if ws is None or ws[0].numel() < floats or ws[1].numel() < tiles:
        ws = _workspaces[(index, stream)] = (
            x.new_empty(max(floats, 1 << 16), dtype=torch.float32),
            x.new_zeros(max(tiles, 1024), dtype=torch.int32))
    return index, stream, R, C, tx, splits, rps, ws[0], ws[1]


def _act_code(relu, residual):
    return (_ACT_RESIDUAL if residual is not None
            else _ACT_RELU if relu else _ACT_NONE)


def batch_norm_act_fwd(x, gamma, beta, avg_mean, avg_var, eps, decay, relu,
                       residual):
    """Launch the forward's two passes on tensors :func:`batch_norm_act`
    checked (the running statistics may be None: then none move).  Returns
    ``(y, stats)``: y like x, stats fp32 ``[4, C]`` (the batch mean, the
    population variance, rstd, ``a = gamma rstd``).  Counted in
    ``batch_norm_act_fwd.launches``."""
    index, stream, R, C, tx, splits, rps, part, counters = _workspace(x)
    y = torch.empty_like(x)
    stats = x.new_empty((4, C), dtype=torch.float32)
    moving = avg_mean is not None
    _call("bn_act_fwd", index, stream, x.data_ptr(),
          None if residual is None else residual.data_ptr(), y.data_ptr(),
          gamma.data_ptr(), beta.data_ptr(),
          avg_mean.data_ptr() if moving else None,
          avg_var.data_ptr() if moving else None, stats.data_ptr(),
          part.data_ptr(), counters.data_ptr(), _DTYPES[x.dtype],
          _act_code(relu, residual), R, C, tx, rps, splits, eps, decay,
          1 - decay, R / max(R - 1, 1))
    batch_norm_act_fwd.launches += 1
    return y, stats


batch_norm_act_fwd.launches = 0


def batch_norm_act_bwd(dy, x, stats, beta, relu, residual):
    """Launch the backward's two passes on the forward's ``x``, ``stats``
    and ``residual`` and a cotangent like x (a contiguous copy when it is
    not): ``(dx, ds, dgamma, dbeta)``, dx and ds (None without a residual)
    like x, the parameters' gradients fp32.  Counted in
    ``batch_norm_act_bwd.launches``."""
    if not _like(dy, x):
        dy = dy.to(dtype=x.dtype, memory_format=torch.contiguous_format,
                   copy=True)
        if not _like(dy, x):
            raise ValueError(f"dy {tuple(dy.shape)} does not match x "
                             f"{tuple(x.shape)}")
    index, stream, R, C, tx, splits, rps, part, counters = _workspace(x)
    dx = torch.empty_like(x)
    ds = None if residual is None else torch.empty_like(x)
    grads = x.new_empty((4, C), dtype=torch.float32)
    _call("bn_act_bwd", index, stream, dy.data_ptr(), x.data_ptr(),
          None if residual is None else residual.data_ptr(), dx.data_ptr(),
          None if ds is None else ds.data_ptr(), stats.data_ptr(),
          beta.data_ptr(), grads.data_ptr(), part.data_ptr(),
          counters.data_ptr(), _DTYPES[x.dtype], _act_code(relu, residual),
          R, C, tx, rps, splits)
    batch_norm_act_bwd.launches += 1
    return dx, ds, grads[0], grads[1]


batch_norm_act_bwd.launches = 0


class _BatchNormAct(torch.autograd.Function):
    """Differentiable fused batch norm: the forward kernels, saving x (and
    the residual), the fp32 statistics and beta; the backward kernels."""

    @staticmethod
    def forward(ctx, x, gamma, beta, residual, avg_mean, avg_var, eps,
                decay, relu):
        y, stats = batch_norm_act_fwd(x, gamma, beta, avg_mean, avg_var, eps,
                                      decay, relu, residual)
        if avg_mean is not None:
            # the kernel moved them through raw pointers: count it as an
            # in-place op would, so that autograd still refuses a graph
            # that saved them before
            torch.autograd.graph.increment_version(avg_mean)
            torch.autograd.graph.increment_version(avg_var)
        ctx.save_for_backward(x, residual, stats, beta)
        ctx.relu = relu
        ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, _):
        x, residual, stats, beta = ctx.saved_tensors
        dx, ds, dgamma, dbeta = batch_norm_act_bwd(dy, x, stats, beta,
                                                   ctx.relu, residual)
        return dx, dgamma, dbeta, ds, None, None, None, None, None


def batch_norm_act(x, gamma, beta, avg_mean=None, avg_var=None, eps=2e-5,
                   decay=0.9, relu=False, residual=None):
    """Batch norm in training over every axis but the last of CUDA
    tensors, then the activation (:func:`activate`; a residual needs
    ``relu``), through the kernels under autograd: ``(y, mean, var)``, the
    batch statistics fp32 and detached.  The running statistics (when
    given) move in place by ``decay``.  ``x``, the residual and the
    parameters are copied first where they are not contiguous or 16-byte
    aligned; anything else the kernels cannot take raises ``ValueError``
    (:func:`_refusal`)."""
    _check_act(relu, residual)
    why = _refusal(x, gamma, beta, avg_mean, avg_var, residual)
    if why:
        raise ValueError(f"batch_norm_act launches CUDA kernels, which "
                         f"cannot take this call: {why}")
    y, stats = _BatchNormAct.apply(
        _dense(x), _dense(gamma), _dense(beta),
        None if residual is None else _dense(residual), avg_mean, avg_var,
        eps, decay, relu)
    return y, stats[0], stats[1]


def batch_norm_act_bytes(R, C, itemsize, residual=False):
    """Bytes each kernel must move once, for ``R`` rows of ``C`` channels:
    ``{"bn_fw_stats": x in, "bn_fw_apply": x (and s) in and y out,
    "bn_bw_reduce": dy and x (and s) in (and ds out), "bn_bw_dx": dy or
    ds, and x, in and dx out}``; the fp32 ``[C]`` vectors are left out."""
    n = R * C * itemsize
    s = int(bool(residual))
    return {"bn_fw_stats": n, "bn_fw_apply": (2 + s) * n,
            "bn_bw_reduce": (2 + 2 * s) * n, "bn_bw_dx": 3 * n}
