"""Rounding of the step's tensors to a lower precision.

``rounding(precision).cast(x)`` rounds ``x`` to ``precision`` in the
forward and rounds the gradient that reaches it in the backward, as a
program that holds ``x`` in that precision does (a bf16 activation, a
weight cast to bf16 for its product, and their bf16 gradients).  The
references cast where the configuration holds a tensor in its compute
type; in ``float32`` a cast is the identity, and the reference is plain
float32.  A lower precision makes the control.  float8 scales each tensor
by its largest magnitude first, as fp8 training does (e4m3 values, e5m2
gradients), so that a tensor of small values is not flushed to zero.
"""

from __future__ import annotations

import torch

__all__ = ["rounding", "PRECISIONS"]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _scaled(dtype):
    top = torch.finfo(dtype).max

    def r(x):
        scale = x.abs().amax().clamp_min(1e-30) / top
        return (x / scale).to(dtype).float() * scale
    return r


class _Cast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, value, gradient):
        ctx.gradient = gradient
        return value(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.gradient(g), None, None


class Rounding:
    def __init__(self, value=None, gradient=None):
        self._value, self._gradient = value, gradient

    def cast(self, x):
        if self._value is None:
            return x
        return _Cast.apply(x, self._value, self._gradient)


PRECISIONS = {
    "float32": Rounding(),
    "bfloat16": Rounding(_bf16, _bf16),
    "float8_e4m3": Rounding(_scaled(torch.float8_e4m3fn),
                            _scaled(torch.float8_e5m2)),
}


def rounding(precision):
    return PRECISIONS[precision]
