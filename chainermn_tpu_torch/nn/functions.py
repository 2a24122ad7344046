"""Functions on tensors (the subset of the Chainer ``F`` surface the
serving slice runs), with the JAX package's numerics."""

from __future__ import annotations

import torch
import torch.nn.functional as TF

__all__ = ["linear", "embed_id", "layer_normalization", "gelu"]


def linear(x, W, b=None):
    """``x @ W.T + b`` with ``W`` shaped ``(out, in)``."""
    return TF.linear(x, W, b)


def embed_id(x, W):
    return TF.embedding(x, W)


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
