"""Functions on tensors (the subset of the Chainer ``F`` surface the
serving and training slices run), with the JAX package's numerics."""

from __future__ import annotations

import torch
import torch.nn.functional as TF

__all__ = ["linear", "embed_id", "layer_normalization", "gelu", "softmax",
           "log_softmax", "softmax_cross_entropy", "accuracy"]


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
