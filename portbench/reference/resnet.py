"""ResNet v1.5 training loss, plain float32 PyTorch.

He et al. 2016 (arXiv:1512.03385), Table 1, with the stride of each
stage's first block on its 3x3 convolution (torchvision's "v1.5"):

    image (uint8, NHWC) -> (x / 255 - mean) / std
    conv 7x7/2 -> BN -> ReLU -> max pool 3x3/2 (pad 1)
    per stage: blocks of 1x1 -> BN -> ReLU -> 3x3 (stride) -> BN -> ReLU
               -> 1x1 -> BN, plus the shortcut (1x1 conv -> BN on the
               stage's first block, else the identity), then ReLU
    global average pool -> fully connected -> softmax cross-entropy

Batch norm normalizes by the batch's mean and population variance in
training (the running statistics do not enter the loss).  With a
``precision`` below float32 the activations (the standardized image, each
convolution's and batch norm's output, each residual sum, the pooled
features) and the convolutions' weights are cast to it (``quant``); the
classifier runs in float32 on the pooled features.  Each stage is
recomputed in the backward (``torch.utils.checkpoint``) so that the
float32 step at the benchmark's batch fits beside nothing else.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF
from torch.utils.checkpoint import checkpoint

from .quant import rounding

__all__ = ["param_specs", "loss_and_grads"]

_PREFIX = "/predictor/"


def _stages(cfg):
    exp = cfg["expansion"]
    return [(n, w, w * exp) for n, w in zip(cfg["blocks"], cfg["widths"])]


def param_specs(cfg):
    """``[(name, shape, init)]`` of every parameter: convolutions He
    normal (std sqrt(2 / fan_in)), batch norm's scale 1 and shift 0, the
    classifier LeCun normal (std sqrt(1 / fan_in)) with a zero bias."""
    specs = []

    def conv_bn(name, c_in, c_out, k):
        fan_in = c_in * k * k
        specs.append((f"{_PREFIX}{name}/conv/W", (c_out, c_in, k, k),
                      ("normal", (2.0 / fan_in) ** 0.5)))
        specs.append((f"{_PREFIX}{name}/bn/gamma", (c_out,), ("const", 1.0)))
        specs.append((f"{_PREFIX}{name}/bn/beta", (c_out,), ("const", 0.0)))

    conv_bn("conv1", 3, 64, 7)
    c_in = 64
    for s, (n, mid, out) in enumerate(_stages(cfg)):
        for i in range(n):
            name = f"res{s + 2}/{i}"
            conv_bn(f"{name}/a", c_in, mid, 1)
            conv_bn(f"{name}/b", mid, mid, 3)
            conv_bn(f"{name}/c", mid, out, 1)
            if i == 0:
                conv_bn(f"{name}/shortcut", c_in, out, 1)
            c_in = out
    n_cls = cfg["n_classes"]
    specs.append((f"{_PREFIX}fc/W", (n_cls, c_in),
                  ("normal", (1.0 / c_in) ** 0.5)))
    specs.append((f"{_PREFIX}fc/b", (n_cls,), ("const", 0.0)))
    return specs


def _conv_bn(p, name, x, stride, pad, eps, r, relu=True):
    y = r.cast(TF.conv2d(x, r.cast(p[f"{_PREFIX}{name}/conv/W"]),
                         stride=stride, padding=pad))
    y = r.cast(TF.batch_norm(y, None, None,
                             weight=p[f"{_PREFIX}{name}/bn/gamma"],
                             bias=p[f"{_PREFIX}{name}/bn/beta"],
                             training=True, eps=eps))
    return TF.relu(y) if relu else y


def _stage(p, s, n, x, eps, r):
    for i in range(n):
        name = f"res{s + 2}/{i}"
        stride = 2 if (s > 0 and i == 0) else 1
        h = _conv_bn(p, f"{name}/a", x, 1, 0, eps, r)
        h = _conv_bn(p, f"{name}/b", h, stride, 1, eps, r)
        h = _conv_bn(p, f"{name}/c", h, 1, 0, eps, r, relu=False)
        sc = (_conv_bn(p, f"{name}/shortcut", x, stride, 0, eps, r,
                       relu=False) if i == 0 else x)
        x = TF.relu(r.cast(h + sc))
    return x


def loss(cfg, p, x, t, precision="float32", recompute=True):
    """Mean softmax cross-entropy of one batch: ``x`` uint8 images
    ``[N, H, W, 3]``, ``t`` integer labels ``[N]``.  ``recompute``: run
    each stage again in the backward instead of keeping its
    activations."""
    r = rounding(precision)
    eps = cfg["bn_eps"]
    mean = torch.tensor(cfg["input_mean"], device=x.device)
    std = torch.tensor(cfg["input_std"], device=x.device)
    h = r.cast(((x.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)
               .contiguous())
    h = _conv_bn(p, "conv1", h, 2, 3, eps, r)
    h = TF.max_pool2d(h, 3, 2, 1)
    for s, (n, _, _) in enumerate(_stages(cfg)):
        h = (checkpoint(_stage, p, s, n, h, eps, r, use_reentrant=False)
             if recompute else _stage(p, s, n, h, eps, r))
    h = r.cast(h.mean(dim=(2, 3)))
    y = TF.linear(h, p[f"{_PREFIX}fc/W"], p[f"{_PREFIX}fc/b"])
    return TF.cross_entropy(y, t.long())


def loss_and_grads(cfg, precision="float32"):
    """``fn(params, (x, t)) -> (loss, {name: gradient})`` for
    ``reference.train_readings``."""
    def fn(params, batch):
        x, t = batch
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        value = loss(cfg, leaves, x, t, precision)
        grads = torch.autograd.grad(value, list(leaves.values()))
        return value.detach(), dict(zip(leaves, grads))
    return fn
