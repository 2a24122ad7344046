"""ResNet family: the ImageNet flagship of the data-parallel path.

The port of ``chainermn_tpu.models.resnet`` (reference capability:
``chainer.links.model.vision.resnet`` and ChainerMN's
``examples/imagenet/train_imagenet.py``): the same links, seeds and
parameter and persistent paths (so a JAX snapshot with its running
statistics loads, see ``serializers.npz``).

* ``layout="NHWC"`` runs channels-last activations: each convolution
  hands cuDNN a channels-last view and a channels-last kernel, so no
  layout conversion runs between convolution, batch norm and ReLU.
  Kernels are stored OIHW in either layout.
* ``compute_dtype=torch.bfloat16`` runs the convolutions and the
  activations in bf16, with fp32 parameters (each convolution casts its
  kernel per call) and fp32 batch-norm statistics.  The fc runs on the
  fp32 pooled vector.
* ``input_norm="imagenet"`` standardizes raw uint8 pixels on the device:
  an fp32 multiply-add, then one cast to the compute dtype.
* ``remat=True`` checkpoints each stage (``torch.utils.checkpoint``):
  the backward runs the stage's forward again instead of keeping its
  activations.  The running statistics (``avg_mean``, ``avg_var``,
  ``N``) move once a step: the recompute's own moves are undone
  (:func:`checkpoint_link`), as the JAX package threads them through
  ``jax.checkpoint`` as inputs and outputs.  Under sync batch norm the
  recompute runs its allreduces again, on every rank in the same order.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import checkpoint as _ckpt

from .. import observability
from .._device import resolve_device
from ..core.link import Chain, ChainList
from ..nn import functions as F
from ..nn import links as L

__all__ = ["ResNet", "ResNet50", "ResNet18", "ResNet101",
           "BottleneckBlock", "BasicBlock", "IMAGENET_MEAN", "IMAGENET_STD",
           "input_norm_consts", "normalize_input", "checkpoint_link"]

# ImageNet channel statistics in 0-1 scale
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def input_norm_consts(input_norm):
    """(scale, bias) folding 0-255 -> 0-1 and channel standardization into
    one multiply-add, ``y = x scale + bias = (x / 255 - mean) / std``, as
    fp32 host arrays; None for ``input_norm=None``.  ``input_norm`` is
    "imagenet" or a (mean, std) pair in 0-1 scale."""
    if input_norm is None:
        return None
    if isinstance(input_norm, str):
        if input_norm != "imagenet":
            raise ValueError(
                f"unknown input_norm preset {input_norm!r}; valid: "
                "'imagenet', None, or a (mean, std) pair in 0-1 scale")
        mean, std = IMAGENET_MEAN, IMAGENET_STD
    else:
        mean, std = input_norm
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return 1.0 / (255.0 * std), -mean / std


def normalize_input(x, consts, layout, compute_dtype):
    """Cast and (with ``consts``) standardize on the device: the
    multiply-add in fp32, then one cast of the result to
    ``compute_dtype`` (None keeps the dtype).  ``consts`` may be host
    arrays or tensors on ``x``'s device."""
    if consts is None:
        return x if compute_dtype is None else x.to(compute_dtype)
    shape = (1, 1, 1, 3) if layout == "NHWC" else (1, 3, 1, 1)
    scale, bias = (torch.as_tensor(c, dtype=torch.float32, device=x.device)
                   .reshape(shape) for c in consts)
    out = x.float() * scale + bias
    return out if compute_dtype is None else out.to(compute_dtype)


class ConvBN(Chain):
    """Convolution (no bias) -> batch norm -> optional ReLU, in the input's
    dtype: the fp32 kernel is cast to it per call, the BN statistics are
    fp32 inside."""

    def __init__(self, in_ch, out_ch, ksize, stride=1, pad=0, seed=None,
                 layout="NCHW", device=None):
        super().__init__()
        bn_axis = (0, 1, 2) if layout == "NHWC" else None   # None: (0, 2, 3)
        self.conv = L.Convolution2D(in_ch, out_ch, ksize, stride=stride,
                                    pad=pad, nobias=True, seed=seed,
                                    layout=layout, device=device)
        self.bn = L.BatchNormalization(out_ch, axis=bn_axis, device=device)

    def forward(self, x, activate=True):
        h = self.conv(x)
        with observability.scope("model/bn_act"):
            h = self.bn(h)
            if activate:
                h = F.relu(h)
            return h.to(x.dtype)


class BottleneckBlock(Chain):
    """1x1 -> 3x3 -> 1x1 bottleneck with an optional projection
    shortcut."""

    def __init__(self, in_ch, mid_ch, out_ch, stride=1, project=False,
                 seed=0, layout="NCHW", device=None):
        super().__init__()
        self.project = project or in_ch != out_ch or stride != 1
        kw = dict(layout=layout, device=device)
        self.a = ConvBN(in_ch, mid_ch, 1, seed=seed, **kw)
        self.b = ConvBN(mid_ch, mid_ch, 3, stride=stride, pad=1,
                        seed=seed + 1, **kw)
        self.c = ConvBN(mid_ch, out_ch, 1, seed=seed + 2, **kw)
        if self.project:
            self.shortcut = ConvBN(in_ch, out_ch, 1, stride=stride,
                                   seed=seed + 3, **kw)

    def forward(self, x):
        h = self.c(self.b(self.a(x)), activate=False)
        s = self.shortcut(x, activate=False) if self.project else x
        with observability.scope("model/residual_act"):
            return F.relu(h + s)


class BasicBlock(Chain):
    """3x3 -> 3x3 block (ResNet-18/34)."""

    def __init__(self, in_ch, out_ch, stride=1, seed=0, layout="NCHW",
                 device=None):
        super().__init__()
        self.project = in_ch != out_ch or stride != 1
        kw = dict(layout=layout, device=device)
        self.a = ConvBN(in_ch, out_ch, 3, stride=stride, pad=1, seed=seed,
                        **kw)
        self.b = ConvBN(out_ch, out_ch, 3, pad=1, seed=seed + 1, **kw)
        if self.project:
            self.shortcut = ConvBN(in_ch, out_ch, 1, stride=stride,
                                   seed=seed + 2, **kw)

    def forward(self, x):
        h = self.b(self.a(x), activate=False)
        s = self.shortcut(x, activate=False) if self.project else x
        with observability.scope("model/residual_act"):
            return F.relu(h + s)


class _Stage(ChainList):
    def __init__(self, n_blocks, in_ch, mid_ch, out_ch, stride, seed,
                 layout="NCHW", device=None):
        blocks = [BottleneckBlock(in_ch, mid_ch, out_ch, stride=stride,
                                  project=True, seed=seed, layout=layout,
                                  device=device)]
        for i in range(1, n_blocks):
            blocks.append(BottleneckBlock(out_ch, mid_ch, out_ch,
                                          seed=seed + 10 * i, layout=layout,
                                          device=device))
        super().__init__(*blocks)

    def forward(self, x):
        for block in self:
            x = block(x)
        return x


def checkpoint_link(link, x):
    """``link(x)`` under ``torch.utils.checkpoint``, with ``link``'s
    persistent values moved once: the backward's recompute of the
    forward puts back the values it found.  Outside autograd (no grad,
    or an input that needs none) ``link(x)`` runs plainly."""
    if not (torch.is_grad_enabled()
            and (x.requires_grad or any(p.requires_grad
                                        for p in link.parameters()))):
        return link(x)
    values = [b for _, b in link.namedpersistent()]
    calls = [0]

    def run(h):
        calls[0] += 1
        if calls[0] == 1:
            return link(h)
        saved = [b.clone() for b in values]
        try:
            return link(h)
        finally:   # also when the recompute stops early
            with torch.no_grad():
                torch._foreach_copy_(values, saved)

    # the stage draws no randomness: no RNG state to stash and restore
    return _ckpt.checkpoint(run, x, use_reentrant=False,
                            preserve_rng_state=False)


def _input_consts(input_norm, device):
    consts = input_norm_consts(input_norm)
    return None if consts is None else tuple(
        torch.from_numpy(c).to(device) for c in consts)


class ResNet(Chain):
    """Bottleneck ResNet with ``block_counts`` blocks per stage (widths
    64-2048 fixed by the class)."""

    def __init__(self, block_counts, n_classes=1000, compute_dtype=None,
                 seed=42, remat=False, layout="NCHW", input_norm=None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.layout = layout
        self.input_norm = input_norm
        self._in_consts = _input_consts(input_norm, device)
        kw = dict(layout=layout, device=device)
        self.conv1 = ConvBN(3, 64, 7, stride=2, pad=3, seed=seed, **kw)
        self.res2 = _Stage(block_counts[0], 64, 64, 256, 1, seed + 100, **kw)
        self.res3 = _Stage(block_counts[1], 256, 128, 512, 2, seed + 200,
                           **kw)
        self.res4 = _Stage(block_counts[2], 512, 256, 1024, 2, seed + 300,
                           **kw)
        self.res5 = _Stage(block_counts[3], 1024, 512, 2048, 2, seed + 400,
                           **kw)
        self.fc = L.Linear(2048, n_classes, seed=seed + 500, device=device)

    def forward(self, x):
        x = normalize_input(x, self._in_consts, self.layout,
                            self.compute_dtype)
        h = self.conv1(x)
        h = F.max_pooling_2d(h, 3, stride=2, pad=1, cover_all=False,
                             layout=self.layout)
        for stage in (self.res2, self.res3, self.res4, self.res5):
            h = checkpoint_link(stage, h) if self.remat else stage(h)
        h = F.global_average_pooling_2d(h, layout=self.layout)
        return self.fc(h.float())


class ResNet50(ResNet):
    def __init__(self, n_classes=1000, compute_dtype=None, seed=42,
                 remat=False, layout="NCHW", input_norm=None, device=None):
        super().__init__([3, 4, 6, 3], n_classes, compute_dtype, seed,
                         remat=remat, layout=layout, input_norm=input_norm,
                         device=device)


class ResNet101(ResNet):
    def __init__(self, n_classes=1000, compute_dtype=None, seed=42,
                 remat=False, layout="NCHW", input_norm=None, device=None):
        super().__init__([3, 4, 23, 3], n_classes, compute_dtype, seed,
                         remat=remat, layout=layout, input_norm=input_norm,
                         device=device)


class ResNet18(Chain):
    """ResNet-18 on basic blocks, NCHW."""

    def __init__(self, n_classes=1000, compute_dtype=None, seed=42,
                 input_norm=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.input_norm = input_norm
        self._in_consts = _input_consts(input_norm, device)
        cfg = [(64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2)]
        self.conv1 = ConvBN(3, 64, 7, stride=2, pad=3, seed=seed,
                            device=device)
        stages = []
        for i, (in_ch, out_ch, stride) in enumerate(cfg):
            stages.append(BasicBlock(in_ch, out_ch, stride,
                                     seed=seed + 100 * (i + 1),
                                     device=device))
            stages.append(BasicBlock(out_ch, out_ch,
                                     seed=seed + 100 * (i + 1) + 50,
                                     device=device))
        self.body = ChainList(*stages)
        self.fc = L.Linear(512, n_classes, seed=seed + 999, device=device)

    def forward(self, x):
        x = normalize_input(x, self._in_consts, "NCHW", self.compute_dtype)
        h = self.conv1(x)
        h = F.max_pooling_2d(h, 3, stride=2, pad=1, cover_all=False)
        for block in self.body:
            h = block(h)
        h = F.global_average_pooling_2d(h)
        return self.fc(h.float())
