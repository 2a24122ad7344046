"""ResNet configurations on the port: ``Classifier(ResNet(blocks))`` in
the configuration's layout and compute type, fed uint8 images that it
standardizes on the device."""

from __future__ import annotations

import torch

from .. import flops
from ..reference import resnet as reference

#: what one step's batch counts in, for the end-to-end rate
ITEM = "images"

param_specs = reference.param_specs


def build_model(cfg, device):
    from chainermn_tpu_torch.models import Classifier, ResNet
    from chainermn_tpu_torch.models.resnet import IMAGENET_MEAN, IMAGENET_STD
    if list(cfg["widths"]) != [64, 128, 256, 512] or cfg["expansion"] != 4:
        raise ValueError("the port's ResNet has the widths 64-2048 of the "
                         f"paper; the configuration asks {cfg['widths']}")
    if (tuple(cfg["input_mean"]), tuple(cfg["input_std"])) \
            != (IMAGENET_MEAN, IMAGENET_STD):
        raise ValueError("the configuration's input statistics are not "
                         "the port's ImageNet preset")
    return Classifier(ResNet(
        cfg["blocks"], n_classes=cfg["n_classes"],
        compute_dtype=getattr(torch, cfg["compute_dtype"]),
        layout=cfg["layout"], input_norm="imagenet", device=device))


def first_gradient(opt, path):
    """The first step's mean gradient of ``path`` as the optimizer got
    it, from its state after that step: MomentumSGD's trace starts at 0,
    so after one step it is the gradient."""
    return opt.actual_optimizer._state[path]["trace"]


def train_flops_per_item(cfg, traffic):
    return flops.resnet_train_flops(cfg["blocks"], cfg["widths"],
                                    cfg["image_size"], cfg["n_classes"])


def items_per_example(cfg, traffic):
    return 1
