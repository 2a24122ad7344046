"""GPT-2 configurations on the port: ``TransformerLM`` in the
configuration's compute type (the flash kernels' forward with lse and
fused backward on the card), trained on next-token targets."""

from __future__ import annotations

import torch

from .. import flops
from ..reference import gpt as reference

ITEM = "tokens"

param_specs = reference.param_specs


def build_model(cfg, device):
    from chainermn_tpu_torch.models import TransformerLM
    if cfg["n_inner"] is not None or cfg["activation_function"] != "gelu_new":
        raise ValueError("the port's block is the 4x MLP with tanh GELU")
    return TransformerLM(
        cfg["vocab_size"], d_model=cfg["n_embd"], n_heads=cfg["n_head"],
        n_layers=cfg["n_layer"], max_len=cfg["n_positions"],
        compute_dtype=getattr(torch, cfg["compute_dtype"]), device=device)


def first_gradient(opt, path):
    """The first step's mean gradient of ``path`` from Adam's state after
    that step: ``mu = (1 - beta1) g``."""
    actual = opt.actual_optimizer
    return actual._state[path]["mu"] / (1.0 - actual.beta1)


def train_flops_per_item(cfg, traffic):
    return flops.gpt_train_flops_per_token(
        cfg["n_embd"], cfg["n_layer"], cfg["vocab_size"], traffic["seq_len"])


def items_per_example(cfg, traffic):
    return traffic["seq_len"]
