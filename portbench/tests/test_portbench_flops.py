"""The counts from shapes against PyTorch's own count of the plain
reference's products (``FlopCounterMode``), on the CPU at a small size."""

import importlib

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, weights
from portbench.reference import gpt, resnet

RESNET = {"blocks": [1, 2, 1, 1], "widths": [64, 128, 256, 512],
          "expansion": 4, "n_classes": 10, "image_size": 64,
          "channels": 3, "bn_eps": 2e-5,
          "input_mean": [0.485, 0.456, 0.406],
          "input_std": [0.229, 0.224, 0.225]}
GPT = {"n_embd": 64, "n_head": 4, "n_layer": 2, "n_positions": 32,
       "vocab_size": 97, "initializer_range": 0.02,
       "layer_norm_epsilon": 1e-5}


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_resnet50_published_count():
    # ResNet-50 v1.5 at 224^2: 4.09 G multiply-adds a forward pass
    macs = sum(m for _, m in flops.resnet_convs([3, 4, 6, 3],
                                                [64, 128, 256, 512],
                                                224, 1000))
    assert macs == 4_089_184_256


@pytest.mark.parametrize("batch", [1, 3])
def test_resnet_train_flops_match_counter(batch):
    p = weights.draw(resnet.param_specs(RESNET), 3, "cpu")
    x = torch.randint(0, 256, (batch, 64, 64, 3), dtype=torch.uint8)
    t = torch.randint(0, 10, (batch,))
    leaves = {k: v.requires_grad_() for k, v in p.items()}
    forward = _counted(lambda: resnet.loss(RESNET, leaves, x, t,
                                           recompute=False))
    args = (RESNET["blocks"], RESNET["widths"], 64, 10)
    assert forward == batch * flops.resnet_forward_flops(*args)

    def step():
        value = resnet.loss(RESNET, leaves, x, t, recompute=False)
        torch.autograd.grad(value, list(leaves.values()))
    assert _counted(step) == batch * flops.resnet_train_flops(*args)


@pytest.mark.parametrize("rows,T", [(2, 32), (3, 17)])
def test_gpt_train_flops_match_counter(rows, T):
    p = weights.draw(gpt.param_specs(GPT), 4, "cpu")
    x = torch.randint(0, 97, (rows, T))
    t = torch.randint(0, 97, (rows, T))
    fn = gpt.loss_and_grads(GPT, rows_per_block=2)
    # the reference computes attention over every (q, k) pair and masks
    # it: the count of the non-causal products
    per_token = flops.gpt_train_flops_per_token(64, 2, 97, T, causal=False)
    assert _counted(lambda: fn(p, (x, t))) == rows * T * per_token


def test_causal_attention_counts_the_live_pairs():
    for Tq, Tk in [(1, 1), (5, 5), (7, 3), (3, 7), (1024, 1024)]:
        mask = torch.ones(Tq, Tk).tril()   # query q sees keys 0..q
        assert flops.live_pairs(Tq, Tk, True) == int(mask.sum())
    per_token = flops.gpt_train_flops_per_token(768, 12, 50257, 1024)
    full = flops.gpt_train_flops_per_token(768, 12, 50257, 1024,
                                           causal=False)
    attention = 6 * 2 * 12 * 768
    assert full - per_token == pytest.approx(attention * (1024 - 1025 / 2))


def test_flash_counts_are_the_ports_convention():
    module = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    for B, H, Tq, Tk, D, causal in [(2, 3, 16, 16, 64, True),
                                    (1, 2, 8, 12, 32, False),
                                    (32, 12, 1024, 1024, 64, True)]:
        assert flops.attention_fwd_flops(B, H, Tq, Tk, D, causal) \
            == module.attention_flops(B, H, Tq, Tk, D, causal)
        assert flops.attention_fwd_bytes(B, H, Tq, Tk, D, 2, lse=False) \
            == module.attention_bytes(B, H, Tq, Tk, D, 2)
        assert flops.attention_bwd_flops(B, H, Tq, Tk, D, causal) \
            == module.attention_bwd_flops(B, H, Tq, Tk, D, causal)


def test_bound_picks_the_larger_time():
    t, by = flops.bound_s(989e12, 1.0)
    assert (t, by) == (1.0, "operations")
    t, by = flops.bound_s(1.0, 3.35e12)
    assert (t, by) == (1.0, "bytes")
