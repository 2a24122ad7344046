"""B1, the flash forward with lse (csrc/flash_fwd_sm90.cu): its bound
from the shapes (portbench/flops.py) over its device time a call, %."""

import torch

from portbench import flops
from portbench.readers import roofline

KERNELS = ("(anonymous namespace)::flash_fwd_sm90_kernel",)


def read(ctx):
    cfg, tr = ctx.config, ctx.traffic
    B, T, H = tr["batch_per_rank"], tr["seq_len"], cfg["n_head"]
    D = cfg["n_embd"] // H
    size = torch.finfo(getattr(torch, cfg["compute_dtype"])).bits // 8
    bound, _ = flops.bound_s(flops.attention_fwd_flops(B, H, T, T, D, True),
                             flops.attention_fwd_bytes(B, H, T, T, D, size))
    return roofline(ctx, "fwd_lse", KERNELS, bound)
