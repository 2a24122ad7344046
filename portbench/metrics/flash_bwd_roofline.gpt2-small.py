"""B2, the fused flash backward (csrc/flash_bwd_sm90.cu) with its delta
pass and dq epilogue: its bound from the shapes (portbench/flops.py) over
the device time of one call's three kernels, %."""

import torch

from portbench import flops
from portbench.readers import roofline

KERNELS = ("(anonymous namespace)::flash_bwd_sm90_kernel",
           "(anonymous namespace)::bwd_delta_kernel",
           "(anonymous namespace)::dq_epilogue_kernel")


def read(ctx):
    cfg, tr = ctx.config, ctx.traffic
    B, T, H = tr["batch_per_rank"], tr["seq_len"], cfg["n_head"]
    D = cfg["n_embd"] // H
    size = torch.finfo(getattr(torch, cfg["compute_dtype"])).bits // 8
    bound, _ = flops.bound_s(flops.attention_bwd_flops(B, H, T, T, D, True),
                             flops.attention_bwd_bytes(B, H, T, T, D, size))
    return roofline(ctx, "bwd", KERNELS, bound)
