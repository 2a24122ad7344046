#!/usr/bin/env python3
"""Every device op of one split flash attention backward call at the
training shape, and its dq and dk/dv passes beside SDPA's backward, on one
CUDA card.

    python3 tools/flash_split_ops.py [--tree PATH]

``--tree`` names the checkout whose ``chainermn_tpu_torch`` is imported
(default: the one holding this script), so that two commits can be timed
in one call on one card: unpack the other with ``git archive`` into a
directory that ``.gitignore`` lists and run the two in turns (parent,
change, change, parent).  Each tree builds its own kernels.

Prints the card's name and power limit, then one JSON line: the tree, the
device microseconds per call (mean of 20 calls, from the profiler) of the
dq pass's kernel, of the dk/dv pass's kernel and of SDPA's backward (a
yardstick; the port never calls it), and of one split
``flash_attention_bwd`` call: its every device op by name, their sum, and
the part that is neither pass's kernel.  Inputs: B 8, H 12, T 1024, D 64,
bf16, causal, q/k/v sliced out of one ``[B, T, 3, H, D]`` projection and
a transposed cotangent, as the model hands them over.
"""

import argparse
import importlib
import json
import os
import subprocess
import sys

import torch

B, H, T, D = 8, 12, 1024, 64
ITERS = 20


def ops_us(fn):
    """``{name: device microseconds per call}`` of every kernel and
    memset that ``fn`` puts on the card (mean over ITERS calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + (e.time_range.end - e.time_range.start)
                               / ITERS)
    return by_name


def kernel_us(by_name, part):
    """The device time of the ops whose name holds ``part``."""
    return sum(us for name, us in by_name.items() if part in name)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_split_ops: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    if not os.path.abspath(fa.__file__).startswith(tree + os.sep):
        raise SystemExit(f"imported {fa.__file__}, not from {tree}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(13)
    qkv = torch.randn((B, T, 3, H, D), generator=gen,
                      device="cuda").bfloat16()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    g = torch.randn((B, T, H, D), generator=gen,
                    device="cuda").bfloat16().transpose(1, 2)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    delta = fa.flash_attention_bwd_delta(g, out)
    dq_ops = ops_us(lambda: fa.flash_attention_bwd_dq(
        q, k, v, g, lse, delta, causal=True))
    dkv_ops = ops_us(lambda: fa.flash_attention_bwd_dkv(
        q, k, v, g, lse, delta, causal=True))
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o = torch.nn.functional.scaled_dot_product_attention(*leaves,
                                                         is_causal=True)
    sdpa = sum(ops_us(lambda: torch.autograd.grad(
        o, leaves, g, retain_graph=True)).values())
    fa._FLASH_BWD = "split"
    call = ops_us(lambda: fa.flash_attention_bwd(q, k, v, out, lse, g,
                                                 causal=True))
    call_us = sum(call.values())
    in_call = {part: kernel_us(call, part)
               for part in ("flash_bwd_dq", "flash_bwd_sm90")}
    print(json.dumps({
        "tree": tree, "torch": torch.__version__,
        "dq_kernel_us": kernel_us(dq_ops, "flash_bwd_dq"),
        "dkv_kernel_us": kernel_us(dkv_ops, "flash_bwd_sm90"),
        "sdpa_bwd_us": sdpa,
        "split_call_us": call_us,
        "split_call_kernels_us": in_call,
        "split_call_rest_us": call_us - sum(in_call.values()),
        "split_call_ops_us": sorted(([n[:100], us] for n, us in call.items()),
                                    key=lambda kv: -kv[1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
