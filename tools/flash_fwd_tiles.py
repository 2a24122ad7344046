#!/usr/bin/env python3
"""Device time of the port's bf16 flash forward at each of its key tiles,
beside SDPA's, on one CUDA card: the measurements behind
``chainermn_tpu_torch.ops.flash_attention._fwd_block_k``.

    python3 tools/flash_fwd_tiles.py

Prints the card's name and power limit, then one JSON line per shape:
the profiler's device microseconds per launch of the lse forward for each
key tile at D 64 (q tiles of 64 rows), of
``torch.nn.functional.scaled_dot_product_attention`` (a yardstick; the
port never calls it), the key tile ``_fwd_block_k`` picks, and the largest
difference between the tiles' outputs (the same function; bf16 rounding).
The key tiles and SDPA are timed with the profiler tracing the card
alone; the picked tile and SDPA once more with the host traced too
(``*_host_traced``), as ``chip_smoke.py`` traces them.
"""

import importlib
import json
import os
import subprocess
import sys

import torch

BLOCK_K = (64, 128)
# (B, T, causal, strided): training (q/k/v sliced out of one projection),
# a serving prefill at B 1, and the sizes around the rule's threshold
SHAPES = ((8, 1024, True, True), (1, 1024, True, False),
          (4, 1024, True, False), (8, 1024, False, False),
          (2, 2048, True, False))
H, D = 12, 64


def device_us(fn, iters=20, host_traced=False):
    """Mean device time of one call: every kernel it launches, summed."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA]
    if host_traced:
        acts.append(ProfilerActivity.CPU)
    fn()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / iters


def inputs(B, T, strided, gen):
    if strided:
        qkv = torch.randn((B, T, 3, H, D), generator=gen, device="cuda")
        return [qkv[:, :, i].transpose(1, 2).bfloat16() for i in range(3)]
    return [torch.randn((B, H, T, D), generator=gen, device="cuda")
            .bfloat16() for _ in range(3)]


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    pick = fa._fwd_block_k
    try:
        for B, T, causal, strided in SHAPES:
            q, k, v = inputs(B, T, strided, gen)
            row = {"B": B, "H": H, "T": T, "D": D, "causal": causal,
                   "strided": strided, "picked": pick(B, H, T, D)}
            outs = []
            for bk in BLOCK_K:
                fa._fwd_block_k = lambda *_, t=bk: t
                fwd = lambda: fa.flash_attention_fwd(q, k, v, causal=causal)
                row[f"us_64x{bk}"] = device_us(fwd)
                outs.append(fwd()[0].float())
            fa._fwd_block_k = pick
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal)
            row["sdpa_us"] = device_us(sdpa)
            row["picked_us_host_traced"] = device_us(
                lambda: fa.flash_attention_fwd(q, k, v, causal=causal),
                host_traced=True)
            row["sdpa_us_host_traced"] = device_us(sdpa, host_traced=True)
            row["max_diff_between_tiles"] = max(
                (o - outs[0]).abs().max().item() for o in outs[1:])
            print(json.dumps(row), flush=True)
    finally:
        fa._fwd_block_k = pick
    return 0


if __name__ == "__main__":
    sys.exit(main())
