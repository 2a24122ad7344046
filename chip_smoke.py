#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``chainermn_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``), and the
   kernels built from ``chainermn_tpu_torch/csrc`` (build seconds);
2. kernel check: the flash kernel against its plain PyTorch version on
   the card (bf16 causal at H 12, D 64, T in {16, 128, 200, 1024}, one
   non-causal and one fp32 case), and times of the kernel, the plain
   version and ``torch.nn.functional.scaled_dot_product_attention`` (timed
   as a yardstick only; the port never calls it) at T in {128, 256, 512,
   1024};
3. serving: a GPT-2-small-class ``TransformerLM`` (vocab 32768, d 768,
   12 heads of 64, 12 layers, random weights from seed 0, bf16) served by
   ``ServingEngine`` (512 pages of 16, batch 8, context 1024): 16 chat
   requests from 4 tenants (a fixed 64-token system prompt per tenant
   ahead of a random tail, 80-900 prompt tokens, 32 new tokens each);
   the kernel's launch count is read around this run alone;
4. decode parity: prefill plus 8 decode steps through the engine's
   programs against the one-shot forward, within the bf16 band.

Then the kernels line (launches, error, times and bound) and, last,
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before the last line.  Needs one CUDA card; fails without one.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 on
# CUDA cores, HBM3 bandwidth.  The bound is the larger of bytes / rate
# and operations / peak for the inputs' type.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12

# the kernel against its plain version: bf16 rounds p and the output at
# different points (a few bf16 ulps of |out| <= 4); fp32 only reorders sums
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
BF16_BAND = 0.25   # logits, paged decode vs one-shot (decode-parity suite)

MODEL = dict(n_vocab=32768, d_model=768, n_heads=12, n_layers=12,
             max_len=1024, seed=0)
ENGINE = dict(num_pages=512, page_size=16, max_batch=8, max_context=1024)
N_REQUESTS, N_TENANTS, SYS_PROMPT, MAX_NEW = 16, 4, 64, 32


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn):
    """Run ``fn`` under ``torch.profiler``: wall seconds, the device's
    busy seconds (union of kernel intervals) and per-kernel device
    microseconds by name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return wall, busy * 1e-6, by_name


def qkv(T, dtype, seed, H=12, D=64):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((1, H, T, D), generator=g, device="cuda")
            .to(dtype) for _ in range(3)]


def bound(T, dtype, causal, H=12, D=64):
    from chainermn_tpu_torch.ops.flash_attention import (attention_bytes,
                                                         attention_flops)
    itemsize = torch.finfo(dtype).bits // 8
    t_bytes = attention_bytes(1, H, T, T, D, itemsize) / HBM_BYTES_PER_S
    t_ops = attention_flops(1, H, T, T, D, causal) / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_device_ms(fn, iters=20):
    """Mean device time of the flash kernel alone (profiler), without the
    host-side cost of each call that the event timing includes."""
    fn()
    _, _, by_name = device_profile(lambda: [fn() for _ in range(iters)])
    us = sum(t for name, t in by_name.items() if "flash_fwd_kernel" in name)
    return us / iters * 1e-3 if us else None


def phase_kernel():
    from chainermn_tpu_torch.ops import flash_attention, xla_attention
    checks = []
    for T, causal, dtype in [(16, True, torch.bfloat16),
                             (128, True, torch.bfloat16),
                             (200, True, torch.bfloat16),
                             (1024, True, torch.bfloat16),
                             (1024, False, torch.bfloat16),
                             (200, True, torch.float32)]:
        q, k, v = qkv(T, dtype, seed=T)
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = xla_attention(q, k, v, causal=causal)
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.isfinite(out.float()).all()) and err < TOL[dtype]
        checks.append({"T": T, "causal": causal, "dtype": str(dtype),
                       "max_abs_err": err, "tol": TOL[dtype], "ok": ok})
    times = []
    for T in (128, 256, 512, 1024):
        q, k, v = qkv(T, torch.bfloat16, seed=T + 1)
        b_ms, b_by = bound(T, torch.bfloat16, True)
        times.append({
            "T": T, "B": 1, "H": 12, "D": 64, "dtype": "bfloat16",
            "causal": True,
            "ms": time_ms(lambda: flash_attention(q, k, v, causal=True)),
            "plain_ms": time_ms(
                lambda: xla_attention(q, k, v, causal=True), iters=10),
            "library_ms": time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True)),
            "device_ms": kernel_device_ms(
                lambda: flash_attention(q, k, v, causal=True)),
            "bound_ms": b_ms, "bound_by": b_by})
    emit({"phase": "kernel_check", "checks": checks, "times": times})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        fail(f"flash kernel disagrees with its plain version: {bad}")
    return checks, times


def chat_requests(Request, n_vocab):
    rng = np.random.RandomState(0)
    sys_prompts = [rng.randint(0, n_vocab, SYS_PROMPT)
                   for _ in range(N_TENANTS)]
    reqs = []
    for i in range(N_REQUESTS):
        ten = rng.randint(N_TENANTS)
        tail = rng.randint(0, n_vocab, rng.randint(16, 837))
        reqs.append(Request(np.concatenate([sys_prompts[ten], tail]),
                            max_new_tokens=MAX_NEW, tenant=f"tenant{ten}",
                            request_id=i))
    return reqs


def phase_serving(model):
    from chainermn_tpu_torch.ops import flash_attention
    from chainermn_tpu_torch.serving import Request, ServingEngine
    engine = ServingEngine(model, device="cuda", **ENGINE)
    reqs = chat_requests(Request, MODEL["n_vocab"])
    prompt_len = {r.request_id: int(r.prompt.size) for r in reqs}
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    steps = engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    done = {r.request_id: r for r in engine.completed}
    # an evicted request's early tokens were folded into its prompt
    generated = {i: int(r.prompt.size) - prompt_len[i] + len(r.tokens)
                 for i, r in done.items()}
    n_layers = MODEL["n_layers"]
    row = {
        "phase": "serving", "requests": len(done), "steps": steps,
        "generated_tokens": sum(generated.values()),
        "tokens_per_s": sum(generated.values()) / wall, "wall_s": wall,
        "prefill_s": engine.prefill_s, "decode_s": engine.decode_s,
        "decode_steps": engine.decode_steps,
        "full_prefills": engine.full_prefills,
        "prefix_hits": engine.prefix_hits,
        "prefix_tokens_matched": engine.prefix_tokens_matched,
        "forks": engine.forks, "evictions": engine.evictions,
        "flash_launches": launches,
        "prompt_tokens": sum(prompt_len.values()),
        "kv_pool_bytes": engine.kv.pool_bytes,
    }
    emit(row)
    if sorted(done) != list(range(N_REQUESTS)):
        fail(f"completed {sorted(done)}, expected all {N_REQUESTS}")
    if any(n != MAX_NEW for n in generated.values()):
        fail(f"generated token counts {generated}, expected {MAX_NEW}")
    if not all(0 <= t < MODEL["n_vocab"] for r in done.values()
               for t in r.tokens):
        fail("a generated token lies outside the vocabulary")
    if launches <= 0 or launches != n_layers * engine.full_prefills:
        fail(f"flash kernel launches {launches} != {n_layers} x "
             f"{engine.full_prefills} full prefills")
    if not engine.allocator.check() or engine.allocator.used_pages:
        fail("page pool not returned in full")
    # where the time goes: the same load again (prefix pages now cold, so
    # every tenant's first request misses again) under the profiler
    for r in chat_requests(Request, MODEL["n_vocab"]):
        engine.submit(r)
    wall, busy, by_name = device_profile(engine.drain)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    emit({"phase": "serving_profile", "wall_s": wall, "device_busy_s": busy,
          "device_idle_share": 1.0 - busy / wall,
          "top_kernels_us": [[name[:80], us] for name, us in top]})
    return launches


def phase_decode_parity(model):
    from chainermn_tpu_torch.serving import (PagedKVCache, decode_program,
                                             prefill_program)
    blk = model.blocks[0].attn
    kv = PagedKVCache(MODEL["n_layers"], 64, 16, blk.n_heads, blk.d_head,
                      device="cuda")
    prompt = np.random.RandomState(1).randint(0, MODEL["n_vocab"], 100)
    bt = torch.arange(64, device="cuda")
    tokens = torch.zeros((1, 128), dtype=torch.long, device="cuda")
    tokens[0, :100] = torch.from_numpy(prompt).cuda()
    logits = prefill_program(model, kv, tokens, 100, bt)
    seq = list(prompt)
    diffs = []
    for step in range(9):
        with torch.no_grad():
            ref = model.logits(torch.tensor([seq], device="cuda"))[0, -1]
        diffs.append((logits - ref.float()).abs().max().item())
        if step == 8:
            break
        tok = int(torch.argmax(logits))
        seq.append(tok)
        logits, _ = decode_program(
            model, kv, torch.tensor([tok], device="cuda"),
            torch.tensor([len(seq) - 1], device="cuda"), bt[None],
            mode="paged")
        logits = logits[0]
    emit({"phase": "decode_parity", "max_abs_diff_per_step": diffs,
          "band": BF16_BAND})
    if not max(diffs) < BF16_BAND:
        fail(f"paged decode logits leave the bf16 band: {diffs}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chainermn_tpu_torch._build import (build_log, library_path,
                                          load_library)
    from chainermn_tpu_torch.models import TransformerLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    load_library()
    build_s = time.perf_counter() - t0
    # nvcc's -Xptxas -v report (registers, spills) beside the library
    with open(library_path().with_suffix(".log"), "w") as f:
        f.write(build_log())
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s})

    checks, times = phase_kernel()
    model = TransformerLM(compute_dtype=torch.bfloat16, device="cuda",
                          **MODEL)
    launches = phase_serving(model)
    phase_decode_parity(model)

    main_check = next(c for c in checks if c["T"] == 1024 and c["causal"])
    main_time = next(t for t in times if t["T"] == 1024)
    emit({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "chainermn_tpu_torch/csrc/flash_attention.cu",
        "replaces": "chainermn_tpu/ops/flash_attention.py:322",
        "launches": launches,
        "max_abs_err": main_check["max_abs_err"],
        "ms": main_time["ms"], "plain_ms": main_time["plain_ms"],
        "bound_ms": main_time["bound_ms"],
        "bound_by": main_time["bound_by"],
        "library_ms": main_time["library_ms"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
