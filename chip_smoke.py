#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``chainermn_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``), and the
   kernels built from ``chainermn_tpu_torch/csrc`` (build seconds,
   registers and spill bytes per kernel instantiation from ptxas, and per
   Hopper instantiation the counts of ``HGMMA`` (wgmma) and ``UTMALDG``
   (TMA tile loads) in the library's SASS, which every bf16 forward and
   backward instantiation must have);
2. kernel check: the flash kernel against its plain PyTorch version on
   the card (bf16 causal at B 1, H 12, D 64, T in {16, 128, 200, 1024},
   one non-causal and one fp32 case),
   and times of the kernel (per call, on
   the device, and the host's cost of one launch), the plain version and
   ``torch.nn.functional.scaled_dot_product_attention`` (per call and its
   kernels' device time; timed as a yardstick only, the port never calls
   it) at T in {128, 256, 512, 1024};
3. serving: a GPT-2-small-class ``TransformerLM`` (vocab 32768, d 768,
   12 heads of 64, 12 layers, random weights from seed 0, bf16) served by
   ``ServingEngine`` (512 pages of 16, batch 8, context 1024): 16 chat
   requests from 4 tenants (a fixed 64-token system prompt per tenant
   ahead of a random tail, 80-900 prompt tokens, 32 new tokens each);
   the kernel's launch count is read around this run alone;
4. decode parity: prefill plus 8 decode steps through the engine's
   programs against the one-shot forward, within the bf16 band;
5. kernel check, training: the lse forward, the delta pass and the fused
   backward against their plain versions (the backward also against torch
   autograd through ``xla_attention``, and its dq epilogue bitwise against
   the scale and cast of its fp32 accumulator) at bf16 causal B 2, H 12,
   D 64, T in {1, 16, 200, 1024}, non-causal Tq 128 / Tk 200, D 128, fp32,
   a non-zero lse cotangent, and at the training shape (B 8, T 1024) on
   q/k/v sliced out of one projection with a transposed cotangent, as the
   model hands them over; then times of both kernels there (per call,
   device, the whole call's device time ``call_device_ms``: for the
   backward the delta pass, kernel and epilogue; host cost per launch), of
   their plain versions and of SDPA's forward and backward (per call and
   device; yardsticks only);
6. kernel check, split backward (``kernel_check_split``): the dq and dk/dv
   kernels against their plain versions, against torch autograd through
   ``xla_attention`` and against the fused kernel, on the cases of phase
   5 and at scales 0, -0.125 and 0.0625; then their times, the device
   time of the whole split backward call (delta pass and both passes) and
   each of its device ops by name (``ops_us``), their plain versions'
   times, SDPA's backward (the pair's yardstick) and their bounds at the
   training shape;
7. train: the same model (bf16, Adam alpha 3e-4) trained through
   ``Trainer`` -> ``StandardUpdater`` -> ``Adam.update`` on a
   ``SerialIterator`` of 16 random token rows (batch 8 x T 1024): step
   time, tokens/s, MFU, losses, peak memory and the kernels' launch
   counts, read around this run alone (12 lse forwards, 12 delta passes
   and 12 fused backwards per step); one no-grad eval forward; then 3
   steps under the profiler (``train_profile``);
8. train_dp: the same model and data trained data-parallel, as ChainerMN
   does: ``create_communicator("pure_nccl", allreduce_grad_dtype=
   "bfloat16")`` over NCCL in a world of one process (one card), then
   ``bcast_data``, ``scatter_dataset`` and ``Trainer`` ->
   ``StandardUpdater`` -> ``create_multi_node_optimizer(Adam)``, with the
   backward on the split kernels (``_FLASH_BWD = "split"`` for this phase
   only): step time, tokens/s, MFU, losses, peak memory, launches (12 lse
   forwards, 12 delta passes, 12 dq and 12 dk/dv passes per step) and the
   gradient
   allreduces (one flat bf16 bucket per step); then 3 profiled steps
   (``train_dp_profile``); the process group is torn down after it;
9. train parity: one step of a small fp32 model (2 layers, d 256, 4 heads
   of 64, T 256) through the kernels against the same step with attention
   forced through ``xla_attention``: the loss and every gradient;
10. train_dp_parity, on that small model: (a) a world-of-one DP step with
    a lossless wire leaves every parameter bitwise equal to the
    single-card Adam step, (b) the bf16 wire leaves each gradient equal to
    the fp32 one rounded to bf16 and back, bitwise, (c) the DP step
    through the split kernels matches the step through ``xla_attention``
    within the parity tolerance.

11. train_resnet: bench.py's flagship, ``Classifier(ResNet50(n_classes=
    1000, compute_dtype=torch.bfloat16, seed=0, layout="NHWC"))`` trained
    data-parallel through ``Trainer`` -> ``StandardUpdater`` ->
    ``create_multi_node_optimizer(MomentumSGD(lr=0.1, momentum=0.9))``
    over ``create_communicator("pure_nccl", allreduce_grad_dtype=
    "bfloat16")`` (a world of one NCCL process, one flat bucket), batch
    64 of 224 x 224 x 3 NHWC fp32 N(0, 1) images and random labels from
    numpy seed 0 (bench.py's data, two batches repeated), 12 steps of
    which 2 warm up: images/s per card, MFU (bench.py's 12.3 GFLOP per
    image), losses (finite), peak memory, the gradient allreduces (one
    per step) and the bucket's bytes, and the cuDNN autotuner flag it ran
    with (the package sets none); the flash kernels' counts stay 0; then
    the same steps with ``cudnn.benchmark`` on (``train_resnet_cudnn_
    benchmark``), and 3 profiled steps (``train_resnet_profile``: device
    busy and idle share, the top device ops, their time by class --
    convolution, elementwise, reduction, host copies, optimizer -- and
    any cuDNN layout conversion), and ``train_resnet_parts``: the device
    time of one step's gradient exchange and of its update, each timed
    alone by CUDA events while a spin kernel holds the queue back
    (``queued_device_ms``);
12. resnet_parity: the CPU tests' small fp32 ResNet (one block per stage,
    16 x 16, batch 8, NHWC) with TF32 off: (a) a world-of-one DP step is
    bitwise the single-card step (``cudnn.deterministic`` on for this
    check), (b) 3 DP steps on the card match the same steps on the CPU;
13. train_resnet_db, train_resnet_rs, train_resnet_zero: ``train_resnet``'s
    step with only the exchange changed -- ``double_buffering=True``,
    ``exchange="reduce_scatter"``, ``zero_sharding=True`` -- each run
    twice, in turns around a second run of the plain exchange
    (``train_resnet_plain``), each with
    images/s, MFU, losses, peak memory and the collectives, 3 profiled
    steps (device idle share), the device time of the exchange and of
    the update (the sharded ones: chunk rule, all-gather and unpack),
    and ``train_resnet``'s numbers from this call beside them; the
    double-buffered one also lists the streams its NCCL kernels and its
    compute kernels ran on;
14. exchange_parity: the small fp32 ResNet of phase 12 with each exchange:
    (a) at a world of one the reduce-scatter and ZeRO runs are bitwise
    the plain DP run and the double-buffered run's parameters after
    step 2 are bitwise the plain run's after step 1
    (``cudnn.deterministic`` on), (b) each exchange's 3 steps on the card
    match the same exchange's 3 steps on the CPU (a gloo group beside
    the NCCL world) within phase 12's tolerances;
15. train_mnist: ``python -m chainermn_tpu_torch.examples.train_mnist``'s
    trainer at its defaults (-b 100 -u 100, synthetic MNIST 6000/1000)
    for 2 epochs with a snapshot after epoch 1; a fresh trainer loads
    that snapshot and runs epoch 2, whose log entry must equal the
    uninterrupted run's (bitwise); the wall time per epoch and the last
    log entry;
16. train_mnist_dp: the data-parallel twin's trainer (NCCL, a world of
    one) with ``create_multi_node_evaluator`` and an
    ``ObservationAggregator`` for 1 epoch; its last log entry.

Then the kernels line (launches, error, times, the whole call's device
time and bound of all five kernels) and, last, ``{"ok": true, "device": {...}}``.  Any failed check
exits non-zero before the last line.  Needs one CUDA card; fails without
one.
"""

import importlib
import json
import os
import re
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
# backward against its plain version.  bf16: each of dq, dk, dv relative
# to its own largest |ref| (bwd_errs); both sides round p and ds to bf16
# before the dots, but dq's tiles add in another order and a last-bit
# difference of an fp32 value can flip a rounding.  fp32: absolute (sum
# order, expf).
BWD_TOL = {torch.bfloat16: 5e-3, torch.float32: 2e-4}
# backward against torch autograd through xla_attention, same measure:
# autograd keeps ds in fp32 where the kernel (as the JAX kernel) casts it
# to bf16 before the dk and dq dots, a difference that sums over the keys
LSE_TOL = 1e-4     # lse is fp32 on both sides: log of a sum in another order
# the delta pass: fp32 rowsums of D products of order 1 on both sides, in
# another order (|delta| < 64, a few fp32 ulps)
DELTA_TOL = 1e-4
AUTOGRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
# training parity, fp32 model: loss absolute, gradients relative to each
# parameter's largest |grad| (summation order and expf through 2 layers)
PARITY_TOL = {"loss": 1e-5, "grad": 1e-4}

MODEL = dict(n_vocab=32768, d_model=768, n_heads=12, n_layers=12,
             max_len=1024, seed=0)
ENGINE = dict(num_pages=512, page_size=16, max_batch=8, max_context=1024)
N_REQUESTS, N_TENANTS, SYS_PROMPT, MAX_NEW = 16, 4, 64, 32
# training: bench.py's transformer configuration (batch 8 x T 1024, Adam
# alpha 3e-4); 2 warm-up steps, then the timed ones
TRAIN_BATCH, TRAIN_ROWS, TRAIN_STEPS, TRAIN_WARMUP = 8, 16, 10, 2
# ResNet-50: bench.py's flagship (BENCH_MODEL=resnet50: bs 64 per chip,
# 224^2, NHWC, bf16, MomentumSGD lr 0.1 momentum 0.9), cut to 12 steps (2
# warm-up) over 2 batches
RESNET = dict(n_classes=1000, seed=0, layout="NHWC")
RESNET_BATCH, RESNET_IMAGE, RESNET_STEPS, RESNET_WARMUP = 64, 224, 12, 2
# resnet_parity: the CPU tests' small fp32 ResNet.  The card and the CPU
# sum convolutions and batch moments in other orders; a ReLU kink crossed
# on one side only moves a few weights (tests/test_torch_resnet.py), so
# lr 1e-3 and: losses 1e-4 relative, parameters and statistics 1e-3
RESNET_PARITY = dict(blocks=[1, 1, 1, 1], n_classes=10, batch=8, size=16,
                     lr=1e-3)
RESNET_PARITY_TOL = {"loss_rel": 1e-4, "state_abs": 1e-3}


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def kernel_label(mangled):
    """A readable name for one of the library's kernel instantiations:
    ``flash_fwd_sm90_kernel<bf16,D64,BK128,lse>`` (D and key tile of the
    bf16 forward), ``flash_bwd_sm90_kernel<bf16,D64,dq>`` (the bf16
    backward, fused with dq or the dk/dv pass ``dkv``),
    ``flash_bwd_dq_sm90_kernel<bf16,D64>`` (the bf16 dq pass),
    ``flash_bwd_kernel<fp32,D64>``; other names as they are."""
    k = re.search(r"(flash_(?:fwd_sm90|fwd|bwd_sm90|bwd_dq_sm90|bwd_dq|"
                  r"bwd_dkv|bwd)_kernel)I", mangled)
    if not k:
        return mangled
    args = mangled[k.end():]
    ints = re.findall(r"Li(\d+)E", args)
    lse = ",lse" if "Lb1E" in args else ""
    if k.group(1) == "flash_fwd_sm90_kernel" and len(ints) == 2:
        return f"{k.group(1)}<bf16,D{ints[0]},BK{ints[1]}{lse}>"
    if k.group(1) == "flash_bwd_sm90_kernel" and ints:
        part = "dq" if "Lb1E" in args else "dkv"
        return f"{k.group(1)}<bf16,D{ints[0]},{part}>"
    if k.group(1) == "flash_bwd_dq_sm90_kernel" and ints:
        return f"{k.group(1)}<bf16,D{ints[0]}>"
    dtype = "bf16" if "bfloat16" in args else "fp32"
    return f"{k.group(1)}<{dtype},D{ints[0] if ints else '?'}{lse}>"


def ptxas_report(log):
    """Registers and spill bytes per kernel instantiation, from nvcc's
    ``-Xptxas -v`` output (empty when the library was built earlier)."""
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_label(m.group(1))
            report[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                report[name]["spill_stores"] = int(m.group(1))
                report[name]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report[name]["registers"] = int(m.group(1))
    return report


#: the kernels whose bf16 instantiations must run on wgmma and TMA
SM90_KERNELS = ("flash_fwd_sm90_kernel<bf16", "flash_bwd_sm90_kernel<bf16",
                "flash_bwd_dq_sm90_kernel<bf16")


def sass_counts(lib):
    """Per Hopper kernel instantiation of the built library (the bf16
    forward and backward), the counts of ``HGMMA`` (wgmma) and ``UTMALDG``
    (TMA tile load) instructions in ``cuobjdump -sass``."""
    from chainermn_tpu_torch._build import cuda_tool
    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            label = kernel_label(m.group(1))
            name = label if label.startswith(SM90_KERNELS) else None
            if name:
                counts[name] = {"HGMMA": 0, "UTMALDG": 0}
        elif name:
            for op in ("HGMMA", "UTMALDG"):
                counts[name][op] += op in line
    return counts


def host_us(fn, n=50):
    """Host wall time of ``n`` launches enqueued without a sync, per
    launch, in microseconds: the wrapper's and the launch's cost on the
    CPU."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    per = (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return per * 1e6


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


def qkv(T, dtype, seed, H=12, D=64, B=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((B, H, T, D), generator=g, device="cuda")
            .to(dtype) for _ in range(3)]


def bound(T, dtype, causal, H=12, D=64):
    from chainermn_tpu_torch.ops.flash_attention import (attention_bytes,
                                                         attention_flops)
    itemsize = torch.finfo(dtype).bits // 8
    t_bytes = attention_bytes(1, H, T, T, D, itemsize) / HBM_BYTES_PER_S
    t_ops = attention_flops(1, H, T, T, D, causal) / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


#: the profiler's names of the port's kernels, template arguments and
#: parameters stripped (``kernel_base_name``): compared whole, so that
#: PyTorch's own ``pytorch_flash::flash_fwd_kernel`` never matches
FWD_KERNEL = "(anonymous namespace)::flash_fwd_sm90_kernel"
# one bf16 body for B2 (its dq flag on) and B4's dk/dv pass (off)
BWD_KERNEL = "(anonymous namespace)::flash_bwd_sm90_kernel"
SPLIT_KERNELS = {"dq": "(anonymous namespace)::flash_bwd_dq_sm90_kernel",
                 "dkv": BWD_KERNEL}


def kernel_base_name(name):
    """``void ns::f<a, b>(args)`` -> ``ns::f``."""
    anon = "(anonymous namespace)"
    base = name.removeprefix("void ").replace(anon, "\0")
    return re.split(r"[<(]", base, maxsplit=1)[0].replace("\0", anon)


def kernel_device_ms(fn, kernel, iters=20):
    """Mean device time of one kernel alone (profiler), without the
    host-side cost of each call that the event timing includes."""
    fn()
    _, _, by_name = device_profile(lambda: [fn() for _ in range(iters)])
    us = sum(t for name, t in by_name.items()
             if kernel_base_name(name) == kernel)
    return us / iters * 1e-3 if us else None


def device_ops_us(fn, iters=20):
    """Every kernel and memset that one call of ``fn`` puts on the card:
    ``[name, device microseconds per call]`` (the mean over ``iters``
    calls, the same kind of window as ``kernel_device_ms``; names cut to
    80 characters), largest first."""
    fn()
    _, _, by_name = device_profile(lambda: [fn() for _ in range(iters)])
    return sorted(([n[:80], us / iters] for n, us in by_name.items()),
                  key=lambda kv: -kv[1])


def library_device_ms(fn, iters=20):
    """Mean device time of one library call (a yardstick): the sum of
    ``device_ops_us``; None when the profiler recorded no device event
    (not measured)."""
    us = sum(t for _, t in device_ops_us(fn, iters))
    return us * 1e-3 if us else None


def phase_kernel():
    from chainermn_tpu_torch.ops import flash_attention, xla_attention
    checks = []
    # B 1 takes 128-key tiles (PERF.md); kernel_check_train's B 8 takes 64
    for B, T, causal, dtype in [(1, 16, True, torch.bfloat16),
                                (1, 128, True, torch.bfloat16),
                                (1, 200, True, torch.bfloat16),
                                (1, 1024, True, torch.bfloat16),
                                (1, 1024, False, torch.bfloat16),
                                (1, 200, True, torch.float32)]:
        q, k, v = qkv(T, dtype, seed=T, B=B)
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = xla_attention(q, k, v, causal=causal)
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.isfinite(out.float()).all()) and err < TOL[dtype]
        checks.append({"B": B, "T": T, "causal": causal,
                       "dtype": str(dtype), "max_abs_err": err,
                       "tol": TOL[dtype], "ok": ok})
    times = []
    for T in (128, 256, 512, 1024):
        q, k, v = qkv(T, torch.bfloat16, seed=T + 1)
        b_ms, b_by = bound(T, torch.bfloat16, True)
        kernel = lambda: flash_attention(q, k, v, causal=True)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)
        times.append({
            "T": T, "B": 1, "H": 12, "D": 64, "dtype": "bfloat16",
            "causal": True, "ms": time_ms(kernel),
            "plain_ms": time_ms(
                lambda: xla_attention(q, k, v, causal=True), iters=10),
            "library_ms": time_ms(sdpa),
            "device_ms": kernel_device_ms(kernel, FWD_KERNEL),
            "library_device_ms": library_device_ms(sdpa),
            "call_device_ms": library_device_ms(kernel),
            "host_us": host_us(kernel),
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
    from chainermn_tpu_torch.serving import Request, ServingEngine
    engine = ServingEngine(model, device="cuda", **ENGINE)
    reqs = chat_requests(Request, MODEL["n_vocab"])
    prompt_len = {r.request_id: int(r.prompt.size) for r in reqs}
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    steps = engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    all_launches = read_launches()
    launches = all_launches["fwd"]
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
    if launches <= 0 or all_launches != expected_launches(
            fwd=n_layers * engine.full_prefills):
        fail(f"flash kernel launches {all_launches}, expected {n_layers} x "
             f"{engine.full_prefills} full prefills of the no-grad forward")
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


def flash_module():
    """``chainermn_tpu_torch.ops.flash_attention``, the module (the
    package's ``ops.flash_attention`` name is the function)."""
    return importlib.import_module("chainermn_tpu_torch.ops.flash_attention")


def train_inputs(B, Tq, Tk, D, dtype, seed, H=12, strided=False):
    """q, k, v and an output cotangent g.  ``strided``: q/k/v sliced out
    of one ``[B, T, 3, H, D]`` projection and g a transposed
    ``[B, T, H, D]`` tensor, the layouts the model hands the kernels."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    if strided:
        qkv = randn(B, Tq, 3, H, D)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        return q, k, v, randn(B, Tq, H, D).transpose(1, 2)
    return randn(B, H, Tq, D), randn(B, H, Tk, D), randn(B, H, Tk, D), \
        randn(B, H, Tq, D)


def bwd_errs(got, ref, dtype):
    """The errors of dq, dk and dv in BWD_TOL's measure.  bf16: each
    relative to its own largest |ref|, floored at 2 ** -8 of the largest
    |ref| of the three (at T 1, dq and dk are rounding noise around 0 and
    have no scale of their own)."""
    errs = [(a.float() - b.float()).abs().max().item()
            for a, b in zip(got, ref)]
    if dtype == torch.float32:
        return errs
    scales = [b.float().abs().max().item() for b in ref]
    floor = 2.0 ** -8 * max(scales)
    return [e / max(s, floor) for e, s in zip(errs, scales)]


def check_train_kernels(q, k, v, g, causal, g_lse=None):
    """B1 against its plain version (out, lse), B2 against its plain
    version and against torch autograd through xla_attention."""
    fa = flash_module()
    dtype = q.dtype
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    ref_out, ref_lse = fa._flash_fwd_lse_plain(q, k, v, causal=causal)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                   g_lse=g_lse)
    got_delta = fa.flash_attention_bwd_delta(g, out, g_lse)
    # the epilogue alone: dq is its fp32 accumulator scaled and cast
    scale = fa._scale(None, q.shape[-1])
    acc, dq = fa._fused_bwd(q, k, v, out, lse, g, causal, scale, g_lse)[:2]
    torch.cuda.synchronize()
    delta = fa._bwd_delta_plain(g, out, g_lse)
    ref = fa._flash_bwd_plain(q, k, v, g, lse, delta, causal=causal)
    row = {"B": q.shape[0], "Tq": q.shape[2], "Tk": k.shape[2],
           "D": q.shape[3], "causal": causal, "dtype": str(dtype),
           "strided": not q.is_contiguous(), "g_lse": g_lse is not None,
           "out_err": (out.float() - ref_out.float()).abs().max().item(),
           "lse_err": (lse - ref_lse).abs().max().item(),
           "bwd_err_dq_dk_dv": bwd_errs(grads, ref, dtype),
           "bwd_abs_err": max((a.float() - b.float()).abs().max().item()
                              for a, b in zip(grads, ref)),
           "delta_err": (got_delta - delta).abs().max().item(),
           "epilogue_bitwise": torch.equal(dq, (acc * scale).to(dtype)),
           "finite": all(bool(torch.isfinite(x.float()).all())
                         for x in (out, lse, *grads))}
    if g_lse is None:
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        torch.autograd.backward(
            fa.xla_attention(*leaves, causal=causal), g)
        row["autograd_err_dq_dk_dv"] = bwd_errs(
            grads, [x.grad for x in leaves], dtype)
    row["ok"] = (row["finite"] and row["out_err"] < TOL[dtype]
                 and row["lse_err"] < LSE_TOL
                 and row["delta_err"] < DELTA_TOL
                 and row["epilogue_bitwise"]
                 and max(row["bwd_err_dq_dk_dv"]) < BWD_TOL[dtype]
                 and max(row.get("autograd_err_dq_dk_dv", [0.0]))
                 < AUTOGRAD_TOL[dtype])
    return row


def train_cases():
    """The backward kernels' cases: ``(q, k, v, g, causal, g_lse)``, bf16
    causal at T 1, 16, 200, 1024, non-causal Tq 128 / Tk 200, D 128, fp32,
    a non-zero lse cotangent, strided T 300, and last the training shape
    (B 8, T 1024) in the layouts the model hands over."""
    bf16 = torch.bfloat16
    cases = [(*train_inputs(2, T, T, 64, bf16, T), True, None)
             for T in (1, 16, 200, 1024)]
    cases.append((*train_inputs(2, 128, 200, 64, bf16, 7), False, None))
    cases.append((*train_inputs(2, 200, 200, 128, bf16, 8), True, None))
    cases.append((*train_inputs(2, 200, 200, 64, torch.float32, 9), True,
                  None))
    g_lse = torch.randn((2, 12, 200), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(11))
    cases.append((*train_inputs(2, 200, 200, 64, bf16, 10), True, g_lse))
    cases.append((*train_inputs(2, 300, 300, 64, bf16, 12, strided=True),
                  True, None))
    B, T = TRAIN_BATCH, MODEL["max_len"]
    cases.append((*train_inputs(B, T, T, 64, bf16, 13, strided=True), True,
                  None))
    return cases


def bound_of(nbytes, ops, dtype=torch.bfloat16):
    """The larger of bytes over the HBM rate and operations over the
    dtype's peak, in ms, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_backward(q, k, v, g):
    """SDPA's backward alone, on a retained graph (a yardstick; the port
    never calls it)."""
    lq, lk, lv = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        lq, lk, lv, is_causal=True)
    return lambda: torch.autograd.grad(out, (lq, lk, lv), g,
                                       retain_graph=True)


def phase_kernel_train():
    fa = flash_module()
    cases = train_cases()
    checks = [check_train_kernels(q, k, v, g, causal, g_lse=g_lse)
              for q, k, v, g, causal, g_lse in cases]
    main = checks[-1]
    emit({"phase": "kernel_check_train", "checks": checks})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        fail(f"training kernels disagree with their plain versions: {bad}")

    q, k, v, g = cases[-1][:4]
    B, H, T, D = q.shape
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    delta = fa._bwd_delta_plain(g, out)
    fwd_bytes = fa.attention_bytes(B, H, T, T, D, 2) + B * H * T * 4
    fwd_ops = fa.attention_flops(B, H, T, T, D, True)
    bwd_bytes = fa.attention_bwd_bytes(B, H, T, T, D, 2)
    bwd_ops = fa.attention_bwd_flops(B, H, T, T, D, True)

    fwd = lambda: fa.flash_attention_fwd(q, k, v, causal=True)
    bwd = lambda: fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True)
    sdpa_bwd = sdpa_backward(q, k, v, g)
    times = {
        "B": B, "H": H, "T": T, "D": D, "dtype": "bfloat16",
        "causal": True, "strided": True,
        "fwd_lse": {
            "ms": time_ms(fwd),
            "device_ms": kernel_device_ms(fwd, FWD_KERNEL),
            "host_us": host_us(fwd),
            "plain_ms": time_ms(lambda: fa._flash_fwd_lse_plain(
                q, k, v, causal=True), iters=5, warmup=1),
            "call_device_ms": library_device_ms(fwd),
            "library_ms": time_ms(sdpa),
            "library_device_ms": library_device_ms(sdpa),
            "max_abs_err": max(main["out_err"], main["lse_err"]),
        },
        "bwd": {
            "ms": time_ms(bwd),
            "device_ms": kernel_device_ms(bwd, BWD_KERNEL),
            # the whole call: delta pass (with the dq accumulator's
            # zeroing), kernel and dq epilogue, beside SDPA's whole call
            "call_device_ms": library_device_ms(bwd),
            "host_us": host_us(bwd),
            "plain_ms": time_ms(lambda: fa._flash_bwd_plain(
                q, k, v, g, lse, delta, causal=True), iters=5, warmup=1),
            "library_ms": time_ms(sdpa_bwd),
            "library_device_ms": library_device_ms(sdpa_bwd),
            "max_abs_err": main["bwd_abs_err"],
        },
    }
    (times["fwd_lse"]["bound_ms"],
     times["fwd_lse"]["bound_by"]) = bound_of(fwd_bytes, fwd_ops)
    times["bwd"]["bound_ms"], times["bwd"]["bound_by"] = bound_of(
        bwd_bytes, bwd_ops)
    emit({"phase": "kernel_check_train_times", **times})
    return times


def check_split_kernels(q, k, v, g, causal, g_lse=None, scale=None):
    """The dq and dk/dv kernels against their plain versions, against
    torch autograd through xla_attention and against the fused kernel,
    each of dq, dk, dv in BWD_TOL's measure."""
    fa = flash_module()
    dtype = q.dtype
    kw = {"causal": causal, "scale": scale}
    out, lse = fa._flash_fwd_lse_plain(q, k, v, **kw)
    delta = (g.float() * out.float()).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse
    got = (fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, **kw),
           *fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, **kw))
    torch.cuda.synchronize()
    ref = (fa._flash_bwd_dq_plain(q, k, v, g, lse, delta, **kw),
           *fa._flash_bwd_dkv_plain(q, k, v, g, lse, delta, **kw))
    fused = fa.flash_attention_bwd(q, k, v, out, lse, g, g_lse=g_lse, **kw)
    row = {"B": q.shape[0], "Tq": q.shape[2], "Tk": k.shape[2],
           "D": q.shape[3], "causal": causal, "dtype": str(dtype),
           "strided": not q.is_contiguous(), "g_lse": g_lse is not None,
           "scale": fa._scale(scale, q.shape[3]),
           "err_dq_dk_dv": bwd_errs(got, ref, dtype),
           "abs_err_dq_dk_dv": [(a.float() - b.float()).abs().max().item()
                                for a, b in zip(got, ref)],
           "fused_err_dq_dk_dv": bwd_errs(got, fused, dtype),
           "finite": all(bool(torch.isfinite(x.float()).all())
                         for x in got)}
    if g_lse is None:
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        torch.autograd.backward(fa.xla_attention(*leaves, **kw), g)
        row["autograd_err_dq_dk_dv"] = bwd_errs(
            got, [x.grad for x in leaves], dtype)
    row["ok"] = (row["finite"]
                 and max(row["err_dq_dk_dv"]) < BWD_TOL[dtype]
                 and max(row["fused_err_dq_dk_dv"]) < BWD_TOL[dtype]
                 and max(row.get("autograd_err_dq_dk_dv", [0.0]))
                 < AUTOGRAD_TOL[dtype])
    return row


def phase_kernel_split():
    fa = flash_module()
    cases = train_cases()
    checks = [check_split_kernels(q, k, v, g, causal, g_lse=g_lse)
              for q, k, v, g, causal, g_lse in cases]
    main = checks[-1]
    # any finite scale (0, below 0, above 0) at D 128 and on the strided
    # T 300 case
    checks += [check_split_kernels(*cases[i][:4], True, scale=scale)
               for i in (5, -2) for scale in (0.0, -0.125, 0.0625)]
    emit({"phase": "kernel_check_split", "checks": checks})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        fail(f"split backward kernels disagree: {bad}")

    q, k, v, g = cases[-1][:4]
    B, H, T, D = q.shape
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    delta = fa.flash_attention_bwd_delta(g, out)
    args = (q, k, v, g, lse, delta)
    sdpa_bwd = sdpa_backward(q, k, v, g)
    library_ms = time_ms(sdpa_bwd)
    library_dev_ms = library_device_ms(sdpa_bwd)
    saved = fa._FLASH_BWD
    fa._FLASH_BWD = "split"
    try:   # one split flash_attention_bwd call: delta pass, dq, dk/dv
        ops = device_ops_us(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, g, causal=True))
    finally:
        fa._FLASH_BWD = saved
    call_dev_ms = sum(us for _, us in ops) * 1e-3 or None
    times = {"B": B, "H": H, "T": T, "D": D, "dtype": "bfloat16",
             "causal": True, "strided": True,
             "library": "SDPA backward (dq, dk and dv: the pair's work)",
             "call_device_ms": call_dev_ms, "ops_us": ops}
    for part, kernel, plain, i in (
            ("dq", fa.flash_attention_bwd_dq, fa._flash_bwd_dq_plain, [0]),
            ("dkv", fa.flash_attention_bwd_dkv, fa._flash_bwd_dkv_plain,
             [1, 2])):
        call = lambda: kernel(*args, causal=True)
        ms, by = bound_of(fa.attention_bwd_bytes(B, H, T, T, D, 2, part),
                          fa.attention_bwd_flops(B, H, T, T, D, True, part))
        times[part] = {
            "ms": time_ms(call),
            "device_ms": kernel_device_ms(call, SPLIT_KERNELS[part]),
            "call_device_ms": call_dev_ms,
            "host_us": host_us(call),
            "plain_ms": time_ms(lambda: plain(*args, causal=True),
                                iters=5, warmup=1),
            "library_ms": library_ms,
            "library_device_ms": library_dev_ms,
            "bound_ms": ms, "bound_by": by,
            "max_abs_err": max(main["abs_err_dq_dk_dv"][j] for j in i)}
    emit({"phase": "kernel_check_split_times", **times})
    return times


def transformer_flops_per_token(d_model, n_layers, n_vocab, seq_len):
    """bench.py's analytic train-step flops per token for the causal LM:
    matmul fwd = 2 (12 L d^2 + d V), attention fwd = 4 T d L (causal
    halving ignored), train = 3x fwd."""
    matmul = 2.0 * (12.0 * n_layers * d_model ** 2 + d_model * n_vocab)
    attn = 4.0 * seq_len * d_model * n_layers
    return 3.0 * (matmul + attn)


#: the wrappers' launch counters, by short name
LAUNCH_COUNTERS = {"fwd": "flash_attention", "fwd_lse": "flash_attention_fwd",
                   "bwd": "flash_attention_bwd",
                   "bwd_delta": "flash_attention_bwd_delta",
                   "bwd_dq": "flash_attention_bwd_dq",
                   "bwd_dkv": "flash_attention_bwd_dkv"}


def reset_launches():
    fa = flash_module()
    for fn in LAUNCH_COUNTERS.values():
        getattr(fa, fn).launches = 0


def read_launches():
    fa = flash_module()
    return {key: getattr(fa, fn).launches
            for key, fn in LAUNCH_COUNTERS.items()}


def expected_launches(**counts):
    """The expected launch counts: the given ones, every other kernel 0."""
    return {key: counts.get(key, 0) for key in LAUNCH_COUNTERS}


def train_rows():
    """bench.py's transformer data, cut: 16 random token rows (numpy seed
    0) and their next-token targets, repeating every 2 steps."""
    rows = np.random.RandomState(0).randint(
        0, MODEL["n_vocab"], (TRAIN_ROWS, MODEL["max_len"])).astype(np.int64)
    return rows, [(x, np.roll(x, -1)) for x in rows]


def timed_trainer_run(opt, dataset, batch, steps, out):
    """``Trainer`` -> ``StandardUpdater`` -> ``opt`` for ``steps`` steps
    of ``batch`` examples, the launch counts read around this run alone:
    ``(updater, step_ms, losses, peak_bytes, launches)``, each step's
    time from CUDA events recorded after it (no host sync in the loop)."""
    from chainermn_tpu_torch.dataset import SerialIterator
    from chainermn_tpu_torch.training import StandardUpdater, Trainer
    updater = StandardUpdater(
        SerialIterator(dataset, batch, shuffle=False), opt)
    trainer = Trainer(updater, (steps, "iteration"),
                      out=os.path.join("build", out))
    losses, marks = [], []

    def record(tr):   # no sync: tensors and events, read after the run
        losses.append(tr.observation["main/loss"])
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    trainer.extend(record, name="record")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    trainer.run()
    torch.cuda.synchronize()
    launches = read_launches()
    step_ms = [start.elapsed_time(marks[0])] + [
        a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return (updater, step_ms, [float(x) for x in losses],
            torch.cuda.max_memory_allocated(), launches)


def run_training(opt, dataset, out):
    """``Trainer`` -> ``StandardUpdater`` -> ``opt`` for TRAIN_STEPS
    steps of TRAIN_BATCH rows, the launch counts read around this run
    alone: ``(updater, row)`` with the step times, tokens/s, MFU, losses,
    peak memory and launches."""
    T = MODEL["max_len"]
    updater, step_ms, losses, peak, launches = timed_trainer_run(
        opt, dataset, TRAIN_BATCH, TRAIN_STEPS, out)
    median_ms = float(np.median(step_ms[TRAIN_WARMUP:]))
    tokens_per_s = TRAIN_BATCH * T / (median_ms * 1e-3)
    flops_tok = transformer_flops_per_token(
        MODEL["d_model"], MODEL["n_layers"], MODEL["n_vocab"], T)
    return updater, {
        "batch": TRAIN_BATCH, "T": T, "steps": TRAIN_STEPS,
        "step_ms": step_ms, "median_step_ms": median_ms,
        "tokens_per_s": tokens_per_s, "flops_per_token": flops_tok,
        "mfu": flops_tok * tokens_per_s / PEAK_FLOPS[torch.bfloat16],
        "losses": losses, "peak_bytes": peak, "launches": launches}


def check_losses(name, losses):
    if not all(np.isfinite(losses)) or len(losses) != TRAIN_STEPS:
        fail(f"{name} losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{name}: the loss did not fall on repeated data: {losses}")


def profile_steps(name, updater, top_n=12, **extra):
    """3 more steps under the profiler: wall, device busy and idle share,
    and the top kernels by device time; each ``extra`` is a function of
    the per-kernel times whose value joins the row.  Returns the row."""
    wall, busy, by_name = device_profile(
        lambda: [updater.update() for _ in range(3)])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    row = {"phase": name, "steps": 3, "wall_s": wall, "device_busy_s": busy,
           "device_idle_share": 1.0 - busy / wall,
           "nccl_us": sum(us for n, us in by_name.items()
                          if "nccl" in n.lower()),
           "top_kernels_us": [[n[:80], us] for n, us in top[:top_n]],
           **{k: fn(by_name) for k, fn in extra.items()}}
    emit(row)
    return row


def phase_train():
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.models import TransformerLM
    n_layers = MODEL["n_layers"]
    model = TransformerLM(compute_dtype=torch.bfloat16, remat=False,
                          device="cuda", **MODEL)
    opt = Adam(alpha=3e-4)
    opt.setup(model)
    rows, data = train_rows()
    updater, row = run_training(opt, data, "chip_smoke_train")
    launches = row["launches"]
    # one eval forward without a gradient: the plain forward kernel only
    reset_launches()
    with torch.no_grad():
        model.logits(torch.from_numpy(rows[:TRAIN_BATCH]).cuda())
    torch.cuda.synchronize()
    eval_launches = read_launches()
    emit({"phase": "train", **row, "eval_launches": eval_launches})
    check_losses("training", row["losses"])
    want = expected_launches(fwd_lse=n_layers * TRAIN_STEPS,
                             bwd_delta=n_layers * TRAIN_STEPS,
                             bwd=n_layers * TRAIN_STEPS)
    if launches != want:
        fail(f"training launches {launches}, expected {want}")
    if eval_launches != expected_launches(fwd=n_layers):
        fail(f"eval launches {eval_launches}, expected {n_layers} of the "
             "no-grad forward only")
    profile_steps("train_profile", updater)
    return launches, row["median_step_ms"]


def phase_train_dp():
    """The data-parallel step on the card: NCCL world of one, bf16 flat
    bucket, split backward."""
    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer,
                                     scatter_dataset)
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.models import TransformerLM
    fa = flash_module()
    n_layers = MODEL["n_layers"]
    comm = create_communicator("pure_nccl", allreduce_grad_dtype="bfloat16")
    saved = fa._FLASH_BWD
    try:
        model = TransformerLM(compute_dtype=torch.bfloat16, remat=False,
                              device="cuda", **MODEL)
        comm.bcast_data(model)
        opt = create_multi_node_optimizer(Adam(alpha=3e-4), comm)
        opt.setup(model)
        _, data = train_rows()
        shard = scatter_dataset(data, comm)
        buckets = comm.grad_buckets_for(model)
        fa._FLASH_BWD = "split"
        comm.calls.clear()
        updater, row = run_training(opt, shard, "chip_smoke_train_dp")
        row.update({
            "phase": "train_dp", "communicator": comm.name,
            "world": comm.size, "backend": dist.get_backend(),
            "wire_dtype": str(comm.allreduce_grad_dtype),
            "buckets": len(buckets),
            "bucket_bytes": 2 * sum(p.numel() for p in model.parameters()),
            "grad_allreduces": comm.calls["allreduce_grad"],
            "collectives": dict(comm.calls)})
        emit(row)
        profile_steps("train_dp_profile", updater)
        # one gradient exchange alone (cast, pack, allreduce, divide,
        # unpack), every device op by name
        wall, busy, by_name = device_profile(
            lambda: comm.multi_node_mean_grad(model))
        emit({"phase": "train_dp_exchange", "wall_ms": wall * 1e3,
              "device_ms": busy * 1e3,
              "ops_us": sorted(([n[:80], us] for n, us in by_name.items()),
                               key=lambda kv: -kv[1])})
    finally:
        fa._FLASH_BWD = saved
        comm.finalize()
    check_losses("data-parallel training", row["losses"])
    want = expected_launches(fwd_lse=n_layers * TRAIN_STEPS,
                             bwd_delta=n_layers * TRAIN_STEPS,
                             bwd_dq=n_layers * TRAIN_STEPS,
                             bwd_dkv=n_layers * TRAIN_STEPS)
    if row["launches"] != want:
        fail(f"data-parallel launches {row['launches']}, expected {want}")
    if len(buckets) != 1 or row["grad_allreduces"] != TRAIN_STEPS \
            or comm.allreduce_grad_dtype != torch.bfloat16:
        fail(f"expected one flat bf16 gradient allreduce per step: "
             f"{len(buckets)} buckets, {row['grad_allreduces']} allreduces "
             f"over {TRAIN_STEPS} steps, wire {comm.allreduce_grad_dtype}")
    if dist.is_initialized():
        fail("the process group outlived the data-parallel phase")
    return row["launches"], row["median_step_ms"]


#: train_parity's small fp32 model
PARITY_MODEL = dict(n_vocab=1000, d_model=256, n_heads=4, n_layers=2,
                    max_len=256, seed=0, device="cuda")


def parity_batch():
    rows = np.random.RandomState(2).randint(0, PARITY_MODEL["n_vocab"],
                                            (2, 256))
    return (torch.from_numpy(rows).cuda(),
            torch.from_numpy(np.roll(rows, -1, axis=1)).cuda())


def grad_rel_err(grads, ref_grads):
    """Worst gradient error, relative to each parameter's largest |grad|."""
    return max((grads[p] - g).abs().max().item()
               / max(g.abs().max().item(), 1e-30)
               for p, g in ref_grads.items())


def phase_train_parity():
    """One step of a small fp32 model through the kernels against the
    same step with attention through the plain xla_attention."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.models import transformer as tm
    from chainermn_tpu_torch.ops import xla_attention
    x, t = parity_batch()

    def step():
        model = TransformerLM(**PARITY_MODEL)
        loss = model(x, t)
        loss.backward()
        return loss.item(), {p: v.grad for p, v in model.namedparams()}

    reset_launches()
    loss, grads = step()
    launches = read_launches()
    kernel_attention = tm.fused_attention
    tm.fused_attention = xla_attention
    try:
        ref_loss, ref_grads = step()
    finally:
        tm.fused_attention = kernel_attention
    grad_err = grad_rel_err(grads, ref_grads)
    row = {"phase": "train_parity", "loss": loss, "ref_loss": ref_loss,
           "loss_err": abs(loss - ref_loss), "grad_rel_err": grad_err,
           "tol": PARITY_TOL, "launches": launches}
    emit(row)
    if launches != expected_launches(fwd_lse=2, bwd_delta=2, bwd=2):
        fail(f"parity step launches {launches}, expected 2 + 2 + 2")
    if not (row["loss_err"] < PARITY_TOL["loss"]
            and grad_err < PARITY_TOL["grad"]):
        fail(f"training through the kernels leaves the plain step: {row}")


def phase_train_dp_parity():
    """On train_parity's model, with the split backward: (a) a world-of-
    one DP step (lossless wire) is bitwise the single-card Adam step, (b)
    the bf16 wire rounds each gradient to bf16 and back, bitwise, (c) the
    DP step through the split kernels matches the one through
    xla_attention within PARITY_TOL."""
    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.models import transformer as tm
    from chainermn_tpu_torch.ops import xla_attention
    fa = flash_module()
    x, t = parity_batch()
    saved = fa._FLASH_BWD
    fa._FLASH_BWD = "split"
    comm = create_communicator("pure_nccl")
    try:
        wire = create_communicator("pure_nccl",
                                   allreduce_grad_dtype="bfloat16")

        def step(data_parallel):
            model = TransformerLM(**PARITY_MODEL)
            opt = Adam(alpha=3e-4)
            if data_parallel:
                opt = create_multi_node_optimizer(opt, comm)
            opt.setup(model)
            loss = opt.update(model, x, t).item()
            return loss, dict(model.namedparams())

        # (a) the DP wrapper over a lossless world of one changes nothing
        loss, single = step(False)
        reset_launches()
        dp_loss, dp = step(True)
        launches = read_launches()
        a_equal = loss == dp_loss and all(
            torch.equal(dp[p], v) for p, v in single.items())
        # (b) the bf16 wire on one backward's gradients
        model = TransformerLM(**PARITY_MODEL)
        model(x, t).backward()
        raw = {p: v.grad.clone() for p, v in model.namedparams()}
        wire.multi_node_mean_grad(model)
        torch.cuda.synchronize()
        b_equal = all(v.grad.dtype == torch.float32
                      and torch.equal(v.grad, raw[p].bfloat16().float())
                      for p, v in model.namedparams())
        # (c) split kernels against plain attention, through the DP step
        kernel_attention = tm.fused_attention
        tm.fused_attention = xla_attention
        try:
            ref_loss, ref = step(True)
        finally:
            tm.fused_attention = kernel_attention
        grad_err = grad_rel_err({p: v.grad for p, v in dp.items()},
                                {p: v.grad for p, v in ref.items()})
        calls = dict(comm.calls)
    finally:
        fa._FLASH_BWD = saved
        comm.finalize()
    row = {"phase": "train_dp_parity", "a_bitwise_equal": a_equal,
           "loss": dp_loss, "single_card_loss": loss,
           "b_bf16_wire_bitwise": b_equal, "c_ref_loss": ref_loss,
           "c_loss_err": abs(dp_loss - ref_loss), "c_grad_rel_err": grad_err,
           "tol": PARITY_TOL, "launches": launches, "collectives": calls}
    emit(row)
    if launches != expected_launches(fwd_lse=2, bwd_delta=2, bwd_dq=2,
                                     bwd_dkv=2):
        fail(f"DP parity step launches {launches}, expected 2 x 4")
    if not (a_equal and b_equal and row["c_loss_err"] < PARITY_TOL["loss"]
            and grad_err < PARITY_TOL["grad"]):
        fail(f"the data-parallel step leaves its references: {row}")
    if dist.is_initialized():
        fail("the process group outlived the DP parity phase")


def resnet50_train_flops_per_image(image_size):
    """bench.py's analytic model: forward ~4.1 GFLOP at 224^2 (scaling
    with the area), train = 3x forward."""
    return 3.0 * 4.1e9 * (image_size / 224.0) ** 2


def resnet_data():
    """bench.py's ResNet data, cut to 2 batches: NHWC fp32 N(0, 1) images
    and labels in [0, 1000) from numpy seed 0."""
    from chainermn_tpu_torch.dataset import TupleDataset
    rng = np.random.RandomState(0)
    n = 2 * RESNET_BATCH
    x = rng.normal(0, 1, (n, RESNET_IMAGE, RESNET_IMAGE, 3)).astype(
        np.float32)
    return TupleDataset(x, rng.randint(0, 1000, n).astype(np.int32))


#: cuDNN's layout-conversion kernels: none may run on the NHWC path
LAYOUT_CONVERSIONS = ("nchwToNhwc", "nhwcToNchw")
#: classes of the ResNet step's device ops, by the first pattern its
#: name matches (case-insensitive); the rest is "other"
OP_CLASSES = [("optimizer", r"multi_tensor_apply"),
              ("host_copy", r"^memcpy|^memset"),
              ("reduction", r"reduce_kernel"),
              ("elementwise", r"elementwise|copy_kern|direct_copy"),
              ("nccl", r"nccl"),
              ("convolution", r"conv|xmma|cudnn|sm\d\d_|implicit|gemm|"
                              r"nvjet|cutlass|wgrad|dgrad|fprop")]


def op_class(name):
    return next((c for c, pat in OP_CLASSES
                 if re.search(pat, name, re.IGNORECASE)), "other")


def op_classes_us(by_name):
    """Device microseconds per OP_CLASSES class (sums over the run)."""
    out = {name: 0.0 for name, _ in OP_CLASSES}
    out["other"] = 0.0
    for n, us in by_name.items():
        out[op_class(n)] += us
    return out


def phase_train_resnet():
    """bench.py's ResNet-50 step, data-parallel over a world of one NCCL
    process with the bf16 flat bucket, through Trainer/StandardUpdater."""
    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer,
                                     scatter_dataset)
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.models import Classifier, ResNet50
    comm = create_communicator("pure_nccl", allreduce_grad_dtype="bfloat16")
    benchmark = torch.backends.cudnn.benchmark
    try:
        model = Classifier(ResNet50(compute_dtype=torch.bfloat16,
                                    device="cuda", **RESNET))
        comm.bcast_data(model)
        opt = create_multi_node_optimizer(
            MomentumSGD(lr=0.1, momentum=0.9), comm).setup(model)
        shard = scatter_dataset(resnet_data(), comm)
        buckets = comm.grad_buckets_for(model)
        n_params = sum(p.numel() for p in model.parameters())
        comm.calls.clear()
        updater, step_ms, losses, peak, launches = timed_trainer_run(
            opt, shard, RESNET_BATCH, RESNET_STEPS, "chip_smoke_resnet")
        median_ms = float(np.median(step_ms[RESNET_WARMUP:]))
        images_per_s = RESNET_BATCH / (median_ms * 1e-3)
        flops = resnet50_train_flops_per_image(RESNET_IMAGE)
        row = {
            "phase": "train_resnet", "model": "ResNet50", **RESNET,
            "compute_dtype": "bfloat16", "batch": RESNET_BATCH,
            "image": RESNET_IMAGE, "steps": RESNET_STEPS,
            "step_ms": step_ms, "median_step_ms": median_ms,
            "images_per_s": images_per_s, "flops_per_image": flops,
            "mfu": flops * images_per_s / PEAK_FLOPS[torch.bfloat16],
            "losses": losses, "peak_bytes": peak, "launches": launches,
            "cudnn_benchmark": benchmark,
            "communicator": comm.name, "world": comm.size,
            "backend": dist.get_backend(),
            "wire_dtype": str(comm.allreduce_grad_dtype),
            "buckets": len(buckets), "bucket_bytes": 2 * n_params,
            "params": n_params,
            "grad_allreduces": comm.calls["allreduce_grad"],
            "collectives": dict(comm.calls)}
        emit(row)
        # the same steps with the cuDNN autotuner on (a reading, not the
        # phase's configuration)
        torch.backends.cudnn.benchmark = True
        _, bench_ms, bench_losses, _, _ = timed_trainer_run(
            opt, shard, RESNET_BATCH, RESNET_STEPS, "chip_smoke_resnet_b")
        bench_median = float(np.median(bench_ms[RESNET_WARMUP:]))
        emit({"phase": "train_resnet_cudnn_benchmark", "step_ms": bench_ms,
              "median_step_ms": bench_median,
              "images_per_s": RESNET_BATCH / (bench_median * 1e-3),
              "losses": bench_losses})
        torch.backends.cudnn.benchmark = benchmark
        prof = profile_steps(
            "train_resnet_profile", updater, top_n=15,
            layout_conversions_us=lambda by_name: sum(
                us for n, us in by_name.items()
                if any(c in n for c in LAYOUT_CONVERSIONS)),
            classes_us=op_classes_us,
            conv_and_other_top_us=lambda by_name: sorted(
                ([n[:80], us] for n, us in by_name.items()
                 if op_class(n) in ("convolution", "other")),
                key=lambda kv: -kv[1])[:8])
        emit({"phase": "train_resnet_parts",
              **exchange_parts(opt, model, shard)})
    finally:
        torch.backends.cudnn.benchmark = benchmark
        comm.finalize()
    if not all(np.isfinite(losses + bench_losses)) \
            or len(losses) != RESNET_STEPS:
        fail(f"ResNet-50 losses {losses}, {bench_losses}")
    if launches != expected_launches():
        fail(f"the ResNet-50 step launched flash kernels: {launches}")
    if len(buckets) != 1 or row["grad_allreduces"] != RESNET_STEPS \
            or comm.allreduce_grad_dtype != torch.bfloat16:
        fail(f"expected one flat bf16 gradient allreduce per step: "
             f"{len(buckets)} buckets, {row['grad_allreduces']} allreduces "
             f"over {RESNET_STEPS} steps, wire {comm.allreduce_grad_dtype}")
    if prof["device_busy_s"] <= 0 or not prof["classes_us"]["convolution"]:
        fail(f"the profiled ResNet-50 steps ran no convolution on the card: "
             f"{prof['classes_us']}")
    if dist.is_initialized():
        fail("the process group outlived the ResNet-50 phase")
    return {**row, "device_idle_share": prof["device_idle_share"]}


def queued_device_ms(fn, spin_cycles=int(1e8)):
    """``fn``'s time on the card with its launches queued behind a spin
    kernel (~50 ms), so that its kernels run back to back whatever the
    host's speed: CUDA events around ``fn``, recorded while the card
    spins.  Returns ``(ms, host_ms, fn's result)``; ``host_ms``, the
    host's time to enqueue ``fn``, must stay below the spin for the
    reading to hold."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return start.elapsed_time(end), host_ms, out


def exchange_parts(opt, model, shard):
    """The device time of one step's gradient exchange and of its
    update, on the gradients of one batch (each part once untimed
    first): ``opt._exchange`` (plain: cast, pack, allreduce, divide,
    unpack; double-buffered: pack, launch, wait for the previous step's
    exchange and unpack it; sharded: pack, reduce-scatter, cast, divide)
    and ``opt._apply_update`` (the rule; sharded: pack the parameters,
    the rule on the chunk, all-gather, unpack)."""
    from chainermn_tpu_torch.dataset import concat_examples
    x, t = concat_examples([shard[i] for i in range(RESNET_BATCH)], "cuda")
    model.cleargrads()
    grads = opt._gradients(model(x, t))
    opt._apply_update(opt._exchange(grads))
    ex_ms, ex_host, exchanged = queued_device_ms(lambda: opt._exchange(grads))
    up_ms, up_host, _ = queued_device_ms(lambda: opt._apply_update(exchanged))
    if max(ex_host, up_host) > 40:
        fail(f"enqueueing a part took {ex_host}, {up_host} ms: the spin "
             "no longer covers it")
    return {"exchange_device_ms": ex_ms, "update_device_ms": up_ms,
            "exchange_host_ms": ex_host, "update_host_ms": up_host}


def kernel_streams(fn):
    """The CUDA streams the kernels of ``fn`` ran on, from the profiler's
    trace: ``{"nccl": [...], "other": [...]}`` (NCCL's kernels by name)
    and the number of NCCL kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join("build", "chip_smoke_streams.json")
    os.makedirs("build", exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    streams = {"nccl": set(), "other": set()}
    n_nccl = 0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        nccl = "nccl" in e.get("name", "").lower()
        n_nccl += nccl
        streams["nccl" if nccl else "other"].add(
            e.get("args", {}).get("stream"))
    return {"nccl_kernels": n_nccl,
            "nccl_streams": sorted(streams["nccl"], key=str),
            "compute_streams": sorted(streams["other"], key=str)}


#: the exchanges phase 13 runs beside train_resnet's
RESNET_EXCHANGES = {"train_resnet_db": dict(double_buffering=True),
                    "train_resnet_rs": dict(exchange="reduce_scatter"),
                    "train_resnet_zero": dict(zero_sharding=True),
                    "train_resnet_plain": {}}
#: their order: each exchange twice, in turns around a second reading of
#: the plain one, so that a drift of the host over the call shows
RESNET_EXCHANGE_ORDER = ["train_resnet_db", "train_resnet_rs",
                         "train_resnet_zero", "train_resnet_plain",
                         "train_resnet_zero", "train_resnet_rs",
                         "train_resnet_db"]


def phase_train_resnet_exchange(phase, plain_row, reading=1):
    """``train_resnet``'s step with only the exchange changed (world of
    one NCCL process, bf16 wire), beside ``plain_row`` from this call;
    ``reading`` numbers the runs of one exchange."""
    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer,
                                     scatter_dataset)
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.models import Classifier, ResNet50
    exchange = RESNET_EXCHANGES[phase]
    comm = create_communicator("pure_nccl", allreduce_grad_dtype="bfloat16")
    try:
        model = Classifier(ResNet50(compute_dtype=torch.bfloat16,
                                    device="cuda", **RESNET))
        comm.bcast_data(model)
        opt = create_multi_node_optimizer(
            MomentumSGD(lr=0.1, momentum=0.9), comm, **exchange).setup(model)
        shard = scatter_dataset(resnet_data(), comm)
        comm.calls.clear()
        updater, step_ms, losses, peak, launches = timed_trainer_run(
            opt, shard, RESNET_BATCH, RESNET_STEPS, f"chip_smoke_{phase}")
        calls = dict(comm.calls)
        median_ms = float(np.median(step_ms[RESNET_WARMUP:]))
        images_per_s = RESNET_BATCH / (median_ms * 1e-3)
        flops = resnet50_train_flops_per_image(RESNET_IMAGE)
        prof = profile_steps(f"{phase}_profile", updater, top_n=10,
                             classes_us=op_classes_us)
        row = {"phase": phase, "reading": reading, "exchange": exchange,
               "steps": RESNET_STEPS,
               "step_ms": step_ms, "median_step_ms": median_ms,
               "images_per_s": images_per_s,
               "mfu": flops * images_per_s / PEAK_FLOPS[torch.bfloat16],
               "losses": losses, "peak_bytes": peak, "launches": launches,
               "device_idle_share": prof["device_idle_share"],
               "collectives": calls,
               **exchange_parts(opt, model, shard),
               "train_resnet": {k: plain_row[k] for k in (
                   "median_step_ms", "images_per_s", "mfu", "peak_bytes",
                   "device_idle_share")}}
        if exchange.get("double_buffering"):
            row["streams"] = kernel_streams(
                lambda: [updater.update() for _ in range(2)])
        if opt._sharded_update:
            n, n_pad, lo, hi = opt._flat_layout()
            row["flat_layout"] = {"n": n, "n_pad": n_pad, "chunk": [lo, hi]}
        opt._reset_exchange()
        emit(row)
    finally:
        comm.finalize()
    sharded = phase in ("train_resnet_rs", "train_resnet_zero")
    want = ({"reduce_scatter_grad": RESNET_STEPS,
             "allgather_flat": RESNET_STEPS} if sharded
            else {"allreduce_grad": RESNET_STEPS})
    if not all(np.isfinite(losses)) or len(losses) != RESNET_STEPS:
        fail(f"{phase} losses {losses}")
    if launches != expected_launches():
        fail(f"{phase} launched flash kernels: {launches}")
    if calls != want:
        fail(f"{phase}: expected the collectives {want}, got {calls}")
    if dist.is_initialized():
        fail(f"the process group outlived {phase}")
    return row


def resnet_parity_run(device, data_parallel, comm=None, steps=3,
                      **exchange):
    """RESNET_PARITY's model for ``steps`` MomentumSGD steps on
    ``device``, plain or through ``create_multi_node_optimizer(.., comm,
    **exchange)``: (losses, state on the host)."""
    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.models import Classifier, ResNet
    cfg = RESNET_PARITY
    model = Classifier(ResNet(cfg["blocks"], n_classes=cfg["n_classes"],
                              seed=0, layout="NHWC", device=device))
    opt = MomentumSGD(lr=cfg["lr"], momentum=0.9)
    if data_parallel:
        opt = create_multi_node_optimizer(opt, comm, **exchange)
    opt.setup(model)
    rng = np.random.RandomState(4)
    losses = []
    for _ in range(steps):
        x = rng.normal(0, 1, (cfg["batch"], cfg["size"], cfg["size"], 3))
        t = rng.randint(0, cfg["n_classes"], cfg["batch"])
        losses.append(opt.update(
            model, torch.from_numpy(x.astype(np.float32)).to(device),
            torch.from_numpy(t).to(device)).item())
    state = {p: v.detach().cpu() for p, v in model.namedparams()}
    state.update((p, v.cpu()) for p, v in model.namedpersistent())
    return losses, state


def phase_resnet_parity():
    """(a) a world-of-one DP step of the small fp32 ResNet is bitwise the
    single-card step (cudnn.deterministic on for it); (b) 3 DP steps on
    the card match 3 steps on the CPU within RESNET_PARITY_TOL.  TF32 is
    off for this phase and restored after it."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    comm = create_communicator("pure_nccl")
    try:
        torch.backends.cudnn.deterministic = True
        single = resnet_parity_run("cuda", False)
        dp = resnet_parity_run("cuda", True, comm)
        torch.backends.cudnn.deterministic = flags[2]
        a_equal = single[0] == dp[0] and all(
            torch.equal(v, single[1][p]) for p, v in dp[1].items())
        card = resnet_parity_run("cuda", True, comm)
        cpu = resnet_parity_run("cpu", False)
        calls = dict(comm.calls)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
        comm.finalize()
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
    state_err = max((card[1][p] - v).abs().max().item()
                    for p, v in cpu[1].items())
    row = {"phase": "resnet_parity", "a_bitwise_equal": a_equal,
           "losses": card[0], "cpu_losses": cpu[0],
           "b_loss_rel_err": loss_err, "b_state_abs_err": state_err,
           "tol": RESNET_PARITY_TOL, "collectives": calls,
           "tf32_restored": (torch.backends.cudnn.allow_tf32,
                             torch.backends.cuda.matmul.allow_tf32)}
    emit(row)
    if not (a_equal and loss_err < RESNET_PARITY_TOL["loss_rel"]
            and state_err < RESNET_PARITY_TOL["state_abs"]
            and sorted(card[1]) == sorted(cpu[1])):
        fail(f"the small ResNet on the card leaves its references: {row}")
    if dist.is_initialized():
        fail("the process group outlived the ResNet parity phase")


def phase_exchange_parity():
    """The small fp32 ResNet through each exchange: (a) on the card at a
    world of one, reduce-scatter and ZeRO bitwise the plain DP run, and
    the double-buffered run's parameters after step 2 bitwise the plain
    run's after step 1; (b) each exchange's 3 steps on the card against
    its 3 steps on the CPU (a gloo group beside the NCCL world), within
    RESNET_PARITY_TOL."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.communicators import MeshCommunicator
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    exchanges = {"plain": {}, "rs": dict(exchange="reduce_scatter"),
                 "zero": dict(zero_sharding=True),
                 "db": dict(double_buffering=True)}
    comm = create_communicator("pure_nccl")
    try:
        cpu_comm = MeshCommunicator(device="cpu",
                                    group=dist.new_group(backend="gloo"),
                                    name="pure_nccl")
        torch.backends.cudnn.deterministic = True
        det = {k: resnet_parity_run("cuda", True, comm, **kw)
               for k, kw in exchanges.items()}
        plain1 = resnet_parity_run("cuda", True, comm, steps=1)
        db2 = resnet_parity_run("cuda", True, comm, steps=2,
                                double_buffering=True)
        torch.backends.cudnn.deterministic = flags[2]
        card = {k: resnet_parity_run("cuda", True, comm, **kw)
                for k, kw in exchanges.items()}
        cpu = {k: resnet_parity_run("cpu", True, cpu_comm, **kw)
               for k, kw in exchanges.items()}
        calls = dict(comm.calls)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
        comm.finalize()

    def equal(a, b, params_only=False):
        keys = [p for p in b[1] if not params_only
                or not p.rsplit("/", 1)[1] in ("avg_mean", "avg_var", "N")]
        return all(torch.equal(a[1][p], b[1][p]) for p in keys)

    def max_diff(a, b):
        return max((a[1][p] - v).abs().max().item() for p, v in b[1].items()
                   if v.is_floating_point())

    a = {"rs_bitwise_plain": det["rs"][0] == det["plain"][0]
         and equal(det["rs"], det["plain"]),
         "zero_bitwise_plain": det["zero"][0] == det["plain"][0]
         and equal(det["zero"], det["plain"]),
         "db_step2_bitwise_plain_step1": equal(db2, plain1,
                                               params_only=True)}
    a_diff = {"rs": max_diff(det["rs"], det["plain"]),
              "zero": max_diff(det["zero"], det["plain"]),
              "db": max((db2[1][p] - v).abs().max().item()
                        for p, v in plain1[1].items()
                        if not p.rsplit("/", 1)[1] in (
                            "avg_mean", "avg_var", "N"))}
    b = {k: {"loss_rel_err": max(abs(x - y) / abs(y) for x, y in zip(
                 card[k][0], cpu[k][0])),
             "state_abs_err": max_diff(card[k], cpu[k]),
             "losses": card[k][0], "cpu_losses": cpu[k][0]}
         for k in exchanges}
    row = {"phase": "exchange_parity", "a": a, "a_max_abs_diff": a_diff,
           "b": b, "tol": RESNET_PARITY_TOL, "collectives": calls}
    emit(row)
    if not all(a.values()):
        fail(f"exchange parity (a), largest differences {a_diff}: the "
             f"exchanges differ from the plain step at a world of one")
    for k, errs in b.items():
        if not (errs["loss_rel_err"] < RESNET_PARITY_TOL["loss_rel"]
                and errs["state_abs_err"] < RESNET_PARITY_TOL["state_abs"]):
            fail(f"exchange parity (b): {k} on the card leaves the CPU's "
                 f"run: {errs}")
    if dist.is_initialized():
        fail("the process group outlived the exchange parity phase")


#: what the MNIST phases compare and print
MNIST_METRICS = ("main/loss", "main/accuracy", "validation/main/loss",
                 "validation/main/accuracy")


def mnist_trainer(out):
    """The single-process twin's trainer at its defaults (seeded
    shuffles) for 2 epochs, with a snapshot after epoch 1 too."""
    from chainermn_tpu_torch.examples import train_mnist
    from chainermn_tpu_torch.training import extensions
    args = train_mnist.parse_args(
        ["-e", "2", "-o", os.path.join("build", out), "--device", "cuda"])
    trainer = train_mnist.make_trainer(args, seed=0)
    trainer.extend(extensions.snapshot(), trigger=(1, "epoch"))
    return trainer


def phase_train_mnist():
    from chainermn_tpu_torch.serializers import load_npz
    reset_launches()
    trainer = mnist_trainer("chip_smoke_mnist")
    trainer.run()
    torch.cuda.synchronize()
    launches = read_launches()
    log = trainer.get_extension("LogReport").log
    per_epoch = trainer.updater.iteration // 2
    resumed = mnist_trainer("chip_smoke_mnist_resumed")
    load_npz(os.path.join(trainer.out, f"snapshot_iter_{per_epoch}"),
             resumed)
    resumed.run()
    rlog = resumed.get_extension("LogReport").log
    diffs = {k: abs(rlog[-1][k] - log[-1][k]) for k in MNIST_METRICS}
    epoch_s = [log[0]["elapsed_time"]] + [
        b["elapsed_time"] - a["elapsed_time"] for a, b in zip(log, log[1:])]
    emit({"phase": "train_mnist", "iterations": trainer.updater.iteration,
          "epoch_wall_s": epoch_s, "last_log": log[-1],
          "resumed_last_log": rlog[-1],
          "resume_bitwise": all(d == 0 for d in diffs.values()),
          "resume_max_abs_diff": max(diffs.values()),
          "launches": launches})
    if any(d != 0 for d in diffs.values()):
        print(f"train_mnist: the resumed epoch differs from the "
              f"uninterrupted one by up to {max(diffs.values())} {diffs}",
              flush=True)
    if not all(np.isfinite([e[k] for e in log + rlog
                            for k in MNIST_METRICS])):
        fail(f"train_mnist log {log} {rlog}")
    if launches != expected_launches():
        fail(f"train_mnist launched flash kernels: {launches}")
    if not (log[1]["validation/main/loss"] < log[0]["validation/main/loss"]
            and log[1]["validation/main/accuracy"]
            >= log[0]["validation/main/accuracy"]
            and log[1]["main/accuracy"] > log[0]["main/accuracy"]):
        fail(f"train_mnist did not learn: {log}")
    if max(diffs.values()) > 1e-6 or rlog[0] != log[0]:
        fail(f"train_mnist: the resumed run left the uninterrupted one: "
             f"{diffs}")


def phase_train_mnist_dp():
    import torch.distributed as dist
    from chainermn_tpu_torch.examples import train_mnist_dp
    from chainermn_tpu_torch.extensions import ObservationAggregator
    from chainermn_tpu_torch.training import PRIORITY_WRITER
    args = train_mnist_dp.parse_args(
        ["-e", "1", "-o", os.path.join("build", "chip_smoke_mnist_dp"),
         "--device", "cuda"])
    reset_launches()
    trainer, comm = train_mnist_dp.make_trainer(args, seed=0)
    try:
        # ahead of LogReport: the aggregator's own priority (EDITOR, as
        # in the JAX package) runs it after LogReport, a WRITER there
        trainer.extend(ObservationAggregator(comm, "main/loss",
                                             "main/loss_aggregated"),
                       priority=PRIORITY_WRITER + 1)
        t0 = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        calls = dict(comm.calls)
        world, backend = comm.size, dist.get_backend()
    finally:
        comm.finalize()
    log = trainer.get_extension("LogReport").log
    emit({"phase": "train_mnist_dp", "world": world, "backend": backend,
          "iterations": trainer.updater.iteration, "wall_s": wall,
          "last_log": log[-1], "collectives": calls, "launches": launches})
    keys = MNIST_METRICS + ("main/loss_aggregated",)
    if not all(np.isfinite([log[-1][k] for k in keys])):
        fail(f"train_mnist_dp log {log}")
    if abs(log[-1]["main/loss_aggregated"] - log[-1]["main/loss"]) > 1e-6:
        fail(f"train_mnist_dp: the aggregated loss is not the loss at a "
             f"world of one: {log[-1]}")
    if launches != expected_launches():
        fail(f"train_mnist_dp launched flash kernels: {launches}")
    if dist.is_initialized():
        fail("the process group outlived the MNIST data-parallel phase")


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
    sass = sass_counts(library_path())
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": ptxas_report(build_log()),
          "sass": sass})
    plain = [name for name, n in sass.items()
             if not (n["HGMMA"] and n["UTMALDG"])]
    missing = [k for k in SM90_KERNELS
               if not any(n.startswith(k) for n in sass)]
    if plain or missing:
        fail(f"bf16 Hopper instantiations without wgmma or TMA: "
             f"{plain or sass}; kernels not found: {missing}")

    checks, times = phase_kernel()
    model = TransformerLM(compute_dtype=torch.bfloat16, device="cuda",
                          **MODEL)
    launches = phase_serving(model)
    phase_decode_parity(model)
    del model
    torch.cuda.empty_cache()
    train_times = phase_kernel_train()
    split_times = phase_kernel_split()
    train_launches, _ = phase_train()
    dp_launches, _ = phase_train_dp()
    phase_train_parity()
    phase_train_dp_parity()
    torch.cuda.empty_cache()
    resnet_row = phase_train_resnet()
    for i, phase in enumerate(RESNET_EXCHANGE_ORDER):
        torch.cuda.empty_cache()
        phase_train_resnet_exchange(
            phase, resnet_row, 1 + RESNET_EXCHANGE_ORDER[:i].count(phase))
    torch.cuda.empty_cache()
    phase_resnet_parity()
    phase_exchange_parity()
    phase_train_mnist()
    phase_train_mnist_dp()

    main_check = next(c for c in checks
                      if c["B"] == 1 and c["T"] == 1024 and c["causal"])
    main_time = next(t for t in times if t["T"] == 1024)
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms", "device_ms", "library_device_ms",
              "call_device_ms", "host_us")
    emit({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "chainermn_tpu_torch/csrc/flash_fwd_sm90.cu",
        "replaces": "chainermn_tpu/ops/flash_attention.py:322",
        "launches": launches,
        "max_abs_err": main_check["max_abs_err"],
        **{f: main_time[f] for f in fields[1:]},
    }] + [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": train_launches[key],
        **{f: train_times[key][f] for f in fields},
    } for name, key, source, replaces in [
        ("flash_attention_fwd_lse", "fwd_lse",
         "chainermn_tpu_torch/csrc/flash_fwd_sm90.cu",
         "chainermn_tpu/ops/flash_attention.py:92"),
        ("flash_attention_bwd", "bwd",
         "chainermn_tpu_torch/csrc/flash_bwd_sm90.cu",
         "chainermn_tpu/ops/flash_attention.py:239")]] + [{
        "name": f"flash_attention_bwd_{part}", "route": "cuda",
        "source": source, "replaces": replaces,
        "launches": dp_launches[f"bwd_{part}"],
        **{f: split_times[part][f] for f in fields},
    } for part, source, replaces in [
        ("dq", "chainermn_tpu_torch/csrc/flash_bwd_dq_sm90.cu",
         "chainermn_tpu/ops/flash_attention.py:146"),
        ("dkv", "chainermn_tpu_torch/csrc/flash_bwd_sm90.cu",
         "chainermn_tpu/ops/flash_attention.py:187")]]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
