#!/usr/bin/env python3
"""The benchmark of ``chainermn_tpu_torch``: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout on a machine with the cell's cards.  The
cell (``BENCHMARK.json``) names a configuration and a traffic mix; a cell
on several cards starts one process per card itself (``torchrun``'s
environment on 127.0.0.1, a free port), and this process prints the job's
result.  ``--trace 1`` sets ``CHAINERMN_TPU_TRACE=full`` before the port
is imported and profiles the measured window.

Standard output ends with one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each compared number beside its
limit, which are also the last lines of standard error.  Without the
cards the cell asks for, or with a module of JAX or of the JAX package
loaded, it exits with 2 and prints no result.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level module names no process of a run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "chainermn_tpu")

#: a worker's whole run, set-up and check included (the first run of a
#: checkout builds the kernels)
WORKER_TIMEOUT_S = 1100


def set_environment(trace):
    """Caches at fixed paths inside the checkout, the port's trace mode,
    the launch queues' depth, and no JAX behind a library's back; before
    torch or the port is imported."""
    cache = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda_cache")
    os.environ["CHAINERMN_TPU_TRACE"] = "full" if trace else "off"
    # four times the CUDA driver's launch queues, so that the host runs
    # further ahead of the card and a short stall of the host (a garbage
    # collection, a shared core) does not leave the card idle
    os.environ["CUDA_SCALE_LAUNCH_QUEUES"] = "4x"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def own_cores(rank, world):
    """Give this rank its own block of the host's cores, and as many
    intra-op threads at most (before torch is imported): the job's ranks
    share one host, whose every core each default thread pool would
    take."""
    cores = sorted(os.sched_getaffinity(0))
    per = max(1, len(cores) // world)
    mine = cores[rank * per:(rank + 1) * per] or cores
    os.sched_setaffinity(0, mine)
    cap = int(os.environ.get("OMP_NUM_THREADS", len(mine)))
    os.environ["OMP_NUM_THREADS"] = str(min(len(mine), cap))


def forbidden_modules():
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cell_from(job):
    from portbench.cell import Cell
    return Cell(**job["cell"])


def cell_json(cell):
    return {"name": cell.name, "chips": cell.chips, "config": cell.config,
            "traffic": cell.traffic, "limits": cell.limits,
            "end_to_end": cell.end_to_end, "per_layer": cell.per_layer}


def worker():
    """One rank of a several-card job: the job on standard input, the
    rank in ``RANK``; its record is the last line of standard output.  A
    job with ``seeds`` is a calibration (``calibrate.py``)."""
    job = json.loads(sys.stdin.read())
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    own_cores(rank, world)
    set_environment(job.get("trace", False))
    from portbench import harness
    cell = _cell_from(job)
    if "seeds" in job:
        record = harness.calibrate_rank(cell, job["seeds"], job["device"],
                                        rank, world, job["mode"])
    else:
        record = harness.run_rank(cell, job["seed"], job["seconds"],
                                  job["trace"], job["device"], rank, world,
                                  fault=job["fault"])
    found = forbidden_modules()
    if found:
        print(f"rank {rank} loaded {found}", file=sys.stderr)
        sys.exit(2)
    print(json.dumps(record))


def launch(cell, job):
    """Start one worker per card on ``job``, wait for all, and return
    their records in rank order; a worker that fails ends the others."""
    port = _free_port()
    job = json.dumps({"cell": cell_json(cell), **job})
    procs = []
    for rank in range(cell.chips):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(cell.chips), LOCAL_WORLD_SIZE=str(
                       cell.chips), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env,
            cwd=str(ROOT), text=True))
    outs = [None] * len(procs)

    def talk(i):
        outs[i], _ = procs[i].communicate(job, timeout=WORKER_TIMEOUT_S)

    threads = [threading.Thread(target=talk, args=(i,)) for i in
               range(len(procs))]
    for t in threads:
        t.start()
    try:
        while any(t.is_alive() for t in threads):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        failed = [i for i, p in enumerate(procs) if p.poll() not in (None, 0)]
        if failed:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for t in threads:
            t.join(timeout=30)
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"workers exited with {codes}")
    return [json.loads(out.strip().splitlines()[-1]) for out in outs]


def run(cell, seed, seconds, trace, device="cuda", fault=None):
    """The job's records, in this process for one card, else from one
    worker per card."""
    if cell.chips == 1:
        from portbench.harness import run_rank
        return [run_rank(cell, seed, seconds, trace, device, 0, 1,
                         fault=fault)]
    return launch(cell, {"seed": seed, "seconds": seconds, "trace": trace,
                         "device": device, "fault": fault})


def _json_number(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def assemble(cell, records, trace, t_start, device_kind):
    """The result line from the ranks' records."""
    from portbench.cell import load_metric
    from portbench.readers import Context
    r0 = records[0]
    ctxs = [Context(cell, r, len(records), t_start) for r in records]
    metrics = {}
    for name, unit in (cell.per_layer if trace else cell.end_to_end):
        read = load_metric(name)
        # per-layer readings are each card's, averaged over the cards;
        # end-to-end ones are the job's, read on rank 0
        values = [read(c) for c in (ctxs if trace else ctxs[:1])]
        values = [v for v in values if v is not None]
        if values:
            metrics[name] = {"value": statistics.fmean(values),
                             "unit": unit}
    failed = sum(r["failed"] for r in records)
    device = {"platform": "gpu" if device_kind != "cpu" else "cpu",
              "kind": device_kind, "count": len(records),
              "memory_peak_bytes": max(r["peak_bytes"] for r in records)}
    result = {"correct": bool(r0["correct"]) and failed == 0,
              "attempted": r0["steps"], "failed": failed,
              "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = statistics.fmean(r["trace"]["busy_s"]
                                            for r in records)
        device["window_s"] = r0["trace"]["window_s"]
        result["breakdown"] = r0["trace"]["breakdown"]
    result["check"] = {k: {"value": _json_number(v["value"]),
                           "limit": v["limit"]}
                       for k, v in r0["check"].items()}
    return result


def details(records):
    """The earlier line: what each rank measured besides the metrics."""
    keep = ("rank", "steps", "window_s", "host_busy", "warm_step_ms",
            "peak_bytes",
            "launches", "failed", "check_s", "setup_parts_s")
    out = {"ranks": [{k: r.get(k) for k in keep} for r in records]}
    r0 = records[0]
    out["step_ms"] = r0["step_ms"]
    out["host_lead_ms"] = r0.get("host_lead_ms")
    out["numbers"] = r0.get("numbers")
    out["readings"] = r0.get("readings")
    if r0.get("trace"):
        out["trace_ops"] = sorted(
            ([n[:120], c, s] for n, (c, s) in r0["trace"]["ops"].items()),
            key=lambda row: -row[2])[:40]
    return out


def card_line():
    """The card's name, power limit and clocks (``nvidia-smi``), or None
    where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines() if out.returncode == 0 else None


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload")
    parser.add_argument("--seed", type=int)
    parser.add_argument("--seconds", type=float)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--worker", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        worker()
        return 0
    if args.workload is None or args.seed is None or args.seconds is None:
        parser.error("--workload, --seed and --seconds are required")
    set_environment(args.trace)
    from portbench.cell import load
    cell = load(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"machine has {n}", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    records = run(cell, args.seed, args.seconds, bool(args.trace))
    result = assemble(cell, records, bool(args.trace), T_START, kind)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}", file=sys.stderr)
        return 2
    print(json.dumps({"workload": cell.name, "seed": args.seed,
                      "device": kind, "count": torch.cuda.device_count(),
                      "nvidia_smi": card_line(), **details(records)}))
    for name, row in result["check"].items():
        print(f"check {name} {row['value']} limit {row['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
