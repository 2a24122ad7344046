"""One rank's run of a training cell.

Set-up builds the step ChainerMN's users run -- ``create_communicator``,
the configuration's model with the seed's weights, ``bcast_data``,
``create_multi_node_optimizer``, ``scatter_dataset``, a ``SerialIterator``
under the ``DevicePrefetchIterator`` and a ``StandardUpdater`` driven in
the ``Trainer``'s reporter scope -- and drives it from the seed through
the check's first steps (read on rank 0) and a few steps more, which time
the window.  The window then runs the same call for a step count every
rank agrees on, a CUDA event after each step.  After it: the peak memory,
the trace (``--trace 1``), the program's state freed, and on rank 0 the
reference's steps and the comparison.
"""

from __future__ import annotations

import contextlib
import importlib
import statistics
import time

import numpy as np
import torch

from . import check, data, weights
from .cell import ROOT
from .reference import optim as ref_optim
from .reference import norms, train_readings

__all__ = ["run_rank"]

#: steps after the checked ones whose median times the window
TIMING_STEPS = 3

#: the flash kernels' launch counters (``ops.flash_attention``), by the
#: short names the metrics read
LAUNCH_COUNTERS = {"fwd": "flash_attention", "fwd_lse": "flash_attention_fwd",
                   "bwd": "flash_attention_bwd",
                   "bwd_delta": "flash_attention_bwd_delta",
                   "bwd_dq": "flash_attention_bwd_dq",
                   "bwd_dkv": "flash_attention_bwd_dkv"}


def _launches():
    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    return {k: getattr(fa, fn).launches for k, fn in LAUNCH_COUNTERS.items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Clock:
    """Step ends on the device: CUDA events, or on the CPU the host clock
    after each step (the CPU runs the step before returning)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self.host = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())
        self.host.append(time.perf_counter())

    def step_ms(self):
        """The times between consecutive marks."""
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks,
                                                      self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]

    def host_lead_ms(self):
        """For each mark after the first, how far the host had run ahead
        of the device when it enqueued it (ms): the device's time from the
        first mark, which an idle device ran at once, less the host's.
        Near 0 where the host holds the device back; None off CUDA."""
        if not self.cuda:
            return None
        h0 = self.host[0]
        return [self.marks[0].elapsed_time(ev) - (h - h0) * 1e3
                for ev, h in zip(self.marks[1:], self.host[1:])]


def _program_optimizer(spec):
    from chainermn_tpu_torch.core import optimizer as opt
    return getattr(opt, spec["name"])(
        **{k: v for k, v in spec.items() if k != "name"})


def _span_durations(names):
    """The durations (s) of each closed span of the port's tracer whose
    name is in ``names``, by name."""
    from chainermn_tpu_torch import observability
    out = {n: [] for n in names}
    opened = {}
    for ev in observability.tracer().events():
        key = (ev["name"], ev["tid"])
        if ev["name"] not in out:
            continue
        if ev["ph"] == "B":
            opened.setdefault(key, []).append(ev["ts"])
        elif ev["ph"] == "E" and opened.get(key):
            out[ev["name"]].append((ev["ts"] - opened[key].pop()) * 1e-6)
    return out


#: the port's spans that metrics read
SPANS = ("train/input_stall",)


def communicator(cell, device, rank, world):
    """The configuration's communicator over this rank's card, and the
    card."""
    import chainermn_tpu_torch as cmn
    cfg = cell.config
    comm = cmn.create_communicator(cfg["communicator"], device=device,
                                   allreduce_grad_dtype=cfg["wire_dtype"])
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    if comm.size != world or comm.rank != rank:
        raise RuntimeError(f"the communicator is rank {comm.rank} of "
                           f"{comm.size}, the launcher's {rank} of {world}")
    return comm, dev


class Job:
    """The training step of one seed, as ChainerMN's users build it, and
    the check's readings of its first steps."""

    def __init__(self, cell, seed, comm, dev, fault=None):
        import chainermn_tpu_torch as cmn
        from chainermn_tpu_torch.dataset import (DevicePrefetchIterator,
                                                SerialIterator,
                                                TupleDataset,
                                                concat_examples,
                                                identity_converter)
        from chainermn_tpu_torch.training import StandardUpdater, Trainer
        cfg, traffic = cell.config, cell.traffic
        self.cell, self.seed, self.comm, self.dev = cell, seed, comm, dev
        self.family = fam = cell.family
        self.specs = fam.param_specs(cfg)
        self.model = fam.build_model(cfg, dev)
        weights.load_into(self.model, weights.draw(self.specs, seed, dev))
        comm.bcast_data(self.model)
        self.opt = cmn.create_multi_node_optimizer(
            _program_optimizer(cfg["optimizer"]), comm).setup(self.model)
        self.examples = data.make(cfg, traffic, seed, dev)
        shard = cmn.scatter_dataset(TupleDataset(*self.examples), comm)
        self.iterator = DevicePrefetchIterator(
            SerialIterator(shard, traffic["batch_per_rank"], shuffle=False),
            size=traffic["prefetch"], device=dev, converter=concat_examples)
        self.updater = StandardUpdater(self.iterator, self.opt,
                                       converter=identity_converter)
        self.trainer = Trainer(self.updater,
                               out=str(ROOT / "build" / "portbench" / "out"))
        if fault is not None:
            from . import faults
            faults.plant(fault, model=self.model, opt=self.opt, comm=comm)

    def step(self):
        """One ``updater.update()`` in the trainer's reporter scope; the
        step's mean loss over the ranks (a device tensor)."""
        obs = {}
        with self.trainer.reporter.scope(obs):
            self.updater.update()
        return obs["main/loss"]

    def check_steps(self):
        """The check's first steps, through the window's own call and
        feed; on rank 0 their readings: each loss, the first gradient as
        the optimizer got it (from its state after one step), and the
        change of the parameters after the last."""
        n = self.cell.traffic["check_steps"]
        rank0 = self.comm.rank == 0
        losses, grad1 = [], None
        for i in range(n):
            losses.append(self.step())
            if i == 0 and rank0:
                grad1 = norms({p: self.family.first_gradient(self.opt, p)
                                for p, _ in self.model.namedparams()})
        if not rank0:
            return None
        w0 = weights.draw(self.specs, self.seed, self.dev)
        change = norms({p: v.detach() - w0[p]
                         for p, v in self.model.namedparams()})
        return {"loss": [float(x) for x in losses], "grad1": grad1,
                "change": change}

    def close(self):
        """Stop the feed and drop the program's state."""
        self.iterator.finalize()
        del self.trainer, self.updater, self.iterator, self.opt, self.model
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def run_rank(cell, seed, seconds, trace, device, rank, world, fault=None):
    """Set-up, window and (rank 0) check of one rank; returns its record.
    ``fault`` (tests only) breaks the timed path underneath: see
    ``faults.py``."""
    from chainermn_tpu_torch import observability
    marks = [("start", time.time())]
    comm, dev = communicator(cell, device, rank, world)
    marks.append(("communicator", time.time()))
    job = Job(cell, seed, comm, dev, fault)
    marks.append(("build", time.time()))
    step = job.step
    got = job.check_steps()
    marks.append(("check_steps", time.time()))

    # a few more steps time the window; every rank takes rank 0's count
    clock = _Clock(dev)
    _sync(dev)
    clock.mark()
    for _ in range(TIMING_STEPS):
        step()
        clock.mark()
    _sync(dev)
    warm_ms = statistics.median(clock.step_ms())
    n_steps = comm.bcast_obj(max(3, round(seconds * 1e3 / warm_ms)))
    marks.append(("timing_steps", time.time()))

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
        observability.tracer().clear()
    launches0 = _launches()
    if world > 1:
        torch.distributed.barrier()
    _sync(dev)
    clock = _Clock(dev)
    window_losses = []
    t_start_wall = time.time()
    t0 = time.perf_counter()
    cpu0 = time.thread_time()
    clock.mark()
    with (torch.profiler.record_function("portbench.window") if trace
          else contextlib.nullcontext()):
        for _ in range(n_steps):
            with (torch.profiler.record_function("portbench.step") if trace
                  else contextlib.nullcontext()):
                window_losses.append(step())
            clock.mark()
        _sync(dev)
    window_s = time.perf_counter() - t0
    # the share of the window in which this thread ran on a core
    host_busy = (time.thread_time() - cpu0) / window_s
    launches = {k: v - launches0[k] for k, v in _launches().items()}
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        from . import trace as trace_reduce
        summary = trace_reduce.reduce(prof)
        del prof
    spans = _span_durations(SPANS) if trace else {}
    step_ms = clock.step_ms()
    lead = clock.host_lead_ms()
    failed = sum(not np.isfinite(float(x)) for x in window_losses)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    # the program's state goes before the reference runs
    examples = job.examples
    job.close()
    del job, window_losses
    comm.finalize()

    # seconds each part of the set-up took, from this function's start
    setup = {name: t - prev for (_, prev), (name, t) in zip(marks,
                                                             marks[1:])}
    record = {"rank": rank, "steps": n_steps, "window_s": window_s,
              "setup_parts_s": setup,
              "window_start": t_start_wall, "warm_step_ms": warm_ms,
              "step_ms": step_ms, "host_lead_ms": lead,
              "host_busy": host_busy,
              "failed": failed, "peak_bytes": peak,
              "launches": launches, "trace": summary,
              "spans": spans}
    if rank == 0:
        t_check = time.perf_counter()
        record.update(compare(cell, seed, examples, dev, got))
        record["check_s"] = time.perf_counter() - t_check
    return record


def compare(cell, seed, examples, dev, got):
    """The reference's readings beside ``got``, the numbers and the
    verdict."""
    ref = reference_readings(cell, seed, examples, dev)
    values = check.numbers(got, ref)
    correct, table = check.judge(values, cell.limits)
    return {"correct": correct, "check": table, "numbers": values,
            "readings": {"program": got, "reference": ref}}


def calibrate_rank(cell, seeds, device, rank, world, mode="program"):
    """The check's numbers on each of ``seeds``, for the limits: the
    program's (``mode="program"``, or a fault of ``faults.FAULTS``
    planted in it; one communicator for every seed), or the plain
    reference's put in the program's place and computed in a lower
    precision (``mode`` a precision of ``reference.quant``: the control),
    on rank 0 alone.  Returns rank 0's rows."""
    from . import faults
    rows = []
    if mode == "program" or mode in faults.FAULTS:
        fault = None if mode == "program" else mode
        comm, dev = communicator(cell, device, rank, world)
        for seed in seeds:
            job = Job(cell, seed, comm, dev, fault)
            got = job.check_steps()
            examples = job.examples
            job.close()
            del job
            if rank == 0:
                rows.append({"seed": seed, **compare(cell, seed, examples,
                                                     dev, got)})
            if world > 1:
                torch.distributed.barrier()
        comm.finalize()
        return rows
    dev = torch.device(device)
    for seed in seeds:
        examples = data.make(cell.config, cell.traffic, seed, dev)
        got = reference_readings(cell, seed, examples, dev, precision=mode)
        rows.append({"seed": seed, **compare(cell, seed, examples, dev,
                                             got)})
    return rows


def reference_readings(cell, seed, examples, dev, precision="float32"):
    """The plain reference's readings of the check's steps from the
    seed's weights and batches, TF32 off; a ``precision`` below the
    configuration's makes the control, the reference in the program's
    place."""
    cfg, traffic, fam = cell.config, cell.traffic, cell.family
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        w0 = weights.draw(fam.param_specs(cfg), seed, dev)
        n = traffic["check_steps"]
        batches = [[data.rank_batch(examples, traffic, r, i, dev)
                    for r in range(traffic["ranks"])] for i in range(n)]
        return train_readings(fam.reference.loss_and_grads(cfg, precision),
                              w0, batches, ref_optim.make(cfg["optimizer"]),
                              steps=n)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
