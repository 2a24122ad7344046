"""What a metric reader reads, and the arithmetic the readers share.

Each ``metrics/<name>.py`` defines ``read(ctx) -> float | None`` over a
:class:`Context`, one rank's view of the run.  A reader that finds nothing
to read returns None and the metric is left out of the line; a share of a
roofline or a peak is never 0 for want of a reading.
"""

from __future__ import annotations

import re

from . import flops
from .trace import base_name

__all__ = ["Context", "mfu", "idle_share", "class_ms", "roofline"]


class Context:
    """One rank's record of a run, with the cell it ran."""

    def __init__(self, cell, record, world, t_start):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.family = cell.family
        self.record = record
        self.world = world
        self.steps = record["steps"]
        self.window_s = record["window_s"]
        self.step_ms = record["step_ms"]
        self.setup_s = record["window_start"] - t_start
        self.trace = record.get("trace")
        self.spans = record.get("spans") or {}
        self.launches = record["launches"]
        #: the job's items (images, tokens) a step
        self.items_per_step = (cell.traffic["batch_per_rank"] * world
                               * self.family.items_per_example(
                                   cell.config, cell.traffic))

    @property
    def items_per_s(self):
        return self.items_per_step * self.steps / self.window_s


def mfu(ctx):
    """The window's model operations over the cards' bf16 peak, %."""
    per_item = ctx.family.train_flops_per_item(ctx.config, ctx.traffic)
    return (100.0 * ctx.items_per_s * per_item
            / (ctx.world * flops.PEAK_FLOPS_BF16))


def idle_share(ctx):
    """The share of the traced window in which no operation ran on the
    device, %."""
    if not ctx.trace:
        return None
    w = ctx.trace["window_s"]
    return 100.0 * (w - ctx.trace["busy_s"]) / w


def class_ms(ctx, patterns, exclude=None):
    """Device milliseconds a step of the operations whose name matches
    any of ``patterns`` and not ``exclude`` (case-insensitive); None when
    none ran."""
    if not ctx.trace:
        return None
    rx = re.compile("|".join(patterns), re.IGNORECASE)
    skip = re.compile(exclude, re.IGNORECASE) if exclude else None
    times = [s for n, (_, s) in ctx.trace["ops"].items()
             if rx.search(n) and not (skip and skip.search(n))]
    return 1e3 * sum(times) / ctx.steps if times else None


def roofline(ctx, counter, kernels, bound_s_per_call):
    """A kernel's share of its roofline, %: the least time one call could
    take over the device time of one call, which is the sum over
    ``kernels`` (base names, each launched once a call) of its mean time
    an event.  None when the launch counter ``counter`` saw no call in
    the window; an error when it saw calls and the trace holds none of
    one of the kernels."""
    if not ctx.trace or ctx.launches.get(counter, 0) == 0:
        return None
    per_call = 0.0
    for kernel in kernels:
        events = [(c, s) for n, (c, s) in ctx.trace["ops"].items()
                  if base_name(n) == kernel]
        count = sum(c for c, _ in events)
        if count == 0:
            raise RuntimeError(
                f"{ctx.launches[counter]} calls counted by {counter}, but "
                f"the trace holds no operation named {kernel}")
        per_call += sum(s for _, s in events) / count
    return 100.0 * bound_s_per_call / per_call
