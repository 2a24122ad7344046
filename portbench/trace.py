"""Reduction of a ``torch.profiler`` trace of the measured window.

From the profiler's raw events (``kineto_results.events()``, no event
tree is built): every device operation (kernels, copies, sets; not the
device lane's copies of the host's annotations) inside the
window's ``portbench.window`` annotation, the device's busy time (the
union of their intervals), the time by operation name, and each idle gap
of the device named by what the host was doing at its middle (the
innermost event open then on the window's thread or autograd's backward
thread: an annotation such as the port's ``train.input_stall``, an
``aten::`` operation or a CUDA runtime call).
"""

from __future__ import annotations

import heapq
import re
from collections import defaultdict

__all__ = ["reduce", "base_name", "WINDOW"]

#: the annotation the harness opens around the measured window
WINDOW = "portbench.window"
#: the host events of autograd's backward thread, which launches the
#: backward's kernels while the window's thread waits
_BACKWARD = "autograd::engine::evaluate_function"


def base_name(name):
    """A kernel's name without ``void``, template arguments and
    parameters: ``void ns::f<a, b>(args)`` -> ``ns::f``."""
    anon = "(anonymous namespace)"
    base = name.removeprefix("void ").replace(anon, "\0")
    return re.split(r"[<(]", base, maxsplit=1)[0].replace("\0", anon)


def _events(prof):
    """Device events, and the host events of the thread that opened the
    window's annotation and of autograd's backward thread, as
    ``(start_ns, end_ns, name)``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.end_ns()
        if end < start:
            continue
        if e.device_type() == cuda:
            # the device lane's copies of host annotations are no work
            if not e.is_user_annotation():
                device.append((start, end, e.name()))
        else:
            host.append((start, end, e.name(), e.start_thread_id()))
    threads = {t for _, _, n, t in host
               if n == WINDOW or n.startswith(_BACKWARD)}
    return device, [(s, e, n) for s, e, n, t in host if t in threads]


def _innermost(host, points):
    """For each of the sorted ``points``, the name of the host event open
    there that started last ("idle" where none is)."""
    host = sorted(host)
    out, active, j = [], [], 0
    for p in points:
        while j < len(host) and host[j][0] <= p:
            s, e, name = host[j]
            heapq.heappush(active, (-s, e, name))
            j += 1
        # drop the closed ones that sit on top; an open one below a
        # closed one stays until it surfaces
        while active and active[0][1] < p:
            heapq.heappop(active)
        out.append(active[0][2] if active else "idle")
    return out


def reduce(prof, top=10):
    """The window's device summary: ``window_s``, ``busy_s``,
    ``ops`` (``{name: [count, seconds]}``), ``idle`` (``{what the host
    thread of the window was doing: seconds}``) and the ``breakdown``
    lists (at most ``top`` each)."""
    device, host = _events(prof)
    windows = [(s, e) for s, e, n in host if n == WINDOW]
    if not windows:
        raise RuntimeError(f"the trace has no {WINDOW!r} annotation")
    w0, w1 = windows[0]
    device = sorted((max(s, w0), min(e, w1), n) for s, e, n in device
                    if e > w0 and s < w1)
    ops = defaultdict(lambda: [0, 0.0])
    busy, gaps, end = 0, [], w0
    for s, e, name in device:
        ops[name][0] += 1
        ops[name][1] += (e - s) * 1e-9
        if s > end:
            gaps.append((end, s))
        if e > end:
            busy += e - max(s, end)
            end = e
    if w1 > end:
        gaps.append((end, w1))
    inside = [(s, e, n) for s, e, n in host
              if n != WINDOW and e > w0 and s < w1]
    mids = [(a + b) // 2 for a, b in gaps]
    order = sorted(range(len(mids)), key=mids.__getitem__)
    names = _innermost(inside, [mids[i] for i in order])
    idle = defaultdict(float)
    for i, name in zip(order, names):
        a, b = gaps[i]
        idle[name] += (b - a) * 1e-9
    by_time = sorted(ops.items(), key=lambda kv: -kv[1][1])
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy * 1e-9,
        "ops": {n: v for n, v in ops.items()},
        "idle": dict(idle),
        "breakdown": {
            "device_ops": [[n[:160], v[1]] for n, v in by_time[:top]],
            "idle_gaps": [[n[:160], s] for n, s in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]]}}
