"""The comparison that decides ``correct``.

The program's readings and the reference's, each ``{"loss": [per step],
"grad1": {leaf: norm}, "change": {leaf: norm}}``, give these numbers:

* ``loss``: the largest gap of a step's loss from the reference's,
  relative to the reference's;
* ``grad``: over the leaves, the largest gap between the norms of the
  first step's gradient as the optimizer got it, each relative to the
  larger of the reference's norm of that leaf and of the median leaf;
  ``grad_median``: the median leaf's gap, so measured;
* ``change`` and ``change_median``: the same for the change of the
  parameters after the followed steps, over the leaves whose first
  reference gradient is at least a thousandth of the median leaf's (a
  leaf with none moves under Adam by rounding alone).

A number that is not finite reads infinite.  The numbers a cell's
``limits/<workload>.json`` names are held to their limits, and the cell
is correct when none exceeds its limit; the others are readings.
"""

from __future__ import annotations

import math
import statistics

__all__ = ["numbers", "judge"]

#: a leaf whose first reference gradient is below this share of the
#: median leaf's is left out of ``change``
NOUGHT = 1e-3


def _finite(x):
    return isinstance(x, (int, float)) and math.isfinite(x)


def _leaf_gaps(got, ref, leaves):
    """Each leaf's gap relative to the larger of its reference norm and
    the median leaf's; None when a reading is missing or not finite."""
    if not leaves or any(k not in got for k in leaves):
        return None
    med = statistics.median(ref[k] for k in leaves)
    gaps = []
    for k in leaves:
        base = max(ref[k], med)
        if not (_finite(got[k]) and _finite(ref[k])) or base <= 0:
            return None
        gaps.append(abs(got[k] - ref[k]) / base)
    return gaps


def numbers(got, ref):
    """``{name: value}`` of every number the check reads."""
    if len(got["loss"]) != len(ref["loss"]) or not all(
            _finite(a) and _finite(b) and b != 0
            for a, b in zip(got["loss"], ref["loss"])):
        loss = math.inf
    else:
        loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                       ref["loss"]))
    g1 = ref["grad1"]
    med = statistics.median(g1.values()) if g1 else 0.0
    moving = sorted(k for k, v in g1.items() if v >= NOUGHT * med)
    out = {"loss": loss}
    for name, gaps in (("grad", _leaf_gaps(got["grad1"], g1, sorted(g1))),
                       ("change", _leaf_gaps(got["change"], ref["change"],
                                             moving))):
        out[name] = math.inf if gaps is None else max(gaps)
        out[f"{name}_median"] = (math.inf if gaps is None
                                 else statistics.median(gaps))
    return out


def judge(values, limits):
    """``(correct, {name: {"value", "limit"}})`` over the numbers that
    ``limits`` names."""
    table = {k: {"value": values[k], "limit": limit}
             for k, limit in limits.items()}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
