"""Multi-node evaluator.

The port of ``chainermn_tpu.evaluators`` (reference: ``chainermn/
evaluators.py · create_multi_node_evaluator``): each rank evaluates its
own shard of the validation data, and the means every rank reports are
replaced by their mean over the ranks, weighted by the number of
examples each rank's means cover (``Evaluator._mn_counts``), so that a
ragged last batch counts by its size.  An evaluator without counts
weighs each rank 1 (the reference's plain average).
"""

from __future__ import annotations

import numpy as np

from .core.reporter import _to_host

__all__ = ["create_multi_node_evaluator"]


def create_multi_node_evaluator(actual_evaluator, communicator):
    """Wrap ``actual_evaluator.evaluate`` in place; returns the same
    evaluator (the reference's behavior).  ``evaluate`` is then a
    collective: every rank calls it."""
    actual_evaluator._mn_original_evaluate = actual_evaluator.evaluate
    actual_evaluator._mn_communicator = communicator

    def evaluate():
        local = actual_evaluator._mn_original_evaluate()
        counts = getattr(actual_evaluator, "_mn_counts", {})
        gathered = actual_evaluator._mn_communicator.allgather_obj(
            {k: (float(_to_host(v)), float(counts.get(k, 1.0)))
             for k, v in local.items()})
        keys = set()
        for d in gathered:
            keys.update(d)
        out = {}
        for k in keys:
            pairs = [d[k] for d in gathered if k in d]
            total = sum(n for _, n in pairs)
            out[k] = (sum(v * n for v, n in pairs) / total if total
                      else float(np.mean([v for v, _ in pairs])))
        return out

    actual_evaluator.evaluate = evaluate
    return actual_evaluator
