"""Observation aggregation across ranks.

The port of ``chainermn_tpu.extensions.observation_aggregator``
(reference: ``chainermn/extensions/observation_aggregator.py ·
ObservationAggregator``): each iteration, one observation is replaced by
the aggregate (by default the mean) of every rank's value, so that the
logs on rank 0 speak for the whole job.  It is a collective: every rank
runs it.
"""

from __future__ import annotations

import numpy as np

from ..core.reporter import _to_host
from ..training.trainer import PRIORITY_EDITOR, Extension

__all__ = ["ObservationAggregator"]


class ObservationAggregator(Extension):
    trigger = (1, "iteration")
    priority = PRIORITY_EDITOR  # after writers, before readers (LogReport)

    def __init__(self, comm, original_key, aggregated_key=None,
                 aggregator=None):
        self.comm = comm
        self.original_key = original_key
        self.aggregated_key = aggregated_key or original_key
        self.aggregator = aggregator or (lambda xs: float(np.mean(xs)))

    def __call__(self, trainer):
        obs = trainer.observation
        if self.original_key not in obs:
            return
        value = float(_to_host(obs[self.original_key]))
        gathered = self.comm.allgather_obj(value)
        obs[self.aggregated_key] = self.aggregator(gathered)
