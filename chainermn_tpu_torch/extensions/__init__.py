"""Distributed trainer extensions (reference: ``chainermn.extensions``).
The multi-node checkpointer (ROADMAP A8), failure recovery and the
elastic extensions (A11) are not ported yet."""

from .observation_aggregator import ObservationAggregator

__all__ = ["ObservationAggregator"]
