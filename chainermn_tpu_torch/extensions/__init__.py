"""Distributed trainer extensions (reference: ``chainermn.extensions``).
The checkpointer, failure recovery and the elastic extensions are not
ported yet (ROADMAP A12, A11)."""

from .observation_aggregator import ObservationAggregator

__all__ = ["ObservationAggregator"]
