"""Distributed trainer extensions (reference: ``chainermn.extensions``):
the multi-node checkpointer with consensus resume, its per-rank DCP
sibling (the JAX package's Orbax names) and the observation aggregator.
Failure recovery and the elastic extensions (ROADMAP A11) are not ported
yet."""

from .checkpoint import _MultiNodeCheckpointer, create_multi_node_checkpointer
from .observation_aggregator import ObservationAggregator
from .orbax_checkpoint import (OrbaxCheckpointer, _MultiNodeOrbaxCheckpointer,
                               create_multi_node_orbax_checkpointer)

__all__ = ["create_multi_node_checkpointer", "_MultiNodeCheckpointer",
           "ObservationAggregator", "OrbaxCheckpointer",
           "create_multi_node_orbax_checkpointer",
           "_MultiNodeOrbaxCheckpointer"]
