"""Distributed trainer extensions (reference: ``chainermn.extensions``):
the multi-node checkpointer with consensus resume, its per-rank DCP
sibling (the JAX package's Orbax names), the observation aggregator, and
the resilience supervisors: :class:`FailureRecovery` (in-place recovery
under ``Trainer.run``) and :class:`ElasticRecovery` (shrink and grow over
the membership protocol)."""

from .checkpoint import _MultiNodeCheckpointer, create_multi_node_checkpointer
from .elastic import (ElasticConfigError, ElasticRecovery,
                      create_elastic_membership, global_batch_plan)
from .failure_recovery import FailureRecovery, RecoveryGivingUp
from .observation_aggregator import ObservationAggregator
from .orbax_checkpoint import (OrbaxCheckpointer, _MultiNodeOrbaxCheckpointer,
                               create_multi_node_orbax_checkpointer)

__all__ = ["create_multi_node_checkpointer", "_MultiNodeCheckpointer",
           "ObservationAggregator", "OrbaxCheckpointer",
           "create_multi_node_orbax_checkpointer",
           "_MultiNodeOrbaxCheckpointer", "FailureRecovery",
           "RecoveryGivingUp", "ElasticRecovery", "ElasticConfigError",
           "create_elastic_membership", "global_batch_plan"]
