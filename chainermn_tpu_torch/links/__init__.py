"""Distributed model components (reference: ``chainermn.links``).

Ported: the multi-node (sync) batch normalization and the rewrite that
puts it into a model.  ``MultiNodeChainList`` and
``ParallelConvolution2D`` wait for ROADMAP A7.
"""

from .batch_normalization import MultiNodeBatchNormalization
from .create_mnbn_model import create_mnbn_model

__all__ = ["MultiNodeBatchNormalization", "create_mnbn_model"]
