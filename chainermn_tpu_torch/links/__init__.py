"""Distributed model components (reference: ``chainermn.links``): the
multi-node (sync) batch normalization and the rewrite that puts it into
a model, the model-parallel ``MultiNodeChainList`` and the
channel-parallel ``ParallelConvolution2D``."""

from .batch_normalization import MultiNodeBatchNormalization
from .create_mnbn_model import create_mnbn_model
from .multi_node_chain_list import MultiNodeChainList
from .parallel_convolution import ParallelConvolution2D

__all__ = ["MultiNodeChainList", "MultiNodeBatchNormalization",
           "create_mnbn_model", "ParallelConvolution2D"]
