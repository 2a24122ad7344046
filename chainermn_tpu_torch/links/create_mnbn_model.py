"""BatchNormalization -> MultiNodeBatchNormalization rewrite.

Reference: ``chainermn/links/create_mnbn_model.py · create_mnbn_model``;
the port of ``chainermn_tpu.links.create_mnbn_model``: a copy of a model
with every ``BatchNormalization`` replaced by the multi-node one, so that
single-device model code gains global-batch statistics unchanged.
"""

from __future__ import annotations

import copy

from ..nn.links import BatchNormalization
from .batch_normalization import MultiNodeBatchNormalization

__all__ = ["create_mnbn_model"]


def create_mnbn_model(link, comm):
    """A deep copy of ``link`` with every BN replaced by sync BN; each
    keeps its ``gamma``, ``beta``, running statistics, ``N``, ``decay``,
    ``eps`` and ``axis``."""
    model = copy.deepcopy(link)
    _replace(model, comm)
    return model


def _replace(link, comm):
    for name, child in list(link._modules.items()):
        if isinstance(child, BatchNormalization) \
                and not isinstance(child, MultiNodeBatchNormalization):
            mnbn = MultiNodeBatchNormalization(
                child.size, comm, decay=child.decay, eps=child.eps,
                use_gamma=child.use_gamma, use_beta=child.use_beta,
                axis=child.axis, device=child.avg_mean.device)
            mnbn.load_state_dict(child.state_dict())
            link._modules[name] = mnbn
        elif child is not None:
            _replace(child, comm)
