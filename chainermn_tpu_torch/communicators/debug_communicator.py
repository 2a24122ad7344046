"""Debug communicator: cross-rank signature checking.

The port of ``chainermn_tpu.communicators.debug_communicator``.  The
reference's worst failure mode is rank divergence: ranks that enter a
collective with different shapes or different gradient sets deadlock or
exchange garbage.  This communicator agrees on a signature (shapes and
dtypes) over the object channel before the exchange and fails fast with a
readable diff instead, at one small allgather per new signature (cached
afterwards): the multi-node optimizer checks each step's batch, and
:meth:`DebugCommunicator.multi_node_mean_grad` the gradient leaves it is
about to reduce.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .mesh_communicator import MeshCommunicator

__all__ = ["DebugCommunicator", "SignatureMismatchError"]


class SignatureMismatchError(RuntimeError):
    pass


def _signature(tree, prefix=""):
    """Shapes and dtypes of the tensors in ``tree`` (dicts, lists and
    tuples of tensors or arrays), with the dict keys on their path."""
    if isinstance(tree, dict):
        return ";".join(_signature(tree[key], f"{prefix}{key}/")
                        for key in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return ";".join(_signature(x, prefix) for x in tree)
    shape = tuple(tree.shape) if isinstance(tree, torch.Tensor) \
        else tuple(np.shape(tree))
    return f"{prefix}{shape}:{getattr(tree, 'dtype', type(tree).__name__)}"


class DebugCommunicator(MeshCommunicator):
    def __init__(self, *args, **kwargs):
        kwargs.setdefault("name", "debug")
        super().__init__(*args, **kwargs)
        self._verified_signatures = set()
        self.signature_checks = 0

    def verify_step_signature(self, tree, what="train step"):
        """Raise if any rank would run this step with other shapes or
        dtypes.  Cached per signature: one object-channel round per new
        signature."""
        sig = _signature(tree)
        if sig in self._verified_signatures:
            return
        self.signature_checks += 1
        digest = hashlib.sha1(sig.encode()).hexdigest()[:16]
        gathered = self.allgather_obj((self.rank, digest, sig))
        if len({d for _, d, _ in gathered}) > 1:
            lines = [f"  rank {r}: {s}" for r, _, s in gathered]
            raise SignatureMismatchError(
                f"ranks disagree on the {what} signature; the collectives "
                f"would deadlock (reference failure mode: rank "
                f"divergence).  Per-rank signatures:\n" + "\n".join(lines))
        self._verified_signatures.add(sig)

    def multi_node_mean_grad(self, model, zero_fill=False, residual=None):
        # the leaves the exchange will reduce (a gradient has its
        # parameter's shape and dtype)
        self.verify_step_signature(
            {path: p for path, p in model.namedparams()
             if p.grad is not None or zero_fill},
            what="gradient exchange")
        return super().multi_node_mean_grad(model, zero_fill=zero_fill,
                                            residual=residual)
