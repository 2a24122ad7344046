"""Communicator factory.

The port of ``chainermn_tpu.communicators.create_communicator``: a name
string maps to a communicator over a ``torch.distributed`` process group,
one process per device (NCCL on the card, gloo on the CPU).  Every name
of the JAX package (and of the reference) is accepted:

===================  ========================================================
name                 port realization
===================  ========================================================
``naive``            one allreduce per gradient leaf
``non_cuda_aware``   alias of ``naive``
``flat``             one flat-bucket allreduce of all gradients
``pure_nccl``        flat bucket, optional ``allreduce_grad_dtype`` (e.g.
                     bf16) on the wire; ``batch_collectives="bucketed"``
                     gives ``bucket_mb``-bounded buckets
``jax_ici``          the JAX package's canonical name (= ``pure_nccl``)
``single_node``      checks that every rank is on one host, else
                     ``pure_nccl``
``dummy``            no-op loopback
``debug``            cross-rank signature checks before each exchange
``hierarchical``,    raise ``NotImplementedError`` (two-level exchange,
``two_dimensional``  ROADMAP A10)
``fault``            raises ``NotImplementedError`` (fault injection, A11)
===================  ========================================================
"""

from __future__ import annotations

from ._communication_utility import init_ranks, initialize_distributed
from .communicator_base import CommunicatorBase
from .debug_communicator import DebugCommunicator, SignatureMismatchError
from .dummy_communicator import DummyCommunicator
from .mesh_communicator import ElasticMeshCommunicator, MeshCommunicator

__all__ = ["create_communicator", "CommunicatorBase", "MeshCommunicator",
           "ElasticMeshCommunicator", "DummyCommunicator",
           "DebugCommunicator", "SignatureMismatchError", "EXCHANGES",
           "exchange_knobs", "init_ranks", "initialize_distributed"]

_NAMES = ("naive", "flat", "hierarchical", "two_dimensional", "single_node",
          "non_cuda_aware", "pure_nccl", "jax_ici", "dummy", "debug",
          "fault")

#: gradient-exchange vocabulary of the JAX package's bench rows
EXCHANGES = ("per_leaf", "flat", "bucketed", "reduce_scatter",
             "hierarchical", "hierarchical_rs", "striped", "striped_rs")


def exchange_knobs(exchange):
    """``(communicator name, batch_collectives, optimizer exchange=)``
    for a named gradient-exchange structure, the JAX package's mapping
    (the port runs ``per_leaf``, ``flat`` and ``bucketed``; the others
    name communicators or optimizer exchanges that raise until ROADMAP
    A5/A10 port them)."""
    try:
        name, bc = {
            "per_leaf": ("jax_ici", False),
            "flat": ("jax_ici", True),
            "bucketed": ("jax_ici", "bucketed"),
            "reduce_scatter": ("jax_ici", True),
            "hierarchical": ("hierarchical", True),
            "hierarchical_rs": ("hierarchical", True),
            "striped": ("hierarchical", True),
            "striped_rs": ("hierarchical", True),
        }[exchange]
    except KeyError:
        raise ValueError(f"unknown exchange {exchange!r} "
                         f"({'|'.join(EXCHANGES)})") from None
    return name, bc, ("reduce_scatter"
                      if exchange in ("reduce_scatter", "hierarchical_rs",
                                      "striped_rs")
                      else "allreduce")


def create_communicator(communicator_name="jax_ici", device=None,
                        allreduce_grad_dtype=None, batch_collectives=None,
                        bucket_mb=None, intra_size=None, inter_size=None,
                        stripe_ratio=None, autotune=None, group=None):
    """Create a communicator by reference name.

    ``device``: where this rank's tensors live, as every entry point of
    the port takes it (``None`` means ``cuda`` and raises without a card;
    ``"cpu"`` runs on gloo).  The world process group is set up on first
    use from ``torchrun``'s environment, or as a world of one process
    (:func:`initialize_distributed`); ``group`` takes an existing group
    instead.  ``allreduce_grad_dtype``: the gradient's wire dtype on the
    fused-bucket communicators (``"bfloat16"``: cast, allreduce, cast
    back).  ``batch_collectives``: ``False`` (per leaf), ``True`` (one
    flat bucket, the default of the fused names) or ``"bucketed"``
    (``bucket_mb``-bounded buckets, ``CHAINERMN_TPU_BUCKET_MB``).

    ``intra_size``/``inter_size`` (the hierarchical split),
    ``stripe_ratio`` and ``autotune`` raise ``NotImplementedError``: the
    two-level exchange and self-tuning are ROADMAP A10."""
    name = communicator_name
    if name not in _NAMES:
        raise ValueError(
            f"unknown communicator {name!r}; choose from {_NAMES}")
    if name in ("hierarchical", "two_dimensional") \
            or intra_size is not None or inter_size is not None:
        raise NotImplementedError(
            f"communicator {name!r} with intra_size={intra_size}, "
            f"inter_size={inter_size}: the two-level (intra-node x "
            "inter-node) exchange is not ported yet (ROADMAP A10)")
    if stripe_ratio:
        raise NotImplementedError(
            "stripe_ratio: the striped multi-path exchange is not ported "
            "yet (ROADMAP A10)")
    if autotune:
        raise NotImplementedError(
            "autotune: the self-tuning exchange is not ported yet "
            "(ROADMAP A10)")
    if name == "fault":
        raise NotImplementedError(
            "communicator 'fault': fault injection is not ported yet "
            "(ROADMAP A11)")
    if name == "dummy":
        return DummyCommunicator()
    if name == "debug":
        return DebugCommunicator(device=device, group=group,
                                 allreduce_grad_dtype=allreduce_grad_dtype,
                                 batch_collectives=batch_collectives or False,
                                 bucket_mb=bucket_mb)
    if allreduce_grad_dtype is not None and name not in ("pure_nccl",
                                                         "jax_ici"):
        raise ValueError(
            f"allreduce_grad_dtype is supported by the fused-bucket "
            f"communicators, not {name!r} (reference: pure_nccl-only)")
    if batch_collectives is None:
        batch_collectives = name in ("flat", "pure_nccl", "jax_ici",
                                     "single_node")
    comm = MeshCommunicator(device=device, group=group,
                            allreduce_grad_dtype=allreduce_grad_dtype,
                            batch_collectives=batch_collectives,
                            bucket_mb=bucket_mb, name=name)
    if name == "single_node" and comm.inter_size != 1:
        raise ValueError("single_node communicator requires one host "
                         f"(the ranks span {comm.inter_size} hosts)")
    return comm
