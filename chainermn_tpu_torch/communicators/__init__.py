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
``pure_nccl``        flat bucket, optional ``allreduce_grad_dtype`` on the
                     wire (a cast such as bf16, or an int8/fp8 quantized
                     wire with error feedback); ``batch_collectives=
                     "bucketed"`` gives ``bucket_mb``-bounded buckets
``jax_ici``          the JAX package's canonical name (= ``pure_nccl``)
``single_node``      checks that every rank is on one host, else
                     ``pure_nccl``
``dummy``            no-op loopback
``debug``            cross-rank signature checks before each exchange
``hierarchical``     the two-level exchange: reduce-scatter over the
                     intra-node group, the ``1/intra`` chunk's exchange
                     over the inter-node group, all-gather over the
                     intra-node group.  The split comes from the hosts of
                     the ranks, or from ``intra_size=``/``inter_size=``
                     (which make any fused name hierarchical); a
                     ``{"ici": .., "dcn": ..}`` dtype sets each hop's wire
                     (a scalar quantized dtype compresses the inter-node
                     hop only, a scalar cast both).
                     ``CHAINERMN_TPU_HIERARCHY=flat`` falls back to the
                     flat exchange
``two_dimensional``  the same two-level exchange (the reference's
                     leader-staged and chunked variants collapse onto the
                     chunked one, as in the JAX package).  With a nonzero
                     ``stripe_ratio`` (or ``CHAINERMN_TPU_STRIPE_RATIO``)
                     either hierarchical name runs the striped exchange:
                     that share of each bucket takes the transposed,
                     slow-hop-major chain, concurrently with the rest
``fault``            the fused flat communicator (``jax_ici``) wrapped in a
                     :class:`FaultInjectionCommunicator` driven by
                     ``fault_schedule=`` (or ``CHAINERMN_TPU_FAULT_SCHEDULE``);
                     the host channel's transport hook gets a clone of the
                     schedule, and the object calls ride that channel
===================  ========================================================

Resilience and elasticity: :mod:`._host_channel` (an object channel over
the job's ``torch.distributed`` store, with deadlines, retry, heartbeats,
generations and the fail-stop abort flag), :mod:`.fault_schedule` and
:mod:`.fault_injection_communicator` (seeded chaos), :mod:`._membership`
(who is in the job, decided over the store) and
:class:`ElasticMeshCommunicator` (a communicator over the live members,
one default process group per membership epoch).
"""

from __future__ import annotations

import os
import warnings

from ..global_except_hook import _add_hook_if_enabled
from ._communication_utility import init_ranks, initialize_distributed
from .communicator_base import CommunicatorBase
from ._host_channel import (ChannelError, ChannelTimeoutError, HostChannel,
                            PeerLostError, StoreKV, get_host_channel)
from ._membership import ElasticMembership, MembershipView, multicast_tree_plan
from .debug_communicator import DebugCommunicator, SignatureMismatchError
from .dummy_communicator import DummyCommunicator
from .fault_injection_communicator import (FaultInjectionCommunicator,
                                           bind_host_channel)
from .fault_schedule import (FaultSchedule, FaultSpec, InjectedFault,
                             RankPreempted, schedule_from_env)
from .mesh_communicator import ElasticMeshCommunicator, MeshCommunicator

__all__ = ["create_communicator", "CommunicatorBase", "MeshCommunicator",
           "ElasticMeshCommunicator", "DummyCommunicator",
           "DebugCommunicator", "SignatureMismatchError",
           "FaultInjectionCommunicator", "FaultSchedule", "FaultSpec",
           "InjectedFault", "RankPreempted", "schedule_from_env",
           "bind_host_channel", "HostChannel", "StoreKV",
           "get_host_channel", "ChannelError", "ChannelTimeoutError",
           "PeerLostError", "ElasticMembership", "MembershipView",
           "multicast_tree_plan", "EXCHANGES", "exchange_knobs",
           "init_ranks", "initialize_distributed"]

_NAMES = ("naive", "flat", "hierarchical", "two_dimensional", "single_node",
          "non_cuda_aware", "pure_nccl", "jax_ici", "dummy", "debug",
          "fault")

#: gradient-exchange vocabulary of the JAX package's bench rows
EXCHANGES = ("per_leaf", "flat", "bucketed", "reduce_scatter",
             "hierarchical", "hierarchical_rs", "striped", "striped_rs")


def exchange_knobs(exchange):
    """``(communicator name, batch_collectives, optimizer exchange=)``
    for a named gradient-exchange structure, the JAX package's mapping
    (the striped ones also need a nonzero ``stripe_ratio``)."""
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
                        error_feedback=True, stripe_ratio=None,
                        autotune=None, group=None, fault_schedule=None):
    """Create a communicator by reference name.

    ``device``: where this rank's tensors live, as every entry point of
    the port takes it (``None`` means ``cuda`` and raises without a card;
    ``"cpu"`` runs on gloo).  The world process group is set up on first
    use from ``torchrun``'s environment, or as a world of one process
    (:func:`initialize_distributed`); ``group`` takes an existing group
    instead.  ``allreduce_grad_dtype``: the gradient's wire dtype on the
    fused-bucket communicators: a cast (``"bfloat16"``: cast, allreduce,
    cast back) or a quantized wire (``"int8"``, ``"float8_e4m3"``,
    ``"float8_e5m2"``: a per-bucket symmetric scale, with
    ``error_feedback`` carrying the quantization residual); on a
    hierarchical communicator also a per-hop ``{"ici": .., "dcn": ..}``
    dict.  ``CHAINERMN_TPU_COMPRESS=off`` turns the quantized wires back
    into lossless ones.  ``batch_collectives``: ``False`` (per leaf),
    ``True`` (one flat bucket, the default of the fused names) or
    ``"bucketed"`` (``bucket_mb``-bounded buckets,
    ``CHAINERMN_TPU_BUCKET_MB``).  ``intra_size``/``inter_size`` force the
    two-level split (ranks per node x nodes) and make any fused name
    hierarchical.  ``CHAINERMN_TPU_HIERARCHY=flat`` turns
    ``hierarchical``/``two_dimensional`` into the flat exchange (sizes
    dropped; a per-hop dict keeps its ``dcn`` entry, else its ``ici``
    one, with a warning once per dict).

    ``stripe_ratio`` (a hierarchical communicator only; in [0, 1]; else
    ``CHAINERMN_TPU_STRIPE_RATIO``, read for a hierarchical name or a
    forced split): the DCN-path share of each bucket of the striped
    exchange (0, the default, is the plain two-level exchange).

    ``autotune`` (:mod:`._autotune`) tunes the exchange knobs from
    measured fabric numbers: ``True``/``"startup"`` runs the startup
    micro-bench now (collective), agrees the plan across the ranks and
    returns the re-tuned communicator; ``"online"`` leaves it to the
    multi-node optimizer, which re-tunes after its first steps from the
    ``train/grad_exchange`` spans; a dict is a recorded plan, applied as
    it is.  A plan fills only the knobs not set here by hand (an argument
    or its environment variable).

    ``fault_schedule`` (the ``fault`` name only): a :class:`FaultSchedule`
    or its spec dict; ``CHAINERMN_TPU_FAULT_SCHEDULE`` (inline JSON or
    ``@file``) when not given.  The wrapped communicator is ``jax_ici``
    with the other arguments; the host channel's transport hook gets a
    clone of the schedule (same specs and seed, its own counters: a
    rank's transport calls are not lock-step, its API calls are)."""
    name = communicator_name
    if name not in _NAMES:
        raise ValueError(
            f"unknown communicator {name!r}; choose from {_NAMES}")
    if fault_schedule is not None and name != "fault":
        raise ValueError(
            f"fault_schedule= is only honored by the 'fault' "
            f"communicator, not {name!r} — a silently dropped schedule "
            f"would make a chaos run pass vacuously")
    flattened = name in ("hierarchical", "two_dimensional") \
        and os.environ.get("CHAINERMN_TPU_HIERARCHY", "") \
        .strip().lower() in ("flat", "off", "0")
    if flattened:
        # the escape hatch: the flat one-hop exchange, split dropped
        intra_size = inter_size = None
        if isinstance(allreduce_grad_dtype, dict):
            chosen = "dcn" if allreduce_grad_dtype.get("dcn") is not None \
                else "ici"
            _warn_hierarchy_flat_dict_degraded(allreduce_grad_dtype, chosen)
            allreduce_grad_dtype = allreduce_grad_dtype.get(chosen)
        try:
            stripe = stripe_ratio if stripe_ratio is not None else float(
                os.environ.get("CHAINERMN_TPU_STRIPE_RATIO", "") or 0)
        except ValueError:
            stripe = 0
        if stripe:
            _warn_hierarchy_flat_stripe_dropped(stripe)
        stripe_ratio = None
        name = "jax_ici"
    if autotune not in (None, False, True, "startup", "online") \
            and not isinstance(autotune, dict):
        raise ValueError(
            f"autotune must be True/'startup' (micro-bench now), "
            f"'online' (re-tune from the first N steps' trace), or a "
            f"recorded plan dict; got {autotune!r}")
    if autotune and name in ("dummy", "debug"):
        raise ValueError(
            f"autotune= is a mesh-communicator knob, not {name!r} — a "
            f"silently dropped plan would make an autotune run pass "
            f"vacuously")
    if name == "dummy":
        return DummyCommunicator()
    if name == "fault":
        schedule = fault_schedule if fault_schedule is not None \
            else schedule_from_env()
        if schedule is None:
            raise ValueError(
                "communicator 'fault' needs fault_schedule= or the "
                "CHAINERMN_TPU_FAULT_SCHEDULE env var")
        if isinstance(schedule, dict):
            schedule = FaultSchedule.from_dict(schedule)
        base = create_communicator(
            "jax_ici", device=device,
            allreduce_grad_dtype=allreduce_grad_dtype,
            batch_collectives=batch_collectives, bucket_mb=bucket_mb,
            intra_size=intra_size, inter_size=inter_size,
            error_feedback=error_feedback, stripe_ratio=stripe_ratio,
            autotune=autotune, group=group)
        comm = FaultInjectionCommunicator(base, schedule)
        channel = base._host_channel()
        if channel is not None:
            # the clone binds the wrapper's rank: to_dict carries the
            # specs' targeting, a schedule's own binding is per process
            comm.hc_schedule = bind_host_channel(
                channel, FaultSchedule.from_dict(schedule.to_dict())
                .bind_rank(schedule.rank))
        return comm
    if name == "debug":
        comm = DebugCommunicator(device=device, group=group,
                                 allreduce_grad_dtype=allreduce_grad_dtype,
                                 batch_collectives=batch_collectives or False,
                                 bucket_mb=bucket_mb)
        _add_hook_if_enabled()
        return comm
    if allreduce_grad_dtype is not None and name not in (
            "pure_nccl", "jax_ici", "hierarchical", "two_dimensional"):
        raise ValueError(
            f"allreduce_grad_dtype is supported by the fused-bucket "
            f"communicators, not {name!r} (reference: pure_nccl-only)")
    if isinstance(allreduce_grad_dtype, dict) \
            and name not in ("hierarchical", "two_dimensional") \
            and intra_size is None and inter_size is None:
        raise ValueError(
            f"per-hop allreduce_grad_dtype dicts are a hierarchical-"
            f"communicator knob, not {name!r} without an intra_size/"
            f"inter_size split (a flat exchange has one hop)")
    if batch_collectives is None:
        batch_collectives = name in ("flat", "pure_nccl", "jax_ici",
                                     "hierarchical", "two_dimensional",
                                     "single_node")
    comm = MeshCommunicator(device=device, group=group,
                            allreduce_grad_dtype=allreduce_grad_dtype,
                            batch_collectives=batch_collectives,
                            bucket_mb=bucket_mb, name=name,
                            intra_size=intra_size, inter_size=inter_size,
                            error_feedback=error_feedback,
                            stripe_ratio=stripe_ratio)
    if flattened:
        # the hatch degraded a requested hierarchy: the MoE dispatch
        # warns when it drops its two-stage exchange on this mark (a
        # communicator that was never hierarchical never warns)
        comm._hierarchy_flattened_by_env = True
    if name == "single_node" and comm.inter_size != 1:
        raise ValueError("single_node communicator requires one host "
                         f"(the ranks span {comm.inter_size} hosts)")
    # the process group is up now: a world of more than one rank gets the
    # fail-stop except hook (the JAX package installs it at import)
    _add_hook_if_enabled()
    return _apply_autotune(comm, autotune)


def _apply_autotune(comm, autotune):
    """The factory's ``autotune=`` on a new communicator: measure, agree
    and apply now (``"startup"``), leave it to the optimizer
    (``"online"``, the mode rides on the communicator), or apply a
    recorded plan dict."""
    if autotune in (None, False):
        return comm
    if isinstance(autotune, dict):
        return comm.retuned(autotune)
    if autotune == "online":
        comm._autotune_mode = "online"
        return comm
    comm._autotune_mode = "startup"
    from ._autotune import retune_communicator
    return retune_communicator(comm, mode="startup")


#: per-hop dicts and stripe ratios already warned about under the flat
#: escape hatch, and whether the MoE two-stage drop was (once each: a
#: loop that builds communicators must not repeat it)
_WARNED_FLAT_DICTS = set()
_WARNED_FLAT_STRIPES = set()
_WARNED_FLAT_TWO_STAGE = set()


def _warn_hierarchy_flat_two_stage_dropped():
    """``CHAINERMN_TPU_HIERARCHY=flat`` is set and an MoE dispatch that
    would have run the two-stage (intra-node, then inter-node) token
    exchange runs the flat single all-to-all instead.  Once a process
    (``parallel.moe`` calls it when it resolves the dispatch: the factory
    cannot know that a communicator will carry MoE traffic)."""
    if _WARNED_FLAT_TWO_STAGE:
        return
    _WARNED_FLAT_TWO_STAGE.add(True)
    warnings.warn(
        "CHAINERMN_TPU_HIERARCHY=flat drops two-stage MoE routing: the "
        "flat one-axis alias has a single fabric, so token dispatch "
        "runs the flat single-axis all_to_all (on-host tokens ride the "
        "same collective as off-host ones and the DCN crossing cannot "
        "be compressed separately).  Unset CHAINERMN_TPU_HIERARCHY to "
        "restore the two-stage ici × dcn dispatch.",
        UserWarning, stacklevel=4)


def _warn_hierarchy_flat_stripe_dropped(stripe_ratio):
    if stripe_ratio in _WARNED_FLAT_STRIPES:
        return
    _WARNED_FLAT_STRIPES.add(stripe_ratio)
    warnings.warn(
        f"CHAINERMN_TPU_HIERARCHY=flat drops stripe_ratio="
        f"{stripe_ratio}: the flat one-axis alias has a single fabric, "
        f"so the multi-path striped exchange degrades to the flat "
        f"single-path allreduce.  Unset CHAINERMN_TPU_HIERARCHY to "
        f"restore the striped two-fabric schedule.",
        UserWarning, stacklevel=3)


def _warn_hierarchy_flat_dict_degraded(dtype_dict, chosen_key):
    key = tuple(sorted((k, str(v)) for k, v in dtype_dict.items()))
    if key in _WARNED_FLAT_DICTS:
        return
    _WARNED_FLAT_DICTS.add(key)
    dropped = sorted(k for k, v in dtype_dict.items()
                     if k != chosen_key and v is not None)
    detail = (f"dropped per-hop entries {dropped} "
              if dropped else "per-hop structure dropped ")
    warnings.warn(
        f"CHAINERMN_TPU_HIERARCHY=flat degrades per-hop "
        f"allreduce_grad_dtype={dtype_dict!r} to its {chosen_key!r} "
        f"entry ({dtype_dict.get(chosen_key)!r}) on the ONE flat hop: "
        f"{detail}— the full gradient now rides the {chosen_key} "
        f"compression instead of only that hop's chunk.  Unset "
        f"CHAINERMN_TPU_HIERARCHY to restore the two-level exchange.",
        UserWarning, stacklevel=3)
