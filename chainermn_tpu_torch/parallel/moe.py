"""Expert parallelism: Switch-style mixture of experts over all-to-all.

The port of ``chainermn_tpu.parallel.moe``.  Experts are sharded one a
rank of the communicator; tokens are routed top-1 (Switch) or top-k
(GShard) with a fixed capacity per expert, exchanged by an all-to-all,
transformed by the local expert and sent back by the reverse exchange.

On a hierarchical communicator the exchange is two-stage: an all-to-all
over the intra-node group first (tokens regroup by destination slot
within the node, so tokens whose expert is on the node never cross the
slow fabric), then one over the inter-node group carrying the off-node
remainder; the combine runs the reverse, slow hop first, in the order of
:func:`~..communicators._memory_utility.hop_schedule` ``("moe")``.  The
two stages compose to exactly the flat all-to-all, so the lossless
two-stage exchange is bitwise the flat one.  The inter-node crossing
takes the communicator's ``dcn`` wire: a cast (bf16) or int8/fp8
codewords with one scale per destination node
(:func:`~..communicators._memory_utility.quantize_symmetric_segments`),
the backward crossing the same compressed wire (straight-through).  The
own node's block is restored from the values before the crossing: it
never left the rank.

``two_stage=False`` is the explicit flat choice on a hierarchical
communicator; ``CHAINERMN_TPU_HIERARCHY=flat`` drops the two-stage
exchange with a warning once; ``CHAINERMN_TPU_COMPRESS=off`` nulls a
quantized ``dcn`` wire at the communicator.

The JAX package selects with one-hot ``[T, E, C]`` masks and einsums;
here the same selection is an index copy into the ``[E, C, D]`` buffer
and a gather out of it (no mask: at bench width the mask would be 42 MB
a layer).  The aux dict is the JAX one: ``aux_loss``, ``frac``,
``mean_prob``, ``dropped_frac`` (the routed copies cut by the capacity)
and ``capacity``.  Gradients flow through the combine weights.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as TF

from ..communicators._memory_utility import (dequantize_symmetric,
                                             hop_schedule,
                                             is_quantized_dtype,
                                             quantize_symmetric_segments)
from ..communicators.mesh_communicator import _BYTE_WIRE
from ..nn import functions as F

__all__ = ["switch_moe", "moe_dispatch_combine", "moe_dispatch_combine_topk",
           "moe_capacity"]


def moe_capacity(n_tokens, n_experts, capacity_factor, k=1):
    """Slots per expert of the capacity buffer: ``max(1,
    int(capacity_factor * k * n_tokens / n_experts))`` over this rank's
    tokens (the JAX package's one formula)."""
    return max(1, int(capacity_factor * k * n_tokens / n_experts))


def _resolve_two_stage(comm, two_stage):
    """The ``two_stage`` knob against the communicator's topology:
    ``None`` is two-stage on a hierarchical communicator and flat on a
    flat one; ``True`` on a flat communicator raises, unless the
    ``CHAINERMN_TPU_HIERARCHY=flat`` hatch flattened a requested
    hierarchy (the ``_hierarchy_flattened_by_env`` mark), which drops it
    with a warning once."""
    hier = getattr(comm, "hierarchy", None) is not None
    hatch = getattr(comm, "_hierarchy_flattened_by_env", False)
    if two_stage is None:
        if not hier and hatch:
            from ..communicators import _warn_hierarchy_flat_two_stage_dropped
            _warn_hierarchy_flat_two_stage_dropped()
        return hier
    if two_stage and not hier:
        if hatch:
            from ..communicators import _warn_hierarchy_flat_two_stage_dropped
            _warn_hierarchy_flat_two_stage_dropped()
            return False
        raise ValueError(
            "two_stage=True needs a hierarchical communicator "
            "(name='hierarchical'/'two_dimensional' or an intra_size/"
            "inter_size split): a flat mesh has one fabric, there is "
            "no second hop to stage the dispatch across")
    return bool(two_stage)


# -- the exchange -----------------------------------------------------------------

def _all_to_all(x, group):
    """``x[j]`` to the ``j``-th rank of ``group``; ``out[j]`` from it."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """The all-to-all over a leading axis of the group's size; its
    transpose is itself (square blocks)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, _all_to_all(g, ctx.group)


def _own_restored(comm, v, crossed):
    """``crossed`` with the own node's block put back from ``v``."""
    own = torch.arange(comm.dcn_size, device=v.device) == comm.dcn_index
    return torch.where(own.view((-1,) + (1,) * (v.dim() - 1)), v, crossed)


def _quantized_crossing(comm, group, wire, v):
    """``v`` ``[inter, ...]`` across the inter-node group as codewords
    with one scale a segment (each crossing on its own all-to-all), each
    block decoded with its sender's scale; the own block restored."""
    q, scales = quantize_symmetric_segments(v, wire)
    send = q.view(torch.uint8) if q.dtype in _BYTE_WIRE else q
    qr = _all_to_all(send, group).view(q.dtype)
    sr = _all_to_all(scales, group)
    comm.calls["moe_dcn_alltoall_q"] += 1
    deq = dequantize_symmetric(qr, sr.view((-1,) + (1,) * (v.dim() - 1)))
    return _own_restored(comm, v, deq.to(v.dtype))


class _QuantizedCrossing(torch.autograd.Function):
    """The quantized crossing; its backward is the same compressed
    crossing of the cotangents (straight-through: the codebook's round
    has no useful gradient, and a lossless backward would give back the
    bytes the forward saved)."""

    @staticmethod
    def forward(ctx, comm, group, wire, v):
        ctx.args = comm, group, wire
        return _quantized_crossing(comm, group, wire, v)

    @staticmethod
    def backward(ctx, g):
        return None, None, None, _quantized_crossing(*ctx.args, g)


def _dcn_crossing_fn(comm):
    """The slow all-to-all of the two-stage exchange on a ``[inter,
    ...]`` buffer, at the communicator's ``dcn`` wire: lossless (the
    plain all-to-all), a cast (cast, cross, cast back, the own block
    restored) or quantized (:class:`_QuantizedCrossing`)."""
    inter_g = comm._hop_groups[1]
    wire = comm.dcn_grad_dtype
    if wire is None:
        return lambda v: _AllToAll.apply(inter_g, v)
    if not is_quantized_dtype(wire):
        def cast_crossing(v):
            out = _AllToAll.apply(inter_g, v.to(wire))
            return _own_restored(comm, v, out.to(v.dtype))
        return cast_crossing
    return lambda v: _QuantizedCrossing.apply(comm, inter_g, wire, v)


def _exchange(comm, buf, two_stage, combine=False):
    """Move an ``[E, C, ...]`` capacity buffer between source ranks and
    expert ranks (dispatch: slot ``e`` of every rank lands on rank ``e``;
    ``combine=True``: the inverse).  Flat: one all-to-all over the
    communicator.  Two-stage: ``[inter, intra, C, ...]``, the intra-node
    and inter-node stages in ``hop_schedule("moe")``'s order (rank ``d *
    intra + i`` is node ``d``, place ``i``)."""
    if not two_stage:
        comm.calls["moe_alltoall"] += 1
        return _AllToAll.apply(comm.group, buf)
    inter, intra = comm.dcn_size, comm.ici_size
    intra_g = comm._hop_groups[0]
    crossing = _dcn_crossing_fn(comm)
    s = buf.reshape((inter, intra) + buf.shape[1:])
    phase = "combine" if combine else "dispatch"
    for op, _ in hop_schedule(1, mode="moe"):
        if op == f"ici_{phase}":
            s = _AllToAll.apply(intra_g, s.transpose(0, 1)).transpose(0, 1)
        elif op == f"dcn_{phase}":
            s = crossing(s)
        else:
            continue
        comm.calls[f"moe_{op}"] += 1
    return s.reshape(buf.shape)


# -- routing ------------------------------------------------------------------------

def _positions(expert_idx, n_experts):
    """Each routed copy's place in its expert's queue, in order."""
    onehot = TF.one_hot(expert_idx, n_experts)
    return (torch.cumsum(onehot, 0) * onehot).sum(1) - 1


def _one_hot_capacity(expert_idx, n_experts, capacity):
    """Queue positions with the capacity cut: ``(position [T], keep
    [T])``; token ``t`` takes slot ``position[t]`` of its expert unless
    over capacity (dropped: zero output, gradient only through the
    load-balancing loss).  The JAX function returns the ``[T, E, C]``
    mask these indices select."""
    position = _positions(expert_idx, n_experts)
    return position, position < capacity


def _topk_dispatch(probs, k, capacity):
    """Joint top-k capacity assignment: ``(experts [T, k], position [T,
    k], gates [T, k], keep [T, k])``; positions count over the routed
    copies in token-major, slot-minor order, so no two copies share a
    slot."""
    T, E = probs.shape
    gates, experts = torch.topk(probs, k, dim=-1)
    position = _positions(experts.reshape(T * k), E).reshape(T, k)
    return experts, position, gates, position < capacity


def _route(comm, x, expert, position, keep, capacity, expert_fn,
           two_stage):
    """Dispatch the routed copies of ``x`` (``expert``/``position``/
    ``keep`` ``[N]`` over ``x``'s rows), run this rank's expert, send
    the results back; returns the ``[N, D]`` outputs (0 where dropped)."""
    E = comm.size
    D = x.shape[-1]
    n = E * capacity
    slot = expert * capacity + position.clamp(0, capacity - 1)
    # dropped copies go to a spare row past the buffer (no host sync to
    # count the kept ones); the row is cut off before the exchange
    send = x.new_zeros((n + 1, D)).index_copy(
        0, torch.where(keep, slot, n), x)[:n]
    recv = _exchange(comm, send.view(E, capacity, D), two_stage)
    h = expert_fn(recv.reshape(n, D)).reshape(E, capacity, D)
    back = _exchange(comm, h, two_stage, combine=True)
    picked = back.reshape(n, D).index_select(0, slot)
    return torch.where(keep[:, None], picked,
                       torch.zeros((), dtype=picked.dtype, device=x.device))


def _aux(E, probs, kept_onehot, keep):
    """The load-balancing statistics: ``frac`` (share of tokens with a
    kept copy at each expert), ``mean_prob``, ``aux_loss = E sum(frac
    mean_prob)`` and ``dropped_frac``."""
    frac = kept_onehot.float().mean(0)
    mean_prob = probs.mean(0)
    return {"aux_loss": E * torch.sum(frac * mean_prob), "frac": frac,
            "mean_prob": mean_prob,
            "dropped_frac": 1.0 - keep.float().mean()}


def moe_dispatch_combine(comm, x, gate_logits, expert_fn,
                         capacity_factor=1.25, two_stage=None):
    """Route this rank's tokens through the rank-sharded experts (top-1).

    ``x``: ``[T_local, D]``; ``gate_logits``: ``[T_local, E]`` with ``E ==
    comm.size`` (one expert a rank); ``expert_fn`` applies this rank's
    expert to ``[E * C, D]``.  ``two_stage``: ``None`` topology-aware,
    ``False`` the explicit flat exchange, ``True`` required (raises on a
    flat communicator).  Returns ``([T_local, D], aux)``; every rank
    calls it."""
    two_stage = _resolve_two_stage(comm, two_stage)
    E = comm.size
    T = x.shape[0]
    capacity = moe_capacity(T, E, capacity_factor)
    probs = torch.softmax(gate_logits, dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)
    gate = probs.gather(1, expert_idx[:, None])[:, 0]
    position, keep = _one_hot_capacity(expert_idx, E, capacity)
    out = _route(comm, x, expert_idx, position, keep, capacity, expert_fn,
                 two_stage)
    out, gate = _promoted(out, gate[:, None])
    combined = out * gate
    aux = _aux(E, probs, TF.one_hot(expert_idx, E) * keep[:, None], keep)
    return combined, {**aux, "capacity": capacity}


def moe_dispatch_combine_topk(comm, x, gate_logits, expert_fn, k=2,
                              capacity_factor=1.25, normalize_gates=True,
                              two_stage=None):
    """Top-k routing (GShard): each token goes to its ``k`` most probable
    experts and their outputs mix with the (renormalized) gates.  The
    exchange and its compression are the top-1 path's;
    ``dropped_frac`` counts over the ``T k`` routed copies."""
    two_stage = _resolve_two_stage(comm, two_stage)
    E = comm.size
    T, D = x.shape
    capacity = moe_capacity(T, E, capacity_factor, k=k)
    probs = torch.softmax(gate_logits, dim=-1)
    experts, position, gates, keep = _topk_dispatch(probs, k, capacity)
    if normalize_gates:
        gates = gates / torch.clamp(gates.sum(1, keepdim=True), min=1e-9)
    gates = gates * keep.to(gates.dtype)
    out = _route(comm, x.repeat_interleave(k, 0), experts.reshape(-1),
                 position.reshape(-1), keep.reshape(-1), capacity,
                 expert_fn, two_stage).reshape(T, k, D)
    out, g = _promoted(out, gates[:, :, None])
    combined = (out * g).sum(1)
    kept_onehot = (TF.one_hot(experts, E) * keep[:, :, None]).amax(1)
    aux = _aux(E, probs, kept_onehot, keep)
    return combined, {**aux, "capacity": capacity}


def _promoted(a, b):
    """``a`` and ``b`` in their promoted dtype (the JAX mixed-dtype
    rule: a bf16 activation times an fp32 weight computes in fp32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def switch_moe(comm, x, router_w, w_in, b_in, w_out, b_out,
               capacity_factor=1.25, activation=F.gelu, two_stage=None):
    """A whole Switch MoE layer: the router and this rank's expert MLP.

    ``x``: ``[T_local, D]``; ``router_w``: ``[D, E]`` (replicated);
    ``w_in`` ``[D, H]``, ``b_in``, ``w_out`` ``[H, D]``, ``b_out``: this
    rank's expert.  Mixed dtypes promote as in the JAX package.
    Returns ``([T_local, D], aux)``."""
    gate_logits = torch.matmul(*_promoted(x, router_w))

    def expert_fn(h):
        a = activation(torch.matmul(*_promoted(h, w_in)) + b_in)
        return torch.matmul(*_promoted(a, w_out)) + b_out

    return moe_dispatch_combine(comm, x, gate_logits, expert_fn,
                                capacity_factor=capacity_factor,
                                two_stage=two_stage)
