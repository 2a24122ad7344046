"""Mixture-of-experts transformer LM (expert parallelism end to end).

The port of ``chainermn_tpu.models.moe_transformer``: Switch-style MoE
feed-forwards (:mod:`..parallel.moe`) in the attention stack of
:mod:`.transformer`, with the same seeds, parameter paths (the raw
parameters ``router``, ``w_in``, ``b_in``, ``w_out`` and ``b_out`` at
``blocks/<i>/moe/...``, so a JAX snapshot loads through
``serializers.npz``) and knobs.

Routing rule.  The JAX layer dispatches when its communicator's mesh axis
is bound and routes densely outside any mesh.  A rank of the port is
always inside its world, so the port decides by what ``ep_comm`` is:

* a communicator: the expert bank shards one expert a rank over it and
  tokens take the dispatch (top-1, or top-k with ``topk > 1``), always,
  a world of one included; a multi-rank communicator never falls back to
  dense routing;
* an integer ``E``: no communicator, every expert on this rank, dense
  routing (each token through its argmax expert, or the top-k mixture,
  with no capacity cut), the JAX package's single-device route.

Each rank slices its expert from the replicated bank through
``functions.psum_gradient``: one mean-allreduce a layer in the backward,
over the four slices packed together, reassembles the bank's gradient.
The router computes its logits in fp32 (the JAX promotion of a bf16
activation times the fp32 router); the expert GEMMs run in the
activation dtype, their fp32 weights cast as ``L.Linear`` casts its own
(the JAX layer passes them uncast, so its bf16 residual stream turns
fp32 after the first MoE block; fp32 results are the same).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..core import reporter
from ..core.link import Chain, ChainList, Parameter
from ..functions.collective_communication import psum_gradient
from ..nn import functions as F
from ..nn import links as L
from ..parallel.moe import moe_dispatch_combine, moe_dispatch_combine_topk
from .transformer import MultiHeadAttention, _checkpoint_block, _remat_context

__all__ = ["MoEFeedForward", "MoETransformerBlock", "MoETransformerLM"]


def _n_experts(ep_comm):
    return ep_comm if isinstance(ep_comm, int) else ep_comm.size


class MoEFeedForward(Chain):
    """The MoE feed-forward: ``E`` experts (``ep_comm``'s size, or
    ``ep_comm`` itself when it is an integer; see the module's routing
    rule), each ``gelu(h w_in + b_in) w_out + b_out``."""

    def __init__(self, d_model, d_ff, ep_comm, capacity_factor=1.25,
                 seed=0, topk=1, two_stage=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.ep_comm = ep_comm
        self.capacity_factor = capacity_factor
        self.topk = int(topk)
        self.two_stage = two_stage
        E = _n_experts(ep_comm)
        rng = np.random.RandomState(seed)
        self.router = Parameter(rng.normal(0, 0.02, (d_model, E))
                                .astype(np.float32), device=device)
        self.w_in = Parameter(rng.normal(0, 0.02, (E, d_model, d_ff))
                              .astype(np.float32), device=device)
        self.b_in = Parameter(np.zeros((E, d_ff), np.float32),
                              device=device)
        self.w_out = Parameter(rng.normal(0, 0.02, (E, d_ff, d_model))
                               .astype(np.float32), device=device)
        self.b_out = Parameter(np.zeros((E, d_model), np.float32),
                               device=device)

    def _my_expert(self, comm, dtype):
        """This rank's expert from the replicated bank, in ``dtype``,
        through one ``psum_gradient`` over the four slices packed."""
        bank = (self.w_in, self.b_in, self.w_out, self.b_out)
        E = comm.size
        packed = psum_gradient(comm, torch.cat(
            [p.reshape(E, -1) for p in bank], dim=1))[comm.rank]
        sizes = [p[0].numel() for p in bank]
        return [part.view(p.shape[1:]).to(dtype)
                for part, p in zip(packed.split(sizes), bank)]

    def forward(self, x, aux_sink=None):
        B, T, D = x.shape
        tokens = x.reshape(B * T, D)
        logits = tokens.float() @ self.router
        if isinstance(self.ep_comm, int):
            out, aux = self._dense(tokens, logits)
        else:
            out, aux = self._dispatch(tokens, logits)
        if aux_sink is not None:
            aux_sink.append(aux)
        return out.to(x.dtype).reshape(B, T, D)

    def _dispatch(self, tokens, logits):
        comm = self.ep_comm
        w_in, b_in, w_out, b_out = self._my_expert(comm, tokens.dtype)

        def expert_fn(h):
            return F.gelu(h @ w_in + b_in) @ w_out + b_out

        if self.topk > 1:
            out, aux = moe_dispatch_combine_topk(
                comm, tokens, logits, expert_fn, k=self.topk,
                capacity_factor=self.capacity_factor,
                two_stage=self.two_stage)
        else:
            out, aux = moe_dispatch_combine(
                comm, tokens, logits, expert_fn,
                capacity_factor=self.capacity_factor,
                two_stage=self.two_stage)
        return out, {"aux_loss": aux["aux_loss"],
                     "dropped_frac": aux["dropped_frac"]}

    def _dense(self, tokens, logits):
        """Every expert on every token, the top-1 argmax (or top-k
        mixture) selected: the dispatch's routing with nothing dropped."""
        E = self.ep_comm
        D = tokens.shape[1]
        dt = tokens.dtype
        probs = torch.softmax(logits, dim=-1)
        h = torch.einsum("td,edh->teh", tokens, self.w_in.to(dt)) \
            + self.b_in.to(dt)[None]
        y = torch.einsum("teh,ehd->ted", F.gelu(h), self.w_out.to(dt)) \
            + self.b_out.to(dt)[None]
        if self.topk > 1:
            gates, experts = torch.topk(probs, self.topk, dim=-1)
            gates = gates / torch.clamp(gates.sum(1, keepdim=True),
                                        min=1e-9)
            picked = y.gather(1, experts[:, :, None].expand(-1, -1, D))
            out = (picked.float() * gates[:, :, None]).sum(1)
            frac = torch.nn.functional.one_hot(experts, E).amax(1) \
                .float().mean(0)
        else:
            eidx = torch.argmax(probs, dim=-1)
            gate = probs.gather(1, eidx[:, None])[:, 0]
            out = y.gather(1, eidx[:, None, None].expand(-1, 1, D))[:, 0]
            out = out.float() * gate[:, None]
            frac = torch.nn.functional.one_hot(eidx, E).float().mean(0)
        return out, {"aux_loss": E * torch.sum(frac * probs.mean(0)),
                     "dropped_frac": torch.zeros((), device=tokens.device)}


class MoETransformerBlock(Chain):
    def __init__(self, d_model, n_heads, d_ff, ep_comm, seed=0,
                 sp_comm=None, sp_mode="ring", capacity_factor=1.25,
                 topk=1, two_stage=None, device=None):
        super().__init__()
        self.ln1 = L.LayerNormalization(d_model, device=device)
        self.attn = MultiHeadAttention(d_model, n_heads, seed=seed,
                                       sp_comm=sp_comm, sp_mode=sp_mode,
                                       device=device)
        self.ln2 = L.LayerNormalization(d_model, device=device)
        self.moe = MoEFeedForward(d_model, d_ff, ep_comm, capacity_factor,
                                  seed=seed + 50, topk=topk,
                                  two_stage=two_stage, device=device)

    def forward(self, x, aux_sink=None, causal=True):
        h = x + self.attn(self.ln1(x), causal=causal)
        return h + self.moe(self.ln2(h), aux_sink=aux_sink)


class MoETransformerLM(Chain):
    """Causal LM with MoE feed-forwards.  ``aux_weight`` scales the Switch
    load-balancing loss added to the LM loss; ``topk``/``two_stage`` reach
    every block's dispatch; ``compute_dtype`` and ``remat`` are
    ``TransformerLM``'s (the recompute runs the block's exchange again,
    on every rank in one order).  Reports ``loss``, ``moe_aux`` (the mean
    load-balancing loss) and ``moe_dropped`` (the mean capacity-cut
    fraction)."""

    def __init__(self, n_vocab, ep_comm, d_model=128, n_heads=4,
                 n_layers=2, d_ff=None, max_len=2048, seed=0,
                 aux_weight=0.01, capacity_factor=1.25,
                 compute_dtype=None, remat=False, topk=1,
                 two_stage=None, device=None):
        super().__init__()
        device = resolve_device(device)
        d_ff = d_ff or 4 * d_model
        self.aux_weight = aux_weight
        self.compute_dtype = compute_dtype
        self.remat = remat
        self._remat_ctx = _remat_context(remat) if remat else None
        self._collective = not isinstance(ep_comm, int)
        self.embed = L.EmbedID(n_vocab, d_model, seed=seed, device=device)
        self.pos_embed = L.EmbedID(max_len, d_model, seed=seed + 1,
                                   device=device)
        self.blocks = ChainList(*[
            MoETransformerBlock(d_model, n_heads, d_ff, ep_comm,
                                seed=seed + 100 * (i + 1),
                                capacity_factor=capacity_factor,
                                topk=topk, two_stage=two_stage,
                                device=device)
            for i in range(n_layers)])
        self.ln_f = L.LayerNormalization(d_model, device=device)
        self.head = L.Linear(d_model, n_vocab, nobias=True, seed=seed + 999,
                             device=device)

    def forward(self, x, t):
        B, T = x.shape
        pos = torch.arange(T, device=x.device).expand(B, T)
        h = self.embed(x) + self.pos_embed(pos)
        if self.compute_dtype is not None:
            h = h.to(self.compute_dtype)
        aux_sink = []
        for block in self.blocks:
            if self._remat_ctx is not None and torch.is_grad_enabled():
                # the aux values leave the recomputed region as outputs
                def run(hh, blk=block):
                    sink = []
                    out = blk(hh, aux_sink=sink)
                    return out, sink[0]["aux_loss"], sink[0]["dropped_frac"]
                h, aux, dropped = _checkpoint_block(
                    run, h, self._remat_ctx, self._collective)
                aux_sink.append({"aux_loss": aux, "dropped_frac": dropped})
            else:
                h = block(h, aux_sink=aux_sink)
        h = self.ln_f(h)
        logits = self.head(h.reshape(B * T, -1))
        loss = F.softmax_cross_entropy(logits, t.reshape(-1),
                                       ignore_label=-1)
        n = max(len(aux_sink), 1)
        aux = sum(a["aux_loss"] for a in aux_sink) / n
        dropped = sum(a["dropped_frac"] for a in aux_sink) / n
        reporter.report({"loss": loss.detach(), "moe_aux": aux.detach(),
                         "moe_dropped": dropped.detach()}, self)
        return loss + self.aux_weight * aux
