"""Transformer language model (pre-norm blocks, causal attention).

The port of ``chainermn_tpu.models.transformer``: the same links, seeds
and parameter paths (so weights carry across, see ``serializers.npz``),
``ops.attention`` dispatching to the flash kernels on a CUDA device (the
lse forward and fused backward under autograd, the plain forward kernel
without), ``compute_dtype`` casting the fp32 embeddings before the blocks,
the LM loss (``forward(x, t)``) and per-block rematerialization
(``torch.utils.checkpoint``).  With ``sp_comm`` the sequence is sharded
over that communicator's ranks: attention runs as ring attention
(``sp_mode="ring"`` or the balanced ``"zigzag"``) or Ulysses
(``"ulysses"``, :mod:`..parallel`), every other op stays position-local,
so the same weights serve one card and the sharded sequence.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils import checkpoint as _ckpt

from .. import observability
from .._device import resolve_device
from ..core import reporter
from ..core.link import Chain, ChainList
from ..nn import functions as F
from ..nn import links as L
from ..ops import attention as fused_attention
from ..parallel.ring_attention import ring_self_attention
from ..parallel.ulysses import ulysses_attention

__all__ = ["MultiHeadAttention", "TransformerBlock", "TransformerLM"]


_SP_MODES = ("ring", "zigzag", "ulysses")


class MultiHeadAttention(Chain):
    def __init__(self, d_model, n_heads, seed=0, sp_comm=None,
                 sp_mode="ring", device=None):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model={d_model} is not divisible by "
                             f"n_heads={n_heads}")
        if sp_mode not in _SP_MODES:
            raise ValueError(f"unknown sp_mode {sp_mode!r}; use one of "
                             f"{_SP_MODES}")
        self.n_heads = n_heads
        self.d_head = d_model // n_heads
        self.sp_comm = sp_comm
        self.sp_mode = sp_mode
        self.qkv = L.Linear(d_model, 3 * d_model, seed=seed, device=device)
        self.proj = L.Linear(d_model, d_model, seed=seed + 1, device=device)

    def forward(self, x, causal=True):
        B, T, D = x.shape
        qkv = self.qkv(x.reshape(B * T, D)).reshape(B, T, 3, self.n_heads,
                                                    self.d_head)
        q, k, v = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
        if self.sp_comm is None:
            with observability.scope("model/attention"):
                out = fused_attention(q, k, v, causal=causal)
        elif self.sp_mode == "ulysses":
            out = ulysses_attention(self.sp_comm, q, k, v, causal=causal)
        else:
            out = ring_self_attention(
                self.sp_comm, q, k, v, causal=causal,
                schedule="zigzag" if self.sp_mode == "zigzag" else "naive")
        out = out.transpose(1, 2).reshape(B * T, D)
        return self.proj(out).reshape(B, T, D)


class TransformerBlock(Chain):
    def __init__(self, d_model, n_heads, d_ff=None, seed=0, sp_comm=None,
                 sp_mode="ring", device=None):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.ln1 = L.LayerNormalization(d_model, device=device)
        self.attn = MultiHeadAttention(d_model, n_heads, seed=seed,
                                       sp_comm=sp_comm, sp_mode=sp_mode,
                                       device=device)
        self.ln2 = L.LayerNormalization(d_model, device=device)
        self.fc1 = L.Linear(d_model, d_ff, seed=seed + 10, device=device)
        self.fc2 = L.Linear(d_ff, d_model, seed=seed + 11, device=device)

    def forward(self, x, causal=True):
        B, T, D = x.shape
        h = x + self.attn(self.ln1(x), causal=causal)
        m = self.fc2(F.gelu(self.fc1(self.ln2(h).reshape(B * T, D))))
        return h + m.reshape(B, T, D)


# weight GEMMs: what "dots" keeps (the JAX dots_with_no_batch_dims_saveable:
# Linear products are 2-D; the attention dots carry batch dims)
_GEMMS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_gemms(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _GEMMS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(remat):
    """``context_fn`` for ``torch.utils.checkpoint`` from the ``remat``
    knob (the JAX ``_remat_policy``): ``True`` / ``"full"`` save nothing
    and recompute the block; ``"dots"`` keeps the weight-GEMM outputs and
    recomputes the elementwise and attention tail.  Other names raise."""
    if remat is True or remat == "full":
        return _ckpt.noop_context_fn
    if remat == "dots":
        return functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                 _keep_gemms)
    raise ValueError(f"unknown remat policy {remat!r}; use True/'full' or "
                     "'dots'")


def _checkpoint_block(block, h, context_fn, sp):
    """``block(h)`` under ``torch.utils.checkpoint``.  Under sequence
    parallelism the recompute runs the block's collectives again, so it
    runs the whole block on every rank (no early stop: ranks whose
    branches save different tensors would stop at different transfers)."""
    with (_ckpt.set_checkpoint_early_stop(False) if sp
          else contextlib.nullcontext()):
        return _ckpt.checkpoint(block, h, use_reentrant=False,
                                context_fn=context_fn)


class TransformerLM(Chain):
    """Causal LM.  ``compute_dtype`` (e.g. ``torch.bfloat16``): parameters
    stay fp32 and the blocks compute in this dtype.  ``remat``: ``False`` |
    ``True``/``"full"`` | ``"dots"`` (see :func:`_remat_context`).

    Sequence parallelism: pass ``sp_comm`` and call every rank with its
    shard of the sequence (``[B, T / n]`` tokens).  Position ids follow
    the shard: ``rank * T_local`` onwards for ``sp_mode="ring"`` and
    ``"ulysses"``, the two half-chunk ranges of the zigzag layout for
    ``"zigzag"`` (shard tokens and targets with
    ``parallel.zigzag_shard`` along T).  The loss is this rank's mean;
    ``create_multi_node_optimizer`` over ``sp_comm`` averages the
    gradients."""

    def __init__(self, n_vocab, d_model=128, n_heads=4, n_layers=2,
                 max_len=2048, seed=0, sp_comm=None, sp_mode="ring",
                 remat=False, compute_dtype=None, device=None):
        super().__init__()
        self.sp_comm = sp_comm
        self.sp_mode = sp_mode
        self._remat_ctx = _remat_context(remat) if remat else None
        self.remat = remat
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.embed = L.EmbedID(n_vocab, d_model, seed=seed, device=device)
        self.pos_embed = L.EmbedID(max_len, d_model, seed=seed + 1,
                                   device=device)
        self.blocks = ChainList(*[
            TransformerBlock(d_model, n_heads, seed=seed + 100 * (i + 1),
                             sp_comm=sp_comm, sp_mode=sp_mode,
                             device=device)
            for i in range(n_layers)])
        self.ln_f = L.LayerNormalization(d_model, device=device)
        self.head = L.Linear(d_model, n_vocab, nobias=True, seed=seed + 999,
                             device=device)

    @property
    def device(self):
        return self.head.W.device

    def embed_tokens(self, tokens, positions):
        """Token + position embeddings (fp32), cast to the compute dtype."""
        h = self.embed(tokens) + self.pos_embed(positions)
        if self.compute_dtype is not None:
            h = h.to(self.compute_dtype)
        return h

    def positions(self, T, device):
        """The ``[T]`` position ids of this rank's ``T`` tokens."""
        local = torch.arange(T, device=device)
        comm = self.sp_comm
        if comm is None:
            return local
        if self.sp_mode != "zigzag":
            return comm.rank * T + local
        # zigzag: half-chunks i and 2n - 1 - i, two disjoint ranges
        h, n, i = T // 2, comm.size, comm.rank
        return torch.where(local < h, i * h + local,
                           (2 * n - 1 - i) * h + (local - h))

    def hidden(self, x):
        B, T = x.shape
        pos = self.positions(T, x.device).expand(B, T)
        h = self.embed_tokens(x, pos)
        for block in self.blocks:
            if self._remat_ctx is not None and torch.is_grad_enabled():
                # the backward recomputes the block (what it keeps is
                # the policy's): activation memory for FLOPs
                h = _checkpoint_block(block, h, self._remat_ctx,
                                      self.sp_comm is not None)
            else:
                h = block(h)
        return self.ln_f(h)

    def logits(self, x):
        return self._head(self.hidden(x))

    def _head(self, h):
        B, T = h.shape[:2]
        return self.head(h.reshape(B * T, -1)).reshape(B, T, -1)

    def forward(self, x, t):
        """LM loss with ignore_label=-1 padding, reported as ``loss``."""
        h = self.hidden(x)
        with observability.scope("model/head_loss"):
            logits = self._head(h)
            loss = F.softmax_cross_entropy(
                logits.reshape(-1, logits.shape[-1]), t.reshape(-1),
                ignore_label=-1)
        reporter.report({"loss": loss.detach()}, self)
        return loss
