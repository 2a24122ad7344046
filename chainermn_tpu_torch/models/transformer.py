"""Transformer language model (pre-norm blocks, causal attention).

The port of ``chainermn_tpu.models.transformer``: the same links, seeds
and parameter paths (so weights carry across, see ``serializers.npz``),
``ops.attention`` dispatching to the flash kernels on a CUDA device (the
lse forward and fused backward under autograd, the plain forward kernel
without), ``compute_dtype`` casting the fp32 embeddings before the blocks,
the LM loss (``forward(x, t)``) and per-block rematerialization
(``torch.utils.checkpoint``).  Sequence parallelism (``sp_comm``) is
refused until it is ported (ROADMAP A9).
"""

from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as _ckpt

from .._device import resolve_device
from ..core import reporter
from ..core.link import Chain, ChainList
from ..nn import functions as F
from ..nn import links as L
from ..ops import attention as fused_attention

__all__ = ["MultiHeadAttention", "TransformerBlock", "TransformerLM"]


class MultiHeadAttention(Chain):
    def __init__(self, d_model, n_heads, seed=0, device=None):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model={d_model} is not divisible by "
                             f"n_heads={n_heads}")
        self.n_heads = n_heads
        self.d_head = d_model // n_heads
        self.qkv = L.Linear(d_model, 3 * d_model, seed=seed, device=device)
        self.proj = L.Linear(d_model, d_model, seed=seed + 1, device=device)

    def forward(self, x, causal=True):
        B, T, D = x.shape
        qkv = self.qkv(x.reshape(B * T, D)).reshape(B, T, 3, self.n_heads,
                                                    self.d_head)
        q, k, v = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
        out = fused_attention(q, k, v, causal=causal)
        out = out.transpose(1, 2).reshape(B * T, D)
        return self.proj(out).reshape(B, T, D)


class TransformerBlock(Chain):
    def __init__(self, d_model, n_heads, d_ff=None, seed=0, device=None):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.ln1 = L.LayerNormalization(d_model, device=device)
        self.attn = MultiHeadAttention(d_model, n_heads, seed=seed,
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


class TransformerLM(Chain):
    """Causal LM.  ``compute_dtype`` (e.g. ``torch.bfloat16``): parameters
    stay fp32 and the blocks compute in this dtype.  ``remat``: ``False`` |
    ``True``/``"full"`` | ``"dots"`` (see :func:`_remat_context`)."""

    def __init__(self, n_vocab, d_model=128, n_heads=4, n_layers=2,
                 max_len=2048, seed=0, sp_comm=None, sp_mode="ring",
                 remat=False, compute_dtype=None, device=None):
        super().__init__()
        if sp_comm is not None:
            raise NotImplementedError(
                "sequence parallelism (sp_comm) is not ported yet "
                "(ROADMAP A9)")
        self._remat_ctx = _remat_context(remat) if remat else None
        self.remat = remat
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.embed = L.EmbedID(n_vocab, d_model, seed=seed, device=device)
        self.pos_embed = L.EmbedID(max_len, d_model, seed=seed + 1,
                                   device=device)
        self.blocks = ChainList(*[
            TransformerBlock(d_model, n_heads, seed=seed + 100 * (i + 1),
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

    def hidden(self, x):
        B, T = x.shape
        pos = torch.arange(T, device=x.device).expand(B, T)
        h = self.embed_tokens(x, pos)
        for block in self.blocks:
            if self._remat_ctx is not None and torch.is_grad_enabled():
                # the backward recomputes the block (what it keeps is
                # the policy's): activation memory for FLOPs
                h = _ckpt.checkpoint(block, h, use_reentrant=False,
                                     context_fn=self._remat_ctx)
            else:
                h = block(h)
        return self.ln_f(h)

    def logits(self, x):
        B, T = x.shape
        h = self.hidden(x)
        return self.head(h.reshape(B * T, -1)).reshape(B, T, -1)

    def forward(self, x, t):
        """LM loss with ignore_label=-1 padding, reported as ``loss``."""
        logits = self.logits(x)
        loss = F.softmax_cross_entropy(
            logits.reshape(-1, logits.shape[-1]), t.reshape(-1),
            ignore_label=-1)
        reporter.report({"loss": loss.detach()}, self)
        return loss
