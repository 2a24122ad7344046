"""Transformer language model (pre-norm blocks, causal attention).

The port of ``chainermn_tpu.models.transformer`` for inference: the same
links, seeds and parameter paths (so weights carry across, see
``serializers.npz``), ``ops.attention`` dispatching to the flash kernel on
a CUDA device, and ``compute_dtype`` casting the fp32 embeddings before
the blocks.  Sequence parallelism, remat and the loss belong to the
training slice (ROADMAP A2).
"""

from __future__ import annotations

import torch

from .._device import resolve_device
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


class TransformerLM(Chain):
    """Causal LM.  ``compute_dtype`` (e.g. ``torch.bfloat16``): parameters
    stay fp32 and the blocks compute in this dtype."""

    def __init__(self, n_vocab, d_model=128, n_heads=4, n_layers=2,
                 max_len=2048, seed=0, compute_dtype=None, device=None):
        super().__init__()
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
            h = block(h)
        return self.ln_f(h)

    def logits(self, x):
        B, T = x.shape
        h = self.hidden(x)
        return self.head(h.reshape(B * T, -1)).reshape(B, T, -1)
