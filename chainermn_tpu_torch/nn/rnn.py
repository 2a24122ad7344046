"""Recurrent links over padded sequences.

The port of ``chainermn_tpu.nn.rnn`` (reference: ``chainer/links/
connection/n_step_lstm.py · NStepLSTM``, ``n_step_gru.py · NStepGRU``,
``gru.py · GRU/StatelessGRU``).  The cells pack their gates into one
product, as in the JAX package; a sequence is a Python loop over time
calling the cell once per step (the JAX package's ``lax.scan``), on
batch-major ``[B, T, D]`` input with an optional ``[B, T]`` mask that
freezes the state at padding.  ``torch.nn.LSTM`` (cuDNN) is not used:
its gate order, its two biases and its packed-sequence semantics differ
from the JAX cell.
"""

from __future__ import annotations

import torch

from ..core.link import ChainList, Link
from . import functions as F
from .links import Linear, StatelessLSTM

__all__ = ["StatelessGRU", "GRU", "NStepLSTM", "NStepGRU"]


class StatelessGRU(Link):
    """One GRU step, ``(h, x) -> h`` (``L.StatelessGRU``): the reset and
    update gates in one product (``w_rz``, ``u_rz``), the candidate apart
    (``w_h``, ``u_h``: its lateral term is gated by ``r`` first)."""

    def __init__(self, in_size, out_size, seed=None, device=None):
        super().__init__()
        self.out_size = out_size

        def s(k):
            return None if seed is None else seed + k

        self.w_rz = Linear(in_size, 2 * out_size, seed=s(0), device=device)
        self.u_rz = Linear(out_size, 2 * out_size, nobias=True, seed=s(1),
                           device=device)
        self.w_h = Linear(in_size, out_size, seed=s(2), device=device)
        self.u_h = Linear(out_size, out_size, nobias=True, seed=s(3),
                          device=device)

    def forward(self, h, x):
        if h is None:
            h = x.new_zeros((x.shape[0], self.out_size))
        r, z = F.sigmoid(self.w_rz(x) + self.u_rz(h)).chunk(2, dim=1)
        h_bar = F.tanh(self.w_h(x) + self.u_h(r * h))
        return (1 - z) * h + z * h_bar


class GRU(StatelessGRU):
    """The GRU step holding ``h`` between calls (``L.GRU``)."""

    def __init__(self, in_size, out_size, seed=None, device=None):
        super().__init__(in_size, out_size, seed=seed, device=device)
        self.h = None

    def reset_state(self):
        self.h = None

    def set_state(self, h):
        self.h = h

    def forward(self, x):
        self.h = super().forward(self.h, x)
        return self.h


def _mask_step(new, old, mask_t):
    """``new`` where the step is valid, ``old`` at padding."""
    return torch.where(mask_t[:, None], new, old)


class _NStepRNNBase(ChainList):
    def __init__(self, n_layers, in_size, out_size, cell_factory, seed=0):
        super().__init__(*[cell_factory(in_size if i == 0 else out_size,
                                        out_size, seed + 10 * i)
                           for i in range(n_layers)])
        self.n_layers = n_layers
        self.out_size = out_size

    def _inputs(self, hx, xs, mask):
        B, T, _ = xs.shape
        if hx is None:
            hx = xs.new_zeros((self.n_layers, B, self.out_size))
        if mask is None:
            mask = torch.ones((B, T), dtype=torch.bool, device=xs.device)
        return hx, mask

    def _layer_input(self, layer, h_seq):
        """Inter-layer dropout: only between layers, only in training
        (``F.dropout`` reads ``config.train``)."""
        if layer > 0 and self.dropout:
            return F.dropout(h_seq, self.dropout)
        return h_seq


class NStepLSTM(_NStepRNNBase):
    """Multi-layer LSTM over padded sequences.

    ``forward(hx, cx, xs, mask=None)``: ``xs`` ``[B, T, D]``; ``hx``,
    ``cx`` ``[L, B, H]`` or ``None`` (zeros); ``mask`` ``[B, T]`` bool
    (True where valid: the state stays put at padding).  Returns ``(hy,
    cy, ys)``, ``ys`` ``[B, T, H]``: the reference's contract on padded
    batches."""

    def __init__(self, n_layers, in_size, out_size, dropout=0.0, seed=0,
                 device=None):
        super().__init__(n_layers, in_size, out_size,
                         lambda i, o, s: StatelessLSTM(i, o, seed=s,
                                                       device=device),
                         seed)
        self.dropout = dropout

    def forward(self, hx, cx, xs, mask=None):
        hx, mask = self._inputs(hx, xs, mask)
        cx = torch.zeros_like(hx) if cx is None else cx
        h_seq = xs
        hy, cy = [], []
        for layer, cell in enumerate(self):
            inp = self._layer_input(layer, h_seq)
            c, h = cx[layer], hx[layer]
            ys = []
            for t in range(inp.shape[1]):
                c_new, h_new = cell(c, h, inp[:, t])
                m_t = mask[:, t]
                c = _mask_step(c_new, c, m_t)
                h = _mask_step(h_new, h, m_t)
                ys.append(h)
            h_seq = torch.stack(ys, dim=1)
            hy.append(h)
            cy.append(c)
        return torch.stack(hy), torch.stack(cy), h_seq


class NStepGRU(_NStepRNNBase):
    """Multi-layer GRU over padded sequences: ``forward(hx, xs, mask)`` ->
    ``(hy, ys)``."""

    def __init__(self, n_layers, in_size, out_size, dropout=0.0, seed=0,
                 device=None):
        super().__init__(n_layers, in_size, out_size,
                         lambda i, o, s: StatelessGRU(i, o, seed=s,
                                                      device=device),
                         seed)
        self.dropout = dropout

    def forward(self, hx, xs, mask=None):
        hx, mask = self._inputs(hx, xs, mask)
        h_seq = xs
        hy = []
        for layer, cell in enumerate(self):
            inp = self._layer_input(layer, h_seq)
            h = hx[layer]
            ys = []
            for t in range(inp.shape[1]):
                h = _mask_step(cell(h, inp[:, t]), h, mask[:, t])
                ys.append(h)
            h_seq = torch.stack(ys, dim=1)
            hy.append(h)
        return torch.stack(hy), h_seq
