"""Sequence-to-sequence NMT model (BASELINE configs #3 and #4).

The port of ``chainermn_tpu.models.seq2seq`` (reference capability:
ChainerMN's ``examples/seq2seq/seq2seq.py``, an LSTM encoder-decoder on
WMT, and its model-parallel encoder/decoder split over
``MultiNodeChainList``).  The recurrence is :class:`~..nn.rnn.NStepLSTM`
(a Python loop over time calling the packed-gate cell), batch-major,
with teacher forcing; ``PAD`` (-1) marks padding: it embeds to zeros,
freezes the encoder's state and leaves the loss.  Parameter names and
seeds are the JAX package's, so an npz snapshot crosses between them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import reporter
from ..core.link import Chain
from ..links import MultiNodeChainList
from ..nn import functions as F
from ..nn import links as L

__all__ = ["Seq2seq", "Encoder", "Decoder", "ModelParallelSeq2seq",
           "create_model_parallel_seq2seq",
           "make_synthetic_translation_data"]

PAD = -1


class Encoder(Chain):
    """An ``n_layers`` LSTM encoder: ``forward(xs)`` (int ``[B, T]``,
    PAD-padded) returns the final state stacked ``[2, L, B, H]`` (``c``
    then ``h``), each sequence's taken at its last true token."""

    def __init__(self, n_vocab, n_units, n_layers=1, seed=0, device=None):
        super().__init__()
        self.embed = L.EmbedID(n_vocab, n_units, ignore_label=PAD,
                               seed=seed, device=device)
        self.lstm = L.NStepLSTM(n_layers, n_units, n_units, seed=seed + 1,
                                device=device)

    def forward(self, xs):
        hy, cy, _ = self.lstm(None, None, self.embed(xs), mask=xs != PAD)
        return torch.stack([cy, hy])


class Decoder(Chain):
    def __init__(self, n_vocab, n_units, n_layers=1, seed=10, device=None):
        super().__init__()
        self.n_units = n_units
        self.embed = L.EmbedID(n_vocab, n_units, ignore_label=PAD,
                               seed=seed, device=device)
        self.lstm = L.NStepLSTM(n_layers, n_units, n_units, seed=seed + 1,
                                device=device)
        self.out = L.Linear(n_units, n_vocab, seed=seed + 2, device=device)

    def forward(self, state, ys_in, ys_out):
        """The teacher-forced loss from the encoder's ``[2, L, B, H]``
        state: mean cross entropy over the non-PAD targets."""
        _, _, hs = self.lstm(state[1], state[0], self.embed(ys_in))
        logits = self.out(hs.reshape(-1, self.n_units))
        return F.softmax_cross_entropy(logits, ys_out.reshape(-1),
                                       ignore_label=PAD)

    def step_tokens(self, c, h, tok):
        """One greedy step through every layer: ``(c, h)`` ``[L, B, H]``
        and ``tok`` ``[B]`` -> ``(c, h, next tok)``."""
        inp = self.embed(tok)
        new_c, new_h = [], []
        for layer, cell in enumerate(self.lstm):
            c_l, h_l = cell(c[layer], h[layer], inp)
            new_c.append(c_l)
            new_h.append(h_l)
            inp = h_l
        tok = torch.argmax(self.out(inp), dim=1).to(torch.int32)
        return torch.stack(new_c), torch.stack(new_h), tok


class Seq2seq(Chain):
    """The single-process encoder-decoder (the reference example's
    model)."""

    def __init__(self, n_source_vocab, n_target_vocab, n_units,
                 n_layers=1, seed=0, device=None):
        super().__init__()
        self.encoder = Encoder(n_source_vocab, n_units, n_layers=n_layers,
                               seed=seed, device=device)
        self.decoder = Decoder(n_target_vocab, n_units, n_layers=n_layers,
                               seed=seed + 100, device=device)

    def forward(self, xs, ys_in, ys_out):
        loss = self.decoder(self.encoder(xs), ys_in, ys_out)
        reporter.report({"loss": loss.detach()}, self)
        return loss

    def translate(self, xs, bos_id, eos_id, max_length=32):
        """Greedy decoding: ``[B, max_length]`` int32 tokens (all
        ``max_length`` steps, as the JAX scan; ``eos_id`` is the
        reference's argument, unused)."""
        state = self.encoder(xs)
        c, h = state[0], state[1]
        tok = torch.full((xs.shape[0],), bos_id, dtype=torch.int32,
                         device=xs.device)
        toks = []
        for _ in range(max_length):
            c, h, tok = self.decoder.step_tokens(c, h, tok)
            toks.append(tok)
        return torch.stack(toks, dim=1)


class _EncoderComponent(Chain):
    def __init__(self, encoder):
        super().__init__()
        self.encoder = encoder

    def forward(self, xs, ys_in, ys_out):
        return self.encoder(xs)


class _DecoderWrapper(Chain):
    def __init__(self, decoder):
        super().__init__()
        self.decoder = decoder

    def forward(self, state, xs, ys_in, ys_out):
        # the encoder's state over the stage edge, then the list's inputs
        # (pass_inputs=True); xs is the encoder's input, unused here
        return self.decoder(state, ys_in, ys_out)


class ModelParallelSeq2seq(MultiNodeChainList):
    """The encoder on ``rank_encoder``, the decoder on ``rank_decoder``
    (BASELINE config #4): the encoder's ``[2, L, B, H]`` state crosses
    the edge by the differentiable send/recv pair, and the decoder's loss
    is the terminal output, on every rank.  ``rank_encoder ==
    rank_decoder`` makes the edge a local hand-off."""

    def __init__(self, comm, n_source_vocab, n_target_vocab, n_units,
                 rank_encoder=0, rank_decoder=1, n_layers=1, seed=0,
                 device=None):
        super().__init__(comm)
        enc = Encoder(n_source_vocab, n_units, n_layers=n_layers, seed=seed,
                      device=device)
        dec = Decoder(n_target_vocab, n_units, n_layers=n_layers,
                      seed=seed + 100, device=device)
        self.add_link(_EncoderComponent(enc), rank_in=None,
                      rank_out=rank_decoder, rank=rank_encoder)
        self.add_link(_DecoderWrapper(dec), rank_in=rank_encoder,
                      rank_out=None, rank=rank_decoder, pass_inputs=True)

    def forward(self, xs, ys_in, ys_out):
        loss = super().forward(xs, ys_in, ys_out)
        reporter.report({"loss": loss.detach()}, self)
        return loss


def create_model_parallel_seq2seq(comm, n_source_vocab, n_target_vocab,
                                  n_units, **kwargs):
    return ModelParallelSeq2seq(comm, n_source_vocab, n_target_vocab,
                                n_units, **kwargs)


def make_synthetic_translation_data(n=256, src_vocab=40, tgt_vocab=40,
                                    max_len=12, seed=0):
    """Deterministic toy translation task: target = reversed source mapped
    through a fixed permutation (learnable; no network access)."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(tgt_vocab - 3) + 3  # reserve 0=bos,1=eos,2=unk
    xs = np.full((n, max_len), PAD, np.int32)
    ys_in = np.full((n, max_len + 1), PAD, np.int32)
    ys_out = np.full((n, max_len + 1), PAD, np.int32)
    for i in range(n):
        length = rng.randint(3, max_len + 1)
        src = rng.randint(3, src_vocab, size=length)
        tgt = perm[(src[::-1] - 3) % (tgt_vocab - 3)]
        xs[i, :length] = src
        ys_in[i, 0] = 0
        ys_in[i, 1:length + 1] = tgt
        ys_out[i, :length] = tgt
        ys_out[i, length] = 1
    return xs, ys_in, ys_out
