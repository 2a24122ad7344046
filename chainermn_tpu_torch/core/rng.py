"""Per-step randomness for stochastic layers.

The port of ``chainermn_tpu.core.rng``.  The reference's ``F.dropout``
draws from a hidden global RNG.  Here, as in the JAX package, the
training step decides the randomness: the optimizer derives one key per
step from its seed and opens :class:`key_scope` around the forward; the
scope holds a ``torch.Generator`` on the step's device, seeded from that
key, and ``F.dropout`` draws its masks from it (:func:`next_key`).  So a
new step draws new masks, each rank of a data-parallel step draws its own
(the multi-node step folds the rank into the key), and a run resumed from
a snapshot (which carries the key) draws the masks of the uninterrupted
run.  The masks themselves differ from the JAX package's: another
generator draws them.

A key is the JAX form, two uint32 words (``jax.random.PRNGKey(seed)`` is
``[0, seed]``), so a key from a JAX snapshot loads and carries on.  Keys
are split and folded on the host with ``numpy.random.SeedSequence``: no
device work and no sync.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["push_key", "pop_key", "next_key", "key_scope", "make_key",
           "split", "fold_in", "generator"]

_tl = threading.local()


def _stack():
    if not hasattr(_tl, "stack"):
        _tl.stack = []
    return _tl.stack


def make_key(seed):
    """The key of ``seed``, as ``jax.random.PRNGKey(seed)`` lays it out."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def _derive(key, *words):
    return np.random.SeedSequence(
        [int(w) for w in np.asarray(key, np.uint32)] + [int(w) for w in words]
    ).generate_state(2, np.uint32)


def split(key):
    """``(new_key, subkey)``: two keys derived from ``key``."""
    return _derive(key, 0), _derive(key, 1)


def fold_in(key, data):
    """A key derived from ``key`` and the integer ``data`` (a rank, a
    step index)."""
    return _derive(key, 2, int(data))


def generator(key, device):
    """A ``torch.Generator`` on ``device`` seeded from ``key``."""
    words = np.asarray(key, np.uint32)
    seed = (int(words[0]) << 32 | int(words[1])) & 0x7FFFFFFFFFFFFFFF
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


class _KeyCtx:
    """A scope's key and device; its generator is made at the first
    draw, so a step that draws nothing makes none."""

    __slots__ = ("key", "device", "gen")

    def __init__(self, key, device):
        self.key, self.device, self.gen = key, device, None
        if isinstance(key, torch.Generator):
            self.gen = key


def push_key(key, device="cpu"):
    _stack().append(_KeyCtx(key, device))


def pop_key():
    _stack().pop()


class key_scope:
    """Make ``key`` the source of :func:`next_key` inside the block:
    a key (two uint32 words) whose generator is made on ``device`` at the
    first draw, or a ``torch.Generator``.  ``None`` opens no scope."""

    def __init__(self, key, device="cpu"):
        self.key = key
        self.device = device

    def __enter__(self):
        if self.key is not None:
            push_key(self.key, self.device)
        return self

    def __exit__(self, *exc):
        if self.key is not None:
            pop_key()
        return False


def next_key():
    """The innermost scope's generator, or None outside any.  Each draw
    advances it, so two calls in one step draw different masks."""
    stack = _stack()
    if not stack:
        return None
    ctx = stack[-1]
    if ctx.gen is None:
        ctx.gen = generator(ctx.key, ctx.device)
    return ctx.gen
