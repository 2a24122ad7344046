"""Batch assembly (consumed-Chainer surface: ``chainer.dataset.convert``).

The port of ``chainermn_tpu.dataset.convert``: batches are stacked on the
host with numpy and go to the given device once, as tensors.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["concat_examples", "to_device"]


def _stack(xs, padding=None):
    first = np.asarray(xs[0])
    if padding is None:
        return np.stack([np.asarray(x) for x in xs])
    shape = np.array(first.shape, dtype=int)
    for x in xs[1:]:
        shape = np.maximum(shape, np.asarray(x).shape)
    out = np.full((len(xs),) + tuple(shape), padding, dtype=first.dtype)
    for i, x in enumerate(xs):
        x = np.asarray(x)
        out[(i,) + tuple(slice(0, s) for s in x.shape)] = x
    return out


def concat_examples(batch, device=None, padding=None):
    """Stack a list of examples (arrays, tuples or dicts of arrays) into
    batch arrays; with ``device``, tensors on that device."""
    if not batch:
        raise ValueError("batch is empty")
    first = batch[0]
    if isinstance(first, tuple):
        result = tuple(
            _stack([ex[i] for ex in batch],
                   padding[i] if isinstance(padding, tuple) else padding)
            for i in range(len(first)))
    elif isinstance(first, dict):
        result = {
            key: _stack([ex[key] for ex in batch],
                        padding[key] if isinstance(padding, dict)
                        else padding)
            for key in first}
    else:
        result = _stack(batch, padding)
    if device is not None:
        result = to_device(result, device)
    return result


def to_device(x, device=None):
    """Host arrays (a tuple, dict or single array) as tensors on
    ``device``: a copy, so the caller may mutate the source afterwards.
    ``device=None`` leaves ``x`` as it is."""
    if device is None:
        return x
    if isinstance(x, tuple):
        return tuple(to_device(a, device) for a in x)
    if isinstance(x, dict):
        return {k: to_device(a, device) for k, a in x.items()}
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x)).to(device)
