"""Weights carried across from the JAX package.

Both loaders are strict: a missing key, an extra key or a shape mismatch
raises, so a partially loaded model can never run.

* :func:`load_params` takes ``{path: array}`` keyed by the JAX
  package's ``namedparams`` paths (``/blocks/0/attn/qkv/W``).
* :func:`load_npz` reads the file the JAX package's ``save_npz`` writes:
  keys are the serializer paths without the leading ``/``
  (``blocks/0/attn/qkv/W``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_params", "load_npz"]


def load_params(model, params):
    """Copy ``{namedparams path: array}`` into ``model``'s parameters."""
    own = dict(model.namedparams())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise KeyError(f"parameter paths differ: missing {missing}, "
                       f"unexpected {extra}")
    for path, p in own.items():
        arr = np.asarray(params[path])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{path}: shape {arr.shape} does not match "
                             f"the model's {tuple(p.shape)}")
    with torch.no_grad():
        for path, p in own.items():
            p.copy_(torch.from_numpy(np.array(params[path],
                                              dtype=np.float32)))
    return model


def load_npz(file, model):
    """Load a JAX ``save_npz`` snapshot of the same model class."""
    with np.load(file, allow_pickle=False) as npz:
        params = {"/" + key: npz[key] for key in npz.files}
    return load_params(model, params)
