"""Weights carried across from the JAX package.

Both loaders are strict: a missing key, an extra key or a shape mismatch
raises, so a partially loaded model can never run.

* :func:`load_params` takes ``{path: array}`` keyed by the JAX
  package's ``namedparams`` and ``namedpersistent`` paths
  (``/blocks/0/attn/qkv/W``, ``/res2/0/a/bn/avg_mean``): parameters and
  persistent values (BatchNormalization's running statistics and its
  count ``N``) alike.
* :func:`load_npz` reads the file the JAX package's ``save_npz`` writes:
  keys are the serializer paths without the leading ``/``
  (``blocks/0/attn/qkv/W``).
* :func:`load_optimizer_state` reads a JAX optimizer's serialized state
  (``opt_state_len`` and the flat optax leaves ``opt_state_<i>``) into a
  port optimizer, so that with :func:`load_params` a run started in the
  JAX package resumes in the port.
"""

from __future__ import annotations

import numpy as np
from torch.nn.parameter import is_lazy

from ..core.link import _copy_array

__all__ = ["load_params", "load_npz", "load_optimizer_state"]


def load_params(model, params):
    """Copy ``{path: array}`` into ``model``'s parameters and persistent
    values, each in its own dtype (a lazy parameter takes the array's
    shape)."""
    own = dict(model.namedparams())
    own.update(model.namedpersistent())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise KeyError(f"parameter paths differ: missing {missing}, "
                       f"unexpected {extra}")
    for path, p in own.items():
        shape = np.shape(params[path])
        if not is_lazy(p) and shape != tuple(p.shape):
            raise ValueError(f"{path}: shape {shape} does not match "
                             f"the model's {tuple(p.shape)}")
    for path, p in own.items():
        _copy_array(p, params[path], path)
    return model


def load_npz(file, model):
    """Load a JAX ``save_npz`` snapshot of the same model class."""
    with np.load(file, allow_pickle=False) as npz:
        params = {"/" + key: npz[key] for key in npz.files}
    return load_params(model, params)


def load_optimizer_state(optimizer, serialized, path=""):
    """Set ``optimizer``'s state (and its ``t`` and ``epoch``) from what a
    JAX optimizer's ``serialize`` wrote: ``serialized`` maps keys to
    arrays (a ``save_npz`` file opened with ``np.load``, or a
    ``DictionarySerializer``'s ``target``), ``path`` is the optimizer's
    prefix in it (``"updater/optimizer:main/"`` in a trainer snapshot).
    ``optimizer`` must be set up on the model; a tree of another length
    or leaf shape (another rule or model) raises."""
    key = path + "opt_state_len"
    if key not in serialized:
        raise KeyError(f"{key!r} not found: no optimizer state to load")
    n = int(np.asarray(serialized[key]))
    optimizer.load_state_leaves(
        [serialized[f"{path}opt_state_{i}"] for i in range(n)])
    for name in ("t", "epoch"):
        if path + name in serialized:
            setattr(optimizer, name, int(np.asarray(serialized[path + name])))
    return optimizer
