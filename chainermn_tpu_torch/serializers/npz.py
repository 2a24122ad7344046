"""NPZ serializers (consumed-Chainer surface: ``chainer.serializers``).

The port of ``chainermn_tpu.serializers.npz``: the serializer protocol --
``serializer("key", value)`` plus ``serializer["child"]`` descent -- that
``Link.serialize``, ``Optimizer.serialize``, the multi-node optimizer's
``serialize`` and ``Trainer.serialize`` speak, with the JAX package's
key paths, so a snapshot written by either package loads into the other.

* :func:`save_npz` writes ``obj.serialize``'s keys (tensors come to the
  host, numbers become 0-d arrays, ``None`` an empty array);
* :func:`load_npz` reads them back into anything with ``serialize``: a
  model, an optimizer, a whole ``Trainer``.  ``strict`` raises on a key
  the object asks for and the file lacks; keys the object does not ask
  for are ignored (the reference's behavior).

Two loaders keep their narrower contracts:

* :func:`load_params` takes ``{path: array}`` keyed by the JAX
  package's ``namedparams`` and ``namedpersistent`` paths
  (``/blocks/0/attn/qkv/W``, ``/res2/0/a/bn/avg_mean``) and is strict
  both ways: a missing key, an extra key or a shape mismatch raises
  before anything is copied.
* :func:`load_optimizer_state` reads a JAX optimizer's serialized state
  (``opt_state_len`` and the flat optax leaves ``opt_state_<i>``) into a
  port optimizer already set up on its model.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn.parameter import is_lazy

from ..core.link import _copy_array

__all__ = ["Serializer", "DictionarySerializer", "NpzDeserializer",
           "save_npz", "load_npz", "load_params", "load_optimizer_state"]


class Serializer:
    is_writer = False

    def __getitem__(self, name):
        raise NotImplementedError

    def __call__(self, key, value):
        raise NotImplementedError


def _to_numpy(value):
    """A serialized value as a host array: ``None`` an empty fp32 array,
    a number a 0-d array, a tensor its detached host copy."""
    if value is None:
        return np.array([], dtype=np.float32)
    if np.isscalar(value) or isinstance(value, (bool, int, float)):
        return np.asarray(value)
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class DictionarySerializer(Serializer):
    """Writer: collects ``{path: host array}`` in ``target``."""

    is_writer = True

    def __init__(self, target=None, path=""):
        self.target = {} if target is None else target
        self.path = path

    def __getitem__(self, name):
        return DictionarySerializer(self.target, self.path + name + "/")

    def __call__(self, key, value):
        self.target[self.path + key] = _to_numpy(value)
        return value


class NpzDeserializer(Serializer):
    """Reader over an opened npz file (or any mapping of arrays)."""

    is_writer = False

    def __init__(self, npz, path="", strict=True):
        self.npz = npz
        self.path = path
        self.strict = strict

    def __getitem__(self, name):
        return NpzDeserializer(self.npz, self.path + name + "/", self.strict)

    def __call__(self, key, value):
        full = self.path + key
        if full not in self.npz:
            if self.strict:
                raise KeyError(f"key {full!r} not found in snapshot")
            return value
        data = self.npz[full]
        if data.size == 0 and value is None:
            return None
        return data


def save_npz(file, obj, compression=True):
    """Write ``obj.serialize``'s keys to ``file`` (a path or a binary
    file object)."""
    s = DictionarySerializer()
    obj.serialize(s)
    save = np.savez_compressed if compression else np.savez
    if isinstance(file, str):
        with open(file, "wb") as f:
            save(f, **s.target)
    else:
        save(file, **s.target)


def load_npz(file, obj, path="", strict=True):
    """Load what :func:`save_npz` (of either package) wrote into ``obj``
    (anything with ``serialize``), from the keys under ``path``.
    Returns ``obj``."""
    with np.load(file, allow_pickle=False) as npz:
        obj.serialize(NpzDeserializer(npz, path=path, strict=strict))
    return obj


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
