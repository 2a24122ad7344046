"""Weight initializers (the Chainer ``chainer.initializers`` surface).

A copy of the JAX package's ``nn/initializers.py``, which is pure numpy:
callables ``(shape, dtype, rng) -> np.ndarray`` evaluated on the host at
link construction.  With the same ``numpy.random.RandomState`` seed the
two packages therefore build bit-identical initial weights.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Initializer", "Normal", "Uniform", "Constant", "Zero", "One",
           "LeCunNormal", "GlorotNormal", "GlorotUniform", "HeNormal",
           "HeUniform", "Orthogonal", "Identity", "_get_initializer"]


def _fans(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[1], shape[0]
    # conv kernels (out_ch, in_ch, kh, kw)
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    dtype = None

    def __call__(self, shape, dtype=np.float32, rng=None):
        raise NotImplementedError


class Normal(Initializer):
    def __init__(self, scale=0.05):
        self.scale = scale

    def __call__(self, shape, dtype=np.float32, rng=None):
        rng = rng or np.random
        return rng.normal(0.0, self.scale, size=shape).astype(dtype)


class Uniform(Initializer):
    def __init__(self, scale=0.05):
        self.scale = scale

    def __call__(self, shape, dtype=np.float32, rng=None):
        rng = rng or np.random
        return rng.uniform(-self.scale, self.scale, size=shape).astype(dtype)


class Constant(Initializer):
    def __init__(self, fill_value=0.0):
        self.fill_value = fill_value

    def __call__(self, shape, dtype=np.float32, rng=None):
        return np.full(shape, self.fill_value, dtype=dtype)


class Zero(Constant):
    def __init__(self):
        super().__init__(0.0)


class One(Constant):
    def __init__(self):
        super().__init__(1.0)


class LeCunNormal(Initializer):
    def __init__(self, scale=1.0):
        self.scale = scale

    def __call__(self, shape, dtype=np.float32, rng=None):
        rng = rng or np.random
        fan_in, _ = _fans(shape)
        s = self.scale * np.sqrt(1.0 / fan_in)
        return rng.normal(0.0, s, size=shape).astype(dtype)


class GlorotNormal(Initializer):
    def __init__(self, scale=1.0):
        self.scale = scale

    def __call__(self, shape, dtype=np.float32, rng=None):
        rng = rng or np.random
        fan_in, fan_out = _fans(shape)
        s = self.scale * np.sqrt(2.0 / (fan_in + fan_out))
        return rng.normal(0.0, s, size=shape).astype(dtype)


class GlorotUniform(Initializer):
    def __init__(self, scale=1.0):
        self.scale = scale

    def __call__(self, shape, dtype=np.float32, rng=None):
        rng = rng or np.random
        fan_in, fan_out = _fans(shape)
        s = self.scale * np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-s, s, size=shape).astype(dtype)


class HeNormal(Initializer):
    def __init__(self, scale=1.0):
        self.scale = scale

    def __call__(self, shape, dtype=np.float32, rng=None):
        rng = rng or np.random
        fan_in, _ = _fans(shape)
        s = self.scale * np.sqrt(2.0 / fan_in)
        return rng.normal(0.0, s, size=shape).astype(dtype)


class HeUniform(Initializer):
    def __init__(self, scale=1.0):
        self.scale = scale

    def __call__(self, shape, dtype=np.float32, rng=None):
        rng = rng or np.random
        fan_in, _ = _fans(shape)
        s = self.scale * np.sqrt(6.0 / fan_in)
        return rng.uniform(-s, s, size=shape).astype(dtype)


class Orthogonal(Initializer):
    def __init__(self, scale=1.0):
        self.scale = scale

    def __call__(self, shape, dtype=np.float32, rng=None):
        rng = rng or np.random
        flat = (shape[0], int(np.prod(shape[1:])) if len(shape) > 1 else 1)
        a = rng.normal(0.0, 1.0, size=flat)
        q, r = np.linalg.qr(a if flat[0] >= flat[1] else a.T)
        q = q * np.sign(np.diag(r))
        if flat[0] < flat[1]:
            q = q.T
        return (self.scale * q.reshape(shape)).astype(dtype)


class Identity(Initializer):
    def __init__(self, scale=1.0):
        self.scale = scale

    def __call__(self, shape, dtype=np.float32, rng=None):
        assert len(shape) == 2 and shape[0] == shape[1]
        return (self.scale * np.eye(shape[0])).astype(dtype)


def _get_initializer(initializer, default=None):
    if initializer is None:
        return default or LeCunNormal()
    if isinstance(initializer, Initializer) or callable(initializer):
        return initializer
    if np.isscalar(initializer):
        return Constant(initializer)
    arr = np.asarray(initializer)
    return lambda shape, dtype=np.float32, rng=None: arr.astype(dtype)
