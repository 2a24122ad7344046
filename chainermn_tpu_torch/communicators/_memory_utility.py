"""Gradient packing and bucket planning.

The port of the pure parts of ``chainermn_tpu.communicators._memory_utility``:
:func:`tree_pack`/:func:`tree_unpack`, :func:`plan_buckets`,
:func:`resolve_grad_dtype`, :func:`pack_params`/:func:`unpack_params`
and the sharded update's flat layout (:func:`padded_length`,
:func:`chunk_bounds`).
A "tree" here is a sequence of tensors (the port's gradients are
``Parameter.grad`` tensors, not a pytree).  The quantized and striped
helpers wait for ROADMAP A10.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["pack_params", "unpack_params", "tree_pack", "tree_unpack",
           "plan_buckets", "resolve_grad_dtype", "is_quantized_dtype",
           "padded_length", "chunk_bounds", "DEFAULT_BUCKET_MB"]

#: default bucket bound (MB) for the bucketed exchange, as in the JAX
#: package (``CHAINERMN_TPU_BUCKET_MB`` overrides)
DEFAULT_BUCKET_MB = 4.0

#: the quantized wire names (their exchange waits for ROADMAP A10)
_QUANTIZED_TORCH = {"int8": torch.int8,
                    "float8_e4m3": torch.float8_e4m3fn,
                    "float8_e4m3fn": torch.float8_e4m3fn,
                    "float8_e5m2": torch.float8_e5m2}


def tree_pack(tensors, dtype=None):
    """Flatten a sequence of tensors into ``(flat, spec)``: one 1-D tensor
    (in ``dtype``, else the tensors' own) and what :func:`tree_unpack`
    needs to cut it back."""
    tensors = list(tensors)
    spec = ([tuple(x.shape) for x in tensors], [x.dtype for x in tensors])
    if not tensors:
        return torch.zeros((0,), dtype=dtype or torch.float32), spec
    flat = torch.cat([x.reshape(-1).to(dtype or x.dtype) for x in tensors])
    return flat, spec


def tree_unpack(flat, spec):
    """The tensors :func:`tree_pack` packed, as views of ``flat`` cast
    back to their dtypes."""
    shapes, dtypes = spec
    out, offset = [], 0
    for shape, dt in zip(shapes, dtypes):
        n = int(np.prod(shape))
        out.append(flat[offset:offset + n].reshape(shape).to(dt))
        offset += n
    return out


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size() \
        if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize


def plan_buckets(shapes, dtypes, bucket_bytes):
    """Partition leaves into size-bounded buckets of leaf INDICES.

    Deterministic pure function of the arguments (identical on every
    rank, which the per-bucket collectives rely on).  Buckets are emitted
    in REVERSE leaf order; a bucket never exceeds ``bucket_bytes`` unless
    a single leaf does, and never mixes dtypes."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    buckets = []
    current = []
    current_bytes = 0
    current_dtype = None
    for i in reversed(range(len(shapes))):
        dt = dtypes[i]
        nbytes = int(np.prod(shapes[i])) * _itemsize(dt)
        if current and (current_bytes + nbytes > bucket_bytes
                        or dt != current_dtype):
            buckets.append(current)
            current, current_bytes = [], 0
        current.append(i)
        current_bytes += nbytes
        current_dtype = dt
    if current:
        buckets.append(current)
    return buckets


def resolve_grad_dtype(dtype):
    """``allreduce_grad_dtype`` entry as a ``torch.dtype``: a torch dtype,
    or a name (``"bfloat16"``, ``"float16"``, ``"float32"``, the quantized
    wire names).  ``None`` passes through (lossless)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = str(np.dtype(dtype)) if not isinstance(dtype, str) else dtype
    if name in _QUANTIZED_TORCH:
        return _QUANTIZED_TORCH[name]
    resolved = getattr(torch, name, None)
    if not isinstance(resolved, torch.dtype):
        raise ValueError(f"unknown allreduce_grad_dtype {dtype!r}")
    return resolved


def is_quantized_dtype(dtype):
    """True for the int8/fp8 wire dtypes (bf16/fp16 are plain casts)."""
    return dtype is not None and resolve_grad_dtype(dtype) in (
        torch.int8, torch.float8_e4m3fn, torch.float8_e5m2)


def pack_params(params, attr="grad", dtype=None):
    """Pack ``param.<attr>`` of a parameter list into one flat vector:
    ``(flat, spec)``."""
    return tree_pack([getattr(p, attr) for p in params], dtype=dtype)


def unpack_params(params, flat, spec, attr="grad"):
    for p, a in zip(params, tree_unpack(flat, spec)):
        setattr(p, attr, a)


def padded_length(n, size):
    """The sharded update's flat length: ``n`` rounded up to a multiple
    of ``size`` (``n_pad = ceil(n / size) * size``, the JAX layout)."""
    return -(-n // size) * size


def chunk_bounds(n_pad, size, rank):
    """``[start, stop)`` of the flat vector that ``rank`` owns:
    ``[rank * n_pad / size, (rank + 1) * n_pad / size)``."""
    chunk = n_pad // size
    return rank * chunk, (rank + 1) * chunk
