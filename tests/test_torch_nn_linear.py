"""The port's ``F.linear`` and ``L.Linear`` against the JAX package's on
inputs of two to four axes, on the CPU.

Chainer's rule: the first ``n_batch_axes`` axes are the batch and every
later axis is flattened into the input width.  Inputs come from numpy
seeds; both sides get the same fp32 arrays (the links the same weights,
from the shared numpy initializers and one seed).

Tolerance: 1e-6 of the largest |reference| -- the same fp32 products,
summed in another order by the two frameworks' matrix products.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from chainermn_tpu.nn import functions as JF
from chainermn_tpu.nn import links as JL
from chainermn_tpu_torch.nn import functions as F
from chainermn_tpu_torch.nn import links as L

RTOL = 1e-6
OUT = 5

# (x shape, n_batch_axes): ndim 2, 3 and 4 with one and two batch axes
CASES = [((6, 4), 1), ((6, 4), 2), ((2, 3, 4), 1), ((2, 3, 4), 2),
         ((2, 3, 4, 5), 1), ((2, 3, 4, 5), 2)]


def _in_size(shape, n_batch_axes):
    return int(np.prod(shape[n_batch_axes:]))


def _assert_close(got, want):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


@pytest.mark.parametrize("shape,n_batch_axes", CASES + [
    # [2, 3, 4] against W [5, 12] gives [2, 5]: what the last-axis-only
    # product refused (mat1 6 x 4 and mat2 12 x 5)
    ((2, 3, 4), None)])
def test_linear_matches_jax(shape, n_batch_axes):
    rng = np.random.RandomState(len(shape) + 10 * (n_batch_axes or 0))
    in_size = _in_size(shape, n_batch_axes or 1)
    x = rng.normal(0, 1, shape).astype(np.float32)
    W = rng.normal(0, 1, (OUT, in_size)).astype(np.float32)
    b = rng.normal(0, 1, (OUT,)).astype(np.float32)
    kw = {} if n_batch_axes is None else {"n_batch_axes": n_batch_axes}
    got = F.linear(torch.from_numpy(x), torch.from_numpy(W),
                   torch.from_numpy(b), **kw)
    want = JF.linear(jnp.asarray(x), jnp.asarray(W), jnp.asarray(b), **kw)
    if n_batch_axes is None:
        assert got.shape == (2, OUT)
    _assert_close(got, want)
    # without a bias, the same rule
    _assert_close(F.linear(torch.from_numpy(x), torch.from_numpy(W), **kw),
                  JF.linear(jnp.asarray(x), jnp.asarray(W), **kw))


@pytest.mark.parametrize("shape,n_batch_axes", CASES)
def test_linear_link_matches_jax(shape, n_batch_axes):
    in_size = _in_size(shape, n_batch_axes)
    link = L.Linear(in_size, OUT, initial_bias=0.25, seed=3, device="cpu")
    jlink = JL.Linear(in_size, OUT, initial_bias=0.25, seed=3)
    assert np.array_equal(link.W.detach().numpy(), np.asarray(jlink.W.array))
    assert np.array_equal(link.b.detach().numpy(), np.asarray(jlink.b.array))
    x = np.random.RandomState(len(shape) + n_batch_axes).normal(
        0, 1, shape).astype(np.float32)
    got = link(torch.from_numpy(x), n_batch_axes=n_batch_axes)
    want = jlink(jnp.asarray(x), n_batch_axes=n_batch_axes)
    assert got.shape == shape[:n_batch_axes] + (OUT,)
    _assert_close(got, want)
