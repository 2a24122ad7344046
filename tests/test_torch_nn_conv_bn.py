"""The port's convolution, pooling and batch-normalization functions and
links against the JAX package's, on the CPU.

The same numpy-seeded fp32 (or bf16) arrays go through both packages;
outputs are compared, and gradients against ``jax.grad`` of the same
scalar (the sum of the output times a fixed random cotangent).

Tolerances, relative to the largest |reference| of each compared array:

* fp32: 1e-5 -- the same products, summed in another order by the two
  frameworks' convolutions and reductions; 1e-4 for batch normalization's
  gradients and normalized outputs, which divide by the batch std (as
  small as 0.3 here) and so amplify the reordering.
* bf16: 2 ulps of bf16 (2 ** -7 relative) -- XLA on the CPU rounds a
  fused ``x a + b`` once where an unfused product and sum round twice.
* Max pooling: the outputs exactly (the same maxima); the gradient's
  pattern of nonzero elements exactly, which shows where each window's
  cotangent went -- the planted-tie inputs (small integers) decide which
  element of a window receives it -- and its values to 1e-6 (an element
  in overlapping windows sums their cotangents in another order).
* Initial weights are compared bitwise: both packages draw them with the
  same numpy initializers from the same seed.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chainermn_tpu.core.config import using_config as jusing_config
from chainermn_tpu.nn import functions as JF
from chainermn_tpu.nn import links as JL
from chainermn_tpu_torch.core.config import using_config
from chainermn_tpu_torch.nn import functions as F
from chainermn_tpu_torch.nn import links as L

RTOL = 1e-5
RTOL_BN = 1e-4
BF16_ULPS = 2 * 2.0 ** -7


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, \
        np.abs(got - want).max() / scale


def _data(shape, seed, ints=False):
    rng = np.random.RandomState(seed)
    if ints:   # small integers: many exact ties in every window
        return rng.randint(0, 3, shape).astype(np.float32)
    return rng.normal(0, 1, shape).astype(np.float32)


def _grads(fn, jfn, arrays, seed=99):
    """Output and gradients of ``sum(fn(*arrays) * g)`` on both sides, for
    a fixed random cotangent ``g``."""
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    g = _data(tuple(out.shape), seed)
    (out * torch.from_numpy(g)).sum().backward()
    jout, jgrads = jax.value_and_grad(
        lambda *xs: (jfn(*xs) * jnp.asarray(g)).sum(),
        argnums=tuple(range(len(arrays))))(*map(jnp.asarray, arrays))
    return out, jfn(*map(jnp.asarray, arrays)), \
        [t.grad for t in ts], jgrads


def _nhwc(shape_nchw, layout):
    n, c, h, w = shape_nchw
    return (n, h, w, c) if layout == "NHWC" else shape_nchw


def test_relu_splits_a_tie_as_jax():
    x = np.array([-1.0, 0.0, 2.0], np.float32)
    out, jout, (g,), (jg,) = _grads(F.relu, JF.relu, [x])
    _close(out, jout, 0)
    assert np.array_equal(g.numpy(), np.asarray(jg))   # 0, 1/2, 1


# (x NCHW, W OIHW, stride, pad, dilate, groups)
CONV_CASES = [((2, 3, 9, 9), (4, 3, 3, 3), 1, 1, 1, 1),
              ((2, 3, 11, 10), (5, 3, 3, 2), 2, (1, 0), 1, 1),
              ((2, 4, 12, 12), (6, 4, 3, 3), 1, 2, 2, 1),
              ((1, 4, 8, 8), (4, 2, 1, 1), (2, 1), 0, 1, 2),
              ((2, 3, 15, 15), (8, 3, 7, 7), 2, 3, 1, 1)]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("xs,ws,stride,pad,dilate,groups", CONV_CASES)
def test_convolution_2d_matches_jax(layout, xs, ws, stride, pad, dilate,
                                    groups):
    x = _data(_nhwc(xs, layout), 0)
    W = _data(ws, 1)
    b = _data(ws[:1], 2)
    kw = dict(stride=stride, pad=pad, dilate=dilate, groups=groups,
              layout=layout)
    out, jout, grads, jgrads = _grads(
        lambda x, W, b: F.convolution_2d(x, W, b, **kw),
        lambda x, W, b: JF.convolution_2d(x, W, b, **kw), [x, W, b])
    _close(out, jout)
    for g, jg in zip(grads, jgrads):
        _close(g, jg)


def test_nhwc_convolution_keeps_channels_last():
    """An NHWC convolution returns an NHWC-contiguous tensor: torch sees
    a channels-last view and answers in channels-last memory."""
    x = torch.from_numpy(_data((2, 9, 9, 8), 0))
    W = torch.from_numpy(_data((16, 8, 3, 3), 1)).to(
        memory_format=torch.channels_last)
    y = F.convolution_2d(x, W, pad=1, layout="NHWC")
    assert y.shape == (2, 9, 9, 16) and y.is_contiguous()


# (x NCHW, ksize, stride, pad)
POOL_CASES = [((2, 3, 8, 8), 3, 2, 1),     # ResNet's stem pool
              ((2, 3, 7, 9), 3, 2, 1),
              ((1, 2, 6, 6), 2, None, 0),
              ((2, 2, 10, 7), (3, 2), (2, 3), (1, 0)),
              ((1, 3, 5, 5), 3, 1, 1)]


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("cover_all", [False, True])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("xs,ksize,stride,pad", POOL_CASES)
def test_max_pooling_2d_matches_jax(xs, ksize, stride, pad, layout,
                                    cover_all, ties):
    x = _data(_nhwc(xs, layout), 3, ints=ties)
    kw = dict(stride=stride, pad=pad, cover_all=cover_all, layout=layout)
    out, jout, (g,), (jg,) = _grads(
        lambda x: F.max_pooling_2d(x, ksize, **kw),
        lambda x: JF.max_pooling_2d(x, ksize, **kw), [x])
    assert np.array_equal(out.detach().numpy(), np.asarray(jout))
    # the whole cotangent of a window goes to its first maximum
    assert np.array_equal(g.numpy() != 0, np.asarray(jg) != 0)
    _close(g, jg, 1e-6)


def test_max_pooling_2d_cover_all_pads_the_high_side():
    """cover_all's extra high-side rows: 7 rows, window 2, stride 2 give 4
    output rows (3 without), the last window over one row."""
    x = _data((1, 1, 7, 7), 4)
    y = F.max_pooling_2d(torch.from_numpy(x), 2, cover_all=True)
    assert y.shape == (1, 1, 4, 4)
    assert y[0, 0, 3, 3].item() == x[0, 0, 6, 6]
    assert F.max_pooling_2d(torch.from_numpy(x), 2,
                            cover_all=False).shape == (1, 1, 3, 3)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("xs,ksize,stride,pad", POOL_CASES)
def test_average_pooling_2d_matches_jax(xs, ksize, stride, pad, layout):
    x = _data(_nhwc(xs, layout), 5)
    kw = dict(stride=stride, pad=pad, layout=layout)
    out, jout, (g,), (jg,) = _grads(
        lambda x: F.average_pooling_2d(x, ksize, **kw),
        lambda x: JF.average_pooling_2d(x, ksize, **kw), [x])
    _close(out, jout)
    _close(g, jg)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_global_average_pooling_2d_matches_jax(layout):
    x = _data(_nhwc((3, 5, 6, 7), layout), 6)
    out, jout, (g,), (jg,) = _grads(
        lambda x: F.global_average_pooling_2d(x, layout=layout),
        lambda x: JF.global_average_pooling_2d(x, layout=layout), [x])
    assert out.shape == (3, 5)
    _close(out, jout)
    _close(g, jg)
    # bf16 reduces in bf16 on both sides (accumulated wider, rounded once)
    xb = jnp.asarray(x, jnp.bfloat16)
    got = F.global_average_pooling_2d(
        torch.tensor(np.asarray(xb.astype(jnp.float32))).bfloat16(),
        layout=layout)
    assert got.dtype == torch.bfloat16
    _close(got, JF.global_average_pooling_2d(xb, layout=layout)
           .astype(jnp.float32), BF16_ULPS)


# (x shape, reduced axes or None for the default (0, 2, 3))
BN_CASES = [((4, 3, 5, 5), None), ((4, 5, 5, 3), (0, 1, 2)),
            ((8, 6), None)]


def _bn_inputs(shape, axis, seed):
    c = shape[1] if axis is None else shape[-1]
    # channels offset from 0 (|mean| ~ 2) with stds from 0.3 to 1.5
    rng = np.random.RandomState(seed)
    cshape = [1] * len(shape)
    cshape[1 if axis is None else -1] = c
    x = (rng.normal(0, 1, shape) * rng.uniform(0.3, 1.5, cshape)
         + rng.normal(0, 2, cshape)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.normal(0, 1, c).astype(np.float32)
    return x, gamma, beta


@pytest.mark.parametrize("shape,axis", BN_CASES)
def test_batch_moments_and_normalization_match_jax(shape, axis):
    x, gamma, beta = _bn_inputs(shape, axis, 7)
    ax = (0,) + tuple(range(2, len(shape))) if axis is None else axis
    mean, var = F.batch_moments(torch.from_numpy(x), ax)
    jmean, jvar = JF.batch_moments(jnp.asarray(x), ax)
    _close(mean, jmean)
    _close(var, jvar)
    out, jout, grads, jgrads = _grads(
        lambda x, g, b: F.batch_normalization(x, g, b, axis=axis),
        lambda x, g, b: JF.batch_normalization(x, g, b, axis=axis),
        [x, gamma, beta])
    _close(out, jout, RTOL_BN)
    for g, jg in zip(grads, jgrads):
        _close(g, jg, RTOL_BN)
    # fixed statistics: the moments are inputs, differentiated too
    m = np.asarray(jmean) + 0.1
    v = np.asarray(jvar) * 1.1
    out, jout, grads, jgrads = _grads(
        lambda x, g, b, m, v: F.fixed_batch_normalization(x, g, b, m, v,
                                                          axis=axis),
        lambda x, g, b, m, v: JF.fixed_batch_normalization(x, g, b, m, v,
                                                           axis=axis),
        [x, gamma, beta, m, v])
    _close(out, jout, RTOL_BN)
    for g, jg in zip(grads, jgrads):
        _close(g, jg, RTOL_BN)


@pytest.mark.parametrize("shape,axis", BN_CASES)
def test_batch_normalization_bf16_matches_jax(shape, axis):
    """bf16 activations: fp32 moments, the folded ``x a + b`` in bf16."""
    x, gamma, beta = _bn_inputs(shape, axis, 8)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.tensor(np.asarray(xb.astype(jnp.float32))).bfloat16()
    ax = (0,) + tuple(range(2, len(shape))) if axis is None else axis
    mean, var = F.batch_moments(xt, ax)
    jmean, jvar = JF.batch_moments(xb, ax)
    assert mean.dtype == var.dtype == torch.float32
    _close(mean, jmean)
    _close(var, jvar)
    got = F.batch_normalization(xt, torch.from_numpy(gamma),
                                torch.from_numpy(beta), axis=axis)
    want = JF.batch_normalization(xb, jnp.asarray(gamma), jnp.asarray(beta),
                                  axis=axis)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, want.astype(jnp.float32), BF16_ULPS)
    got = F.fixed_batch_normalization(
        xt, torch.from_numpy(gamma), torch.from_numpy(beta), mean, var,
        axis=axis)
    want = JF.fixed_batch_normalization(
        xb, jnp.asarray(gamma), jnp.asarray(beta), jmean, jvar, axis=axis)
    _close(got, want.astype(jnp.float32), BF16_ULPS)


def _bn_state(link):
    return {p: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor)
                          else v)
            for p, v in link.namedpersistent()}


@pytest.mark.parametrize("finetune", [False, True])
@pytest.mark.parametrize("shape,axis", BN_CASES)
def test_batch_normalization_link_matches_jax(shape, axis, finetune):
    """Train mode: two calls move the running statistics (Chainer's decay,
    the unbiased variance, or finetune's 1 - 1/N); test mode normalizes
    with them."""
    c = shape[1] if axis is None else shape[-1]
    link = L.BatchNormalization(c, decay=0.8, axis=axis, device="cpu")
    jlink = JL.BatchNormalization(c, decay=0.8, axis=axis)
    for seed in (9, 10):
        x, _, _ = _bn_inputs(shape, axis, seed)
        _close(link(torch.from_numpy(x), finetune=finetune),
               jlink(jnp.asarray(x), finetune=finetune), RTOL_BN)
    state, jstate = _bn_state(link), _bn_state(jlink)
    assert sorted(state) == sorted(jstate) == ["/N", "/avg_mean",
                                               "/avg_var"]
    assert int(state["/N"]) == int(jstate["/N"]) == (2 if finetune else 0)
    for key in ("/avg_mean", "/avg_var"):
        _close(state[key], jstate[key])
    x, _, _ = _bn_inputs(shape, axis, 11)
    with using_config("train", False), jusing_config("train", False):
        _close(link(torch.from_numpy(x)), jlink(jnp.asarray(x)))
    # evaluation leaves the statistics alone
    assert all(np.array_equal(v, state[k])
               for k, v in _bn_state(link).items())


def test_links_draw_the_jax_initial_weights():
    """``Convolution2D`` (HeNormal), its ``(out, ksize)`` remap and lazy
    ``in_channels``, and lazy ``Linear``: bitwise the JAX link's weights
    for the same seed, also when created by the first call."""
    pairs = [(L.Convolution2D(3, 8, 3, seed=5, device="cpu"),
              JL.Convolution2D(3, 8, 3, seed=5)),
             (L.Convolution2D(8, (3, 2), seed=6, layout="NHWC",
                              device="cpu"),
              JL.Convolution2D(8, (3, 2), seed=6, layout="NHWC")),
             (L.Convolution2D(None, 4, 1, nobias=True, seed=7,
                              device="cpu"),
              JL.Convolution2D(None, 4, 1, nobias=True, seed=7)),
             (L.Linear(None, 6, seed=8, device="cpu"),
              JL.Linear(None, 6, seed=8)),
             (L.Linear(6, seed=9, device="cpu"), JL.Linear(6, seed=9))]
    inputs = [(2, 3, 5, 5), (2, 5, 5, 3), (2, 3, 5, 5), (2, 3, 4), (2, 7)]
    for (link, jlink), shape in zip(pairs, inputs):
        x = _data(shape, 12)
        _close(link(torch.from_numpy(x)), jlink(jnp.asarray(x)))
        params = dict(link.namedparams())
        jparams = {p: np.asarray(v.array) for p, v in jlink.namedparams()}
        assert sorted(params) == sorted(jparams)
        for p, v in params.items():
            assert np.array_equal(v.detach().numpy(), jparams[p]), p
