"""Fused batch norm with its activation (``ops/batch_norm.py``) on the CPU:
which calls ``L.BatchNormalization`` hands to the kernels, what the
kernels' entry refuses, the plain version the CPU takes, the residual path
of ``ConvBN`` and the residual blocks against the composition they
replace, and the kernels' grid.

The kernels themselves run only on the card (``tests/test_torch_gpu.py``);
here the dispatch is checked by spying on the entry, with the link's rule
asked about a stand-in on a CUDA device where a test needs the card's
answer.
"""

import types

import numpy as np
import pytest
import torch

from chainermn_tpu_torch.core.config import using_config
from chainermn_tpu_torch.links import MultiNodeBatchNormalization
from chainermn_tpu_torch.models.resnet import (BasicBlock, BottleneckBlock,
                                               ConvBN)
from chainermn_tpu_torch.nn import functions as F
from chainermn_tpu_torch.nn import links as L
from chainermn_tpu_torch.ops import batch_norm as bn


class _Comm:
    """A communicator of one (the subclass's hook is then the identity)."""
    size = 1


@pytest.fixture
def spy(monkeypatch):
    """Record each call of the kernels' entry; run the plain version in
    its place."""
    calls = []

    def fake(x, gamma, beta, avg_mean=None, avg_var=None, eps=2e-5,
             decay=0.9, relu=False, residual=None):
        calls.append({"shape": tuple(x.shape), "relu": relu,
                      "residual": residual is not None,
                      "moves": avg_mean is not None})
        return bn.batch_norm_act_plain(
            x, gamma, beta, avg_mean, avg_var, eps=eps, decay=decay,
            relu=relu, residual=residual)

    monkeypatch.setattr(bn, "batch_norm_act", fake)
    return calls


@pytest.fixture
def as_on_the_card(monkeypatch):
    """The link's rule answers for a tensor of the same shape on a CUDA
    device: its own test of the class, the reduced axes and training then
    decides."""
    rule = L.BatchNormalization._takes_kernel

    def on_card(self, x, axis):
        return rule(self, types.SimpleNamespace(is_cuda=True, dim=x.dim),
                    axis)

    monkeypatch.setattr(L.BatchNormalization, "_takes_kernel", on_card)


def _x(shape, seed=0, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.normal(0.5, 2, shape).astype(
        np.float32)).to(dtype)


@pytest.mark.parametrize("shape,axis", [((4, 5, 5, 16), (0, 1, 2)),
                                        ((12, 24), None)])
def test_channels_last_training_takes_the_kernels(spy, as_on_the_card, shape,
                                                  axis):
    """NHWC (reduced axes 0, 1, 2) and 2-D ``(N, C)`` batch norm in
    training go to the kernels' entry, once, with the running
    statistics."""
    link = L.BatchNormalization(shape[-1], axis=axis, device="cpu")
    link(_x(shape), relu=True)
    assert spy == [{"shape": shape, "relu": True, "residual": False,
                    "moves": True}]


def test_cpu_tensors_keep_the_plain_path(spy):
    link = L.BatchNormalization(16, axis=(0, 1, 2), device="cpu")
    link(_x((4, 5, 5, 16)))
    assert spy == []


def test_nchw_keeps_the_plain_path(spy, as_on_the_card):
    link = L.BatchNormalization(16, device="cpu")
    link(_x((4, 16, 5, 5)))
    assert spy == []


def test_multi_node_batch_norm_keeps_the_plain_path(spy, as_on_the_card):
    link = MultiNodeBatchNormalization(16, _Comm(), axis=(0, 1, 2),
                                       device="cpu")
    link(_x((4, 5, 5, 16)))
    assert spy == []


def test_eval_keeps_the_plain_path(spy, as_on_the_card):
    link = L.BatchNormalization(16, axis=(0, 1, 2), device="cpu")
    with using_config("train", False):
        y = link(_x((4, 5, 5, 16)), relu=True)
    assert spy == []
    assert (y >= 0).all()


@pytest.mark.parametrize("finetune", [False, True])
def test_fused_path_moves_the_running_statistics_once(spy, as_on_the_card,
                                                      monkeypatch, finetune):
    """Through the fused path (the plain version in its place) the link's
    output and running statistics equal the plain path's bitwise; with
    ``finetune`` the fused call moves nothing and the link moves them by
    1 - 1/N."""
    x = _x((6, 3, 3, 16), seed=1)
    runs = []
    for fused in (True, False):
        link = L.BatchNormalization(16, decay=0.8, axis=(0, 1, 2),
                                    device="cpu")
        if not fused:
            monkeypatch.setattr(L.BatchNormalization, "_takes_kernel",
                                lambda *a: False)
        ys = [link(x, finetune=finetune, relu=True) for _ in range(2)]
        runs.append(ys + [link.avg_mean.clone(), link.avg_var.clone(),
                          link.N.clone()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert runs[0][-1].item() == (2 if finetune else 0)
    assert [c["moves"] for c in spy] == [not finetune] * 2


def test_plain_version_is_the_links_arithmetic():
    """``batch_norm_act_plain`` is the link's plain training path, ReLU and
    the residual included: output, gradients and running statistics
    bitwise, in bf16 and fp32."""
    for dtype in (torch.float32, torch.bfloat16):
        x = _x((4, 3, 3, 24), seed=2, dtype=dtype)
        s = _x((4, 3, 3, 24), seed=3, dtype=dtype)
        link = L.BatchNormalization(24, axis=(0, 1, 2), device="cpu")
        xs = [x.clone().requires_grad_() for _ in range(2)]
        y_link = link(xs[0], relu=True, residual=s)
        gamma = link.gamma.detach().clone().requires_grad_()
        beta = link.beta.detach().clone().requires_grad_()
        am, av = torch.zeros(24), torch.ones(24)
        y, mean, var = bn.batch_norm_act_plain(xs[1], gamma, beta, am, av,
                                               relu=True, residual=s)
        assert torch.equal(y, y_link) and y.dtype == dtype
        want_mean, want_var = F.batch_moments(x, (0, 1, 2))
        assert torch.equal(mean, want_mean) and torch.equal(var, want_var)
        assert torch.equal(am, link.avg_mean) and torch.equal(av,
                                                              link.avg_var)
        dy = _x(tuple(x.shape), seed=4, dtype=dtype)
        y_link.backward(dy)
        y.backward(dy)
        assert torch.equal(xs[0].grad, xs[1].grad)
        assert torch.equal(gamma.grad, link.gamma.grad)
        assert torch.equal(beta.grad, link.beta.grad)


def test_residual_needs_the_relu():
    link = L.BatchNormalization(8, axis=(0, 1, 2), device="cpu")
    x = _x((2, 2, 2, 8))
    with pytest.raises(ValueError, match="relu"):
        link(x, residual=x)
    with pytest.raises(ValueError, match="relu"):
        bn.batch_norm_act(x, torch.ones(8), torch.zeros(8), residual=x)


def test_kernel_launchers_raise_for_cpu_tensors():
    """The kernels' entry takes CUDA tensors only: a CPU call raises and
    counts nothing (CPU tensors take the plain arithmetic in the link)."""
    x = _x((4, 8))
    f0, b0 = bn.batch_norm_act_fwd.launches, bn.batch_norm_act_bwd.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        bn.batch_norm_act(x, torch.ones(8), torch.zeros(8))
    assert (bn.batch_norm_act_fwd.launches,
            bn.batch_norm_act_bwd.launches) == (f0, b0)
    assert bn._refusal(x, torch.ones(8), torch.zeros(8), None, None, None)


def _refused(what):
    """A call the kernels cannot take, and the reason's words."""
    x, ones, zeros = _x((4, 3, 3, 16)), torch.ones(16), torch.zeros(16)
    return {
        "fp16": ((x.half(), ones, zeros, None, None, None), "float16"),
        "fp64": ((x.double(), ones, zeros, None, None, None), "float64"),
        "channels": ((_x((4, 3, 3, 12)), torch.ones(12), torch.zeros(12),
                      None, None, None), "multiple of 8"),
        "one_axis": ((_x((16,)), ones, zeros, None, None, None), "shape"),
        "empty": ((x[:0], ones, zeros, None, None, None), "shape"),
        "gamma": ((x, ones.double(), zeros, None, None, None), "gamma"),
        "beta": ((x, ones, torch.zeros(8), None, None, None), "beta"),
        "one_running": ((x, ones, zeros, torch.zeros(16), None, None),
                        "together"),
        "running": ((x, ones, zeros, torch.zeros(32)[::2], torch.ones(16),
                     None), "contiguous"),
        "residual": ((x, ones, zeros, None, None, x.bfloat16()),
                     "residual"),
    }[what]


@pytest.mark.parametrize("what", ["fp16", "fp64", "channels", "one_axis",
                                  "empty", "gamma", "beta", "one_running",
                                  "running", "residual"])
def test_kernel_entry_names_what_it_refuses(what):
    """Each call the kernels cannot take is refused for its own reason,
    before the device is looked at."""
    args, words = _refused(what)
    why = bn._refusal(*args)
    assert why and words in why and "CUDA" not in why
    with pytest.raises(ValueError, match=words):
        bn.batch_norm_act(*args[:5], relu=args[5] is not None,
                          residual=args[5])


@pytest.mark.parametrize("what", ["fp16", "channels"])
def test_channels_last_training_the_kernels_refuse_raises(as_on_the_card,
                                                          what):
    """A training call the link sends to the kernels, which they cannot
    take (fp16, channels no multiple of 8), raises: it never gives way to
    the plain arithmetic unseen."""
    x = _x((4, 3, 3, 12 if what == "channels" else 16))
    if what == "fp16":
        x = x.half()
    link = L.BatchNormalization(x.shape[-1], axis=(0, 1, 2), device="cpu")
    with pytest.raises(ValueError, match="cannot take"):
        link(x)


def test_dense_copies_strided_and_misaligned_inputs():
    """The entry's copy: a contiguous, 16-byte aligned tensor is passed
    as it is; a strided view or one 4 bytes off alignment is copied
    contiguous and aligned, equal in value and differentiable."""
    x = _x((4, 6, 6, 16)).requires_grad_()
    assert bn._dense(x) is x
    strided = x[:, ::2]
    shifted = x.reshape(-1)[1:65].reshape(4, 16)
    assert not strided.is_contiguous()
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    for view in (strided, shifted):
        d = bn._dense(view)
        assert d is not view and d.is_contiguous()
        assert d.data_ptr() % 16 == 0 and torch.equal(d, view)
        assert d.requires_grad


def test_fused_call_bumps_the_running_statistics_versions(monkeypatch):
    """The forward kernel moves the running statistics through raw
    pointers; the autograd Function bumps their versions as an in-place
    op would, so a graph that saved them before refuses its backward.
    (The launch is a stand-in here that writes through ``.data``, which
    bumps nothing.)"""
    C = 8
    x = _x((6, C))
    gamma, beta = torch.ones(C), torch.zeros(C)
    am, av = torch.zeros(C), torch.ones(C)

    def launch(x, gamma, beta, avg_mean, avg_var, eps, decay, relu,
               residual):
        y, mean, var = bn.batch_norm_act_plain(x, gamma, beta, eps=eps,
                                               relu=relu, residual=residual)
        if avg_mean is not None:
            avg_mean.data.mul_(decay).add_((1 - decay) * mean)
            avg_var.data.mul_(decay).add_((1 - decay) * var)
        return y.detach(), torch.stack([mean, var, mean, var])

    monkeypatch.setattr(bn, "batch_norm_act_fwd", launch)
    w = torch.ones(C, requires_grad=True)
    saved = (w * am).sum()          # the product saves am for w's gradient
    versions = (am._version, av._version)
    bn._BatchNormAct.apply(x, gamma, beta, None, am, av, 2e-5, 0.9, True)
    assert (am._version, av._version) == (versions[0] + 1, versions[1] + 1)
    with pytest.raises(RuntimeError, match="inplace"):
        saved.backward()
    # without running statistics nothing is bumped
    bn._BatchNormAct.apply(x, gamma, beta, None, None, None, 2e-5, 0.9,
                           False)
    assert (am._version, av._version) == (versions[0] + 1, versions[1] + 1)


def _old_block(block, x):
    """The residual blocks' forward before the fused call: the last
    ConvBN without its ReLU, then ``relu(h + s)``."""
    if isinstance(block, BottleneckBlock):
        h = block.c(block.b(block.a(x)), activate=False)
    else:
        h = block.b(block.a(x), activate=False)
    s = block.shortcut(x, activate=False) if block.project else x
    return F.relu(h + s)


def _conv_bn_old(link, x, s):
    return F.relu(link(x, activate=False) + s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("kind", ["convbn", "bottleneck", "basic",
                                  "bottleneck_identity"])
def test_residual_path_equals_the_old_composition(kind, layout, dtype):
    """``ConvBN(..., residual=s)`` and both residual blocks equal the
    composition they replace (``relu(bn(h) + s)``), on the CPU, bitwise:
    outputs, the input's and every parameter's gradient, and the running
    statistics."""
    def build():
        kw = dict(layout=layout, device="cpu")
        if kind == "convbn":
            return ConvBN(8, 16, 3, pad=1, seed=5, **kw)
        if kind == "bottleneck":
            return BottleneckBlock(8, 4, 16, stride=2, seed=5, **kw)
        if kind == "bottleneck_identity":
            return BottleneckBlock(16, 4, 16, seed=5, **kw)
        return BasicBlock(8, 16, stride=2, seed=5, **kw)

    c_in = 16 if kind == "bottleneck_identity" else 8
    shape = (3, 6, 6, c_in) if layout == "NHWC" else (3, c_in, 6, 6)
    x = _x(shape, seed=6, dtype=dtype)
    runs = []
    for old in (False, True):
        link = build()
        xl = x.clone().requires_grad_()
        if kind == "convbn":
            s = _x((3, 6, 6, 16) if layout == "NHWC" else (3, 16, 6, 6),
                   seed=7, dtype=dtype)
            y = _conv_bn_old(link, xl, s) if old else link(xl, residual=s)
        else:
            y = _old_block(link, xl) if old else link(xl)
        y.backward(_x(tuple(y.shape), seed=8, dtype=dtype))
        runs.append([y.detach(), xl.grad]
                    + [p.grad for _, p in link.namedparams()]
                    + [v for _, v in link.namedpersistent()])
    assert len(runs[0]) == len(runs[1])
    for a, b in zip(*runs):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("R,C", [(256 * 112 * 112, 64), (256 * 56 * 56, 256),
                                 (256 * 7 * 7, 2048), (4 * 112 * 112, 64),
                                 (429, 136), (50, 520), (7, 8), (3, 24),
                                 (1, 16)])
def test_kernel_grid_covers_every_row_and_channel(R, C):
    """The grid's row splits cover the rows exactly, at most two an SM,
    and its channel tiles cover the channels; a block is 256 threads of 8
    channels, at most 8 groups wide; at ResNet-50's shapes about two to
    four blocks an SM (rounding the rows a split may drop one)."""
    tx, splits, rps = bn._geometry(R, C)
    assert tx in (1, 2, 4, 8) and 8 * tx >= min(C, 64)
    assert 1 <= splits <= 2 * bn._SMS
    assert (splits - 1) * rps < R <= splits * rps
    tiles = -(-C // (8 * tx))
    assert (tiles - 1) * 8 * tx < C <= tiles * 8 * tx
    if R >= 256 * 49:
        assert 2 * bn._SMS - 1 <= tiles * splits <= 5 * bn._SMS
