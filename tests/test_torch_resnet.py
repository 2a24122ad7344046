"""The port's ResNet, MLP, Classifier and synthetic datasets against the
JAX package's, on the CPU.

The ResNet runs at one bottleneck block per stage (``ResNet([1, 1, 1,
1])``: the class fixes the widths 64-2048), 16 x 16 inputs, batch 8, fp32,
in both layouts (the same images, transposed).  Batch 8 keeps 8 samples
in every channel's batch statistics down to res5; the port's model starts
from a JAX ``save_npz`` snapshot taken after one training forward, so it
also carries running statistics that are not the initial zeros and ones.

ReLU and max pooling are kinks.  The two frameworks sum convolutions and
batch moments in other orders, and the one-pass variance amplifies that
difference, so in a whole-model run now and then a pre-activation that
lies within it of 0 has the other sign on the other side.  That element
then routes its cotangent differently, and the gradients of its channel
move by a sizeable share of their largest value
(``tools/resnet_kink_probe.py`` shows one case): a property of comparing
two fp32 implementations, not an error of either.  So the
gradients are compared stage by stage, each stage fed the JAX model's own
input to it, where they agree to float noise; the whole model is compared
by its losses, logits and running statistics (continuous in the data)
and, after 3 ``MomentumSGD`` steps, by its parameters with a tolerance
that admits a kink crossing.

Tolerances (fp32): logits and losses 1e-5, and each stage's outputs 1e-5
and gradients 1e-4, relative to the largest |reference| of each array
(other summation orders; batch normalization divides by batch stds);
after 3 steps of lr 0.01, running statistics within 1e-4 and parameters
within 1e-3 absolute (a kink crossing moves a channel's weights further by
lr times its gradient's difference).  Initial weights, snapshot values
and the datasets' arrays are compared bitwise.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chainermn_tpu.core import optimizer as JO
from chainermn_tpu.core.config import using_config as jusing_config
from chainermn_tpu.core.link import apply_state, bind_state, extract_state
from chainermn_tpu.dataset import datasets as JD
from chainermn_tpu.models import MLP as JMLP
from chainermn_tpu.models import Classifier as JClassifier
from chainermn_tpu.models import ResNet50 as JResNet50
from chainermn_tpu.models.resnet import ResNet as JResNet
from chainermn_tpu.models.resnet import normalize_input as jnormalize_input
from chainermn_tpu.nn import functions as JF
from chainermn_tpu.serializers.npz import DictionarySerializer, save_npz
from chainermn_tpu_torch.core.config import using_config
from chainermn_tpu_torch.core.optimizer import MomentumSGD
from chainermn_tpu_torch.dataset import (SerialIterator, TupleDataset,
                                         get_mnist, get_synthetic_imagenet)
from chainermn_tpu_torch.models import MLP, Classifier, ResNet, ResNet50
from chainermn_tpu_torch.models.resnet import (input_norm_consts,
                                               normalize_input)
from chainermn_tpu_torch.nn import functions as F
from chainermn_tpu_torch.serializers import load_npz, load_params
from chainermn_tpu_torch.training import StandardUpdater, Trainer

BLOCKS = [1, 1, 1, 1]
N_CLASSES = 10
BATCH, SIZE = 8, 16
STEPS = 3
SGD = dict(lr=0.01, momentum=0.9)
RTOL = 1e-5
RTOL_GRAD = 1e-4
ATOL_STATS = 1e-4
ATOL_PARAMS = 1e-3


def _batch(layout, seed, n=BATCH):
    """n NCHW images (transposed to NHWC for that layout) and labels."""
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (n, 3, SIZE, SIZE)).astype(np.float32)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return x, rng.randint(0, N_CLASSES, n).astype(np.int32)


def _close(got, want, rtol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, \
        np.abs(got - want).max() / scale


def _state(model):
    """Parameters and persistent values by path, as host arrays."""
    out = {p: v.detach().numpy().copy() for p, v in model.namedparams()}
    out.update((p, v.numpy().copy()) for p, v in model.namedpersistent())
    return out


def _jax_state(model):
    out = {p: np.asarray(v.array) for p, v in model.namedparams()}
    out.update((p, np.asarray(v)) for p, v in model.namedpersistent())
    return out


def _jax_snapshot(path, layout):
    """A JAX classifier after one training forward (its running statistics
    moved), saved with ``save_npz``."""
    jmodel = JClassifier(JResNet(BLOCKS, n_classes=N_CLASSES, seed=0,
                                 layout=layout))
    jmodel.predictor(jnp.asarray(_batch(layout, 5)[0]))
    save_npz(path, jmodel)
    return jmodel


def _jax_loss_and_grads(jmodel, x, t):
    state = extract_state(jmodel)

    def loss(params):
        out, _ = apply_state(jmodel, {"params": params,
                                      "state": state["state"]},
                             jnp.asarray(x), jnp.asarray(t))
        return out

    return jax.jit(jax.value_and_grad(loss))(state["params"])


def _stages(layout):
    """(name, port forward, JAX forward) of each stage, on the predictor:
    the stem (conv1 and the max pool), the four stages, and the head
    (global pooling and fc)."""
    def stem(F):
        return lambda m, h: F.max_pooling_2d(m.conv1(h), 3, stride=2, pad=1,
                                             cover_all=False, layout=layout)

    def stage(name):
        return lambda m, h: getattr(m, name)(h)

    def head(F, f32):
        return lambda m, h: m.fc(f32(F.global_average_pooling_2d(
            h, layout=layout)))

    return ([("stem", stem(F), stem(JF))]
            + [(n, stage(n), stage(n))
               for n in ("res2", "res3", "res4", "res5")]
            + [("head", head(F, lambda h: h.float()),
                head(JF, lambda h: h.astype(jnp.float32)))])


def _jax_vjp(jmodel, fn, h, g):
    """JAX's output of ``fn(jmodel, h)`` and the gradients of
    ``sum(output * g)`` in its parameters and ``h``."""
    state = extract_state(jmodel)

    def f(params, h):
        with bind_state(jmodel, {"params": params, "state": state["state"]}):
            out = fn(jmodel, h)
        return (out * g).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1),
                                                has_aux=True))(
        state["params"], h)
    return out, grads


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_resnet_stages_match_jax(tmp_path, layout):
    """Each stage in train mode, fed the JAX model's input to it: its
    output, its parameters' gradients and its input's gradient."""
    npz = str(tmp_path / "resnet.npz")
    jmodel = _jax_snapshot(npz, layout).predictor
    model = load_npz(npz, Classifier(ResNet(
        BLOCKS, n_classes=N_CLASSES, seed=1, layout=layout,
        device="cpu"))).predictor
    h = jnp.asarray(_batch(layout, 0)[0])
    rng = np.random.RandomState(1)
    for name, fn, jfn in _stages(layout):
        x = torch.from_numpy(np.array(h)).requires_grad_()
        model.cleargrads()
        out = fn(model, x)
        g = rng.normal(0, 1, tuple(out.shape)).astype(np.float32)
        (out * torch.from_numpy(g)).sum().backward()
        want, (jgrads, jgh) = _jax_vjp(jmodel, jfn, h, jnp.asarray(g))
        _close(out, want, RTOL)
        _close(x.grad, jgh, RTOL_GRAD)
        grads = {p: v.grad for p, v in model.namedparams()
                 if v.grad is not None}
        assert grads and set(grads) <= set(jgrads), name
        for p, v in grads.items():
            _close(v, jgrads[p], RTOL_GRAD)
        h = want   # the JAX stage's output feeds the next stage


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_resnet_from_a_jax_snapshot_matches_jax(tmp_path, layout):
    npz = str(tmp_path / "resnet.npz")
    jmodel = _jax_snapshot(npz, layout)
    model = Classifier(ResNet(BLOCKS, n_classes=N_CLASSES, seed=1,
                              layout=layout, device="cpu"))
    load_npz(npz, model)
    want = _jax_state(jmodel)
    got = _state(model)
    assert sorted(got) == sorted(want)
    for p in want:
        assert np.array_equal(got[p], want[p]), p
    assert not np.array_equal(got["/predictor/conv1/bn/avg_mean"],
                              np.zeros(64, np.float32))
    # the port writes what the JAX package wrote
    s = DictionarySerializer()
    model.serialize(s)
    with np.load(npz) as f:
        assert sorted(s.target) == sorted(f.files)
        for key in f.files:
            assert np.array_equal(np.asarray(s.target[key]), f[key]), key

    # evaluation normalizes with the snapshot's running statistics, and
    # leaves them as they were
    x, _ = _batch(layout, 20)
    with using_config("train", False), jusing_config("train", False):
        logits = model.predictor(torch.from_numpy(x))
        jlogits = jmodel.predictor(jnp.asarray(x))
    _close(logits, jlogits, RTOL)
    assert all(np.array_equal(v, got[p]) for p, v in _state(model).items())

    # 3 MomentumSGD steps: losses, running statistics and parameters
    opt = MomentumSGD(**SGD).setup(model)
    jopt = JO.MomentumSGD(**SGD).setup(jmodel)
    for step in range(STEPS):
        x, t = _batch(layout, 10 + step)
        loss = opt.update(model, torch.from_numpy(x), torch.from_numpy(t))
        jloss = jopt.update(jmodel, jnp.asarray(x), jnp.asarray(t))
        _close(loss, jloss, RTOL)
    got, want = _state(model), _jax_state(jmodel)
    for p in want:
        atol = ATOL_STATS if p.rsplit("/", 1)[1] in ("avg_mean", "avg_var",
                                                      "N") else ATOL_PARAMS
        np.testing.assert_allclose(got[p], want[p], rtol=0, atol=atol,
                                   err_msg=p)
    assert int(got["/predictor/res5/0/c/bn/N"]) == 0



def test_snapshot_paths_are_strict(tmp_path):
    """A snapshot without a running statistic, or with one too many,
    does not load."""
    model = Classifier(ResNet(BLOCKS, n_classes=N_CLASSES, device="cpu"))
    full = _state(model)
    for params in ({p: v for p, v in full.items()
                    if p != "/predictor/res3/0/b/bn/avg_var"},
                   {**full, "/predictor/extra/avg_mean": np.zeros(3)}):
        with pytest.raises(KeyError):
            load_params(model, params)


def test_imagenet_input_norm_on_uint8(tmp_path):
    """uint8 pixels standardized on the device: the fp32 multiply-add,
    then one cast; the whole model as the JAX one."""
    x = np.random.RandomState(3).randint(0, 256, (BATCH, SIZE, SIZE, 3),
                                         dtype=np.uint8)
    consts = input_norm_consts("imagenet")
    for dtype, jdtype in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        got = normalize_input(torch.from_numpy(x), consts, "NHWC", dtype)
        want = jnormalize_input(jnp.asarray(x), consts, "NHWC", jdtype)
        assert got.dtype == (dtype or torch.float32)
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    npz = str(tmp_path / "norm.npz")
    jmodel = JClassifier(JResNet(BLOCKS, n_classes=N_CLASSES, seed=0,
                                 layout="NHWC", input_norm="imagenet"))
    save_npz(npz, jmodel)
    model = load_npz(npz, Classifier(ResNet(
        BLOCKS, n_classes=N_CLASSES, layout="NHWC", input_norm="imagenet",
        device="cpu")))
    t = np.arange(BATCH, dtype=np.int32)
    jloss, _ = _jax_loss_and_grads(jmodel, x, t)
    _close(model(torch.from_numpy(x), torch.from_numpy(t)), jloss, RTOL)


def test_resnet50_has_the_jax_paths_shapes_and_weights():
    model = ResNet50(seed=0, layout="NHWC", device="cpu")
    jmodel = JResNet50(seed=0, layout="NHWC")
    got, want = _state(model), _jax_state(jmodel)
    assert sorted(got) == sorted(want)
    for p in want:
        assert got[p].shape == want[p].shape, p
        assert np.array_equal(got[p], want[p]), p
    assert model.count_params() == jmodel.count_params() == 25_557_032
    floats = sum(v.numel() for _, v in model.namedpersistent()
                 if v.is_floating_point())
    assert floats == 2 * 26_560


def test_remat_is_refused():
    """No longer refused: ``remat=True`` checkpoints each stage, its
    running statistics moved once a step (the comparisons with
    ``remat=False`` are in ``tests/test_torch_resnet_remat.py``)."""
    model = ResNet50(remat=True, device="cpu")
    assert model.remat is True


def test_classifier_mlp_with_lazy_links_matches_jax():
    """``Classifier(MLP)``, whose three ``Linear``s learn their input size
    from the first batch, through ``Trainer`` -> ``StandardUpdater`` ->
    ``MomentumSGD`` on ``get_mnist(ndim=1)``: the JAX trajectory."""
    train, _ = get_mnist(ndim=1, n_train=96, n_test=8)
    model = Classifier(MLP(n_units=50, seed=0, device="cpu"))
    opt = MomentumSGD(**SGD).setup(model)
    trainer = Trainer(StandardUpdater(SerialIterator(train, 32,
                                                     shuffle=False), opt),
                      (STEPS, "iteration"))
    losses = []
    trainer.extend(lambda tr: losses.append(
        (float(tr.observation["main/loss"]),
         float(tr.observation["main/accuracy"]))), name="record")
    trainer.run()
    jtrain, _ = JD.get_mnist(ndim=1, n_train=96, n_test=8)
    jmodel = JClassifier(JMLP(n_units=50, seed=0))
    jopt = JO.MomentumSGD(**SGD).setup(jmodel)
    jlosses = []
    for step in range(STEPS):
        x, t = (np.stack(a) for a in zip(*jtrain[32 * step:32 * (step + 1)]))
        jlosses.append(float(jopt.update(jmodel, jnp.asarray(x),
                                         jnp.asarray(t))))
    np.testing.assert_allclose([loss for loss, _ in losses], jlosses,
                               rtol=RTOL)
    assert all(0 <= acc <= 1 for _, acc in losses)
    got, want = _state(model), _jax_state(jmodel)
    assert sorted(got) == sorted(want)
    assert got["/predictor/l1/W"].shape == (50, 784)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=0, atol=ATOL_STATS,
                                   err_msg=p)


def test_synthetic_datasets_equal_the_jax_arrays():
    for dtype in ("float32", "uint8"):
        got = get_synthetic_imagenet(n=6, size=16, seed=4, dtype=dtype)
        want = JD.get_synthetic_imagenet(n=6, size=16, seed=4, dtype=dtype)
        assert len(got) == len(want) == 6
        for a, b in zip(got._datasets, want._datasets):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for ndim in (1, 3):
        got = get_mnist(ndim=ndim, n_train=40, n_test=10)
        want = JD.get_mnist(ndim=ndim, n_train=40, n_test=10)
        for g, w in zip(got, want):
            for a, b in zip(g._datasets, w._datasets):
                assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(get_mnist(withlabel=False, n_train=5, n_test=2)[0],
                          JD.get_mnist(withlabel=False, n_train=5,
                                       n_test=2)[0])
    x, y = np.arange(10).reshape(5, 2), np.arange(5) * 10
    got, want = TupleDataset(x, y), JD.TupleDataset(x, y)
    for index in (2, slice(1, 4), [0, 3], np.array([4, 1])):
        g, w = got[index], want[index]
        assert type(g) is type(w) and len(g) == len(w)
        if isinstance(index, int):
            g, w = [g], [w]
        for a, b in zip(g, w):
            assert all(np.array_equal(u, v) for u, v in zip(a, b))
    with pytest.raises(ValueError):
        TupleDataset(x, y[:3])
