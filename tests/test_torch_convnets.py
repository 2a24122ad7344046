"""The port's convnets and the functions they call against the JAX
package's, on the CPU.

``F.dropout``, ``F.local_response_normalization``, ``F.concat`` and the
pooling settings of AlexNet, NIN, VGG16 and GoogLeNet against the JAX
functions; each arch built from the JAX model's weights through an npz
(10 classes, batch 2, the smallest inputs the archs take), its logits and
parameter gradients under ``train=False`` (dropout the identity) against
``jax.grad``; GoogLeNet's auxiliary heads and loss; one ``MomentumSGD`` +
``WeightDecay`` step of NIN (no dropout) in training mode; and the
per-step randomness of ``core.rng``: masks new each step, different per
rank, reproducible from the seed and across a resume.  The masks are not
compared with JAX's: another generator draws them.

Tolerances (fp32; the two frameworks sum convolutions in other orders):
functions 1e-5 relative to the largest |reference|, model logits 1e-5
and gradients 1e-4 relative to each array's largest |reference| (a
gradient sums over the batch and the spatial positions; max pooling
routes it by an argmax that a last-bit difference could move, which
these inputs do not trigger); NIN's parameters after one step 1e-5
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.core import optimizer as JO
from chainermn_tpu.core.config import using_config as jusing_config
from chainermn_tpu.core.link import bind_state, extract_state
from chainermn_tpu.models import AlexNet as JAlexNet
from chainermn_tpu.models import Classifier as JClassifier
from chainermn_tpu.models import GoogLeNet as JGoogLeNet
from chainermn_tpu.models import NIN as JNIN
from chainermn_tpu.models import VGG16 as JVGG16
from chainermn_tpu.nn import functions as JF
from chainermn_tpu.serializers.npz import save_npz
from chainermn_tpu_torch import create_multi_node_optimizer
from chainermn_tpu_torch.communicators import DummyCommunicator
from chainermn_tpu_torch.core import rng
from chainermn_tpu_torch.core.config import using_config
from chainermn_tpu_torch.core.link import Chain
from chainermn_tpu_torch.core.optimizer import SGD, MomentumSGD, WeightDecay
from chainermn_tpu_torch.models import NIN, VGG16, AlexNet, Classifier, GoogLeNet
from chainermn_tpu_torch.nn import functions as F
from chainermn_tpu_torch.nn import links as L
from chainermn_tpu_torch.serializers import load_npz
from chainermn_tpu_torch.serializers.npz import (DictionarySerializer,
                                                 NpzDeserializer)

RTOL_F, RTOL, RTOL_GRAD = 1e-5, 1e-5, 1e-4
ARCHS = {"alex": (AlexNet, JAlexNet, 67), "nin": (NIN, JNIN, 67),
         "vgg16": (VGG16, JVGG16, 32), "googlenet": (GoogLeNet, JGoogLeNet,
                                                     64)}


def _close(got, want, rtol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, err


def _grad_pair(fn, jfn, x, g):
    """(port output, its input gradient) and JAX's, for the cotangent g."""
    xt = torch.from_numpy(x).requires_grad_()
    out = fn(xt)
    (out * torch.from_numpy(g)).sum().backward()
    jout, vjp = jax.vjp(jfn, jnp.asarray(x))
    (jgx,) = vjp(jnp.asarray(g))
    return out, xt.grad, jout, jgx


# -- functions ---------------------------------------------------------------

def test_dropout_identity_cases():
    x = torch.randn(4, 5)
    assert F.dropout(x, train=False) is x
    assert F.dropout(x, ratio=0.0) is x
    with using_config("train", False):
        assert F.dropout(x) is x


def test_dropout_keep_rate_scale_and_gradient():
    ratio, n = 0.3, 200_000
    keep = 1 - ratio
    x = torch.ones(n, requires_grad=True)
    y = F.dropout(x, ratio, key=torch.Generator().manual_seed(0))
    kept = (y != 0).double().mean().item()
    sigma = (keep * ratio / n) ** 0.5
    assert abs(kept - keep) < 5 * sigma
    # the kept values: x / keep in x's dtype, as the JAX function's
    jy = np.asarray(JF.dropout(jnp.ones(16), ratio,
                               key=jax.random.PRNGKey(0), train=True))
    assert set(y[y != 0].tolist()) == set(jy[jy != 0].tolist())
    g = torch.randn(n)
    y.backward(g)
    want = torch.where(y != 0, g / keep, torch.zeros(()))
    assert torch.equal(x.grad, want)
    assert F.dropout(x.detach().bfloat16(), ratio).dtype == torch.bfloat16


@pytest.mark.parametrize("n", [5, 4, 3])
def test_local_response_normalization_matches_jax(n):
    """At the channel edges the window is zero-padded; ``alpha``
    multiplies the sum (torch's local_response_norm averages: it differs,
    so the port does not call it)."""
    rng_ = np.random.RandomState(n)
    x = rng_.normal(0, 3, (2, 7, 3, 4)).astype(np.float32)
    g = rng_.normal(0, 1, x.shape).astype(np.float32)
    kw = dict(n=n, k=2.0, alpha=1e-2, beta=0.75)
    out, gx, jout, jgx = _grad_pair(
        lambda a: F.local_response_normalization(a, **kw),
        lambda a: JF.local_response_normalization(a, **kw), x, g)
    _close(out, jout, RTOL_F)
    _close(gx, jgx, RTOL_F)
    torch_avg = torch.nn.functional.local_response_norm(
        torch.from_numpy(x), n, alpha=1e-2, beta=0.75, k=2.0)
    assert not torch.allclose(torch_avg, out.detach(), rtol=1e-3)


def test_concat_matches_jax():
    rng_ = np.random.RandomState(0)
    xs = [rng_.normal(0, 1, (2, c, 3, 3)).astype(np.float32)
          for c in (1, 4, 2)]
    got = F.concat([torch.from_numpy(a) for a in xs], axis=1)
    assert np.array_equal(got.numpy(),
                          np.asarray(JF.concat([jnp.asarray(a) for a in xs],
                                               axis=1)))


POOLS = {   # the convnets' settings: (function, args, kwargs)
    "alex_nin_3_2_cover_all": ("max", (3,), dict(stride=2)),
    "googlenet_3_1_pad_1": ("max", (3,), dict(stride=1, pad=1,
                                              cover_all=False)),
    "googlenet_3_2_pad_1": ("max", (3,), dict(stride=2, pad=1,
                                              cover_all=False)),
    "vgg_2_2": ("max", (2,), dict(stride=2, cover_all=False)),
    "aux_avg_5_3": ("avg", (5,), dict(stride=3)),
}


@pytest.mark.parametrize("name", sorted(POOLS))
@pytest.mark.parametrize("hw", [(13, 13), (14, 11)])
def test_pooling_matches_jax(name, hw):
    kind, args, kw = POOLS[name]
    fn = F.max_pooling_2d if kind == "max" else F.average_pooling_2d
    jfn = JF.max_pooling_2d if kind == "max" else JF.average_pooling_2d
    rng_ = np.random.RandomState(1)
    # distinct values: no tie for the first-maximum rule to break
    x = rng_.permutation(2 * 3 * hw[0] * hw[1]).astype(np.float32) \
        .reshape(2, 3, *hw) / 7.0
    out0 = fn(torch.from_numpy(x), *args, **kw)
    g = rng_.normal(0, 1, tuple(out0.shape)).astype(np.float32)
    out, gx, jout, jgx = _grad_pair(lambda a: fn(a, *args, **kw),
                                    lambda a: jfn(a, *args, **kw), x, g)
    _close(out, jout, RTOL_F)
    _close(gx, jgx, RTOL_F)


# -- the models --------------------------------------------------------------

def _batch(size, seed=0, n=2):
    r = np.random.RandomState(seed)
    return (r.normal(0, 1, (n, 3, size, size)).astype(np.float32),
            r.randint(0, 10, n).astype(np.int32))


def _pair(arch, tmp_path):
    """The JAX Classifier and the port's, loaded from the JAX model's
    npz.  The JAX model's lazy ``Linear(None, out)`` layers are made by
    their own ``_init_params`` at the input sizes a port forward finds
    (an eager JAX forward would take seconds of per-op compiles)."""
    cls, jcls, size = ARCHS[arch]
    jmodel = JClassifier(jcls(n_classes=10, seed=0))
    probe = Classifier(cls(n_classes=10, seed=0, device="cpu"))
    x, _ = _batch(size, seed=9)
    with using_config("train", False), torch.no_grad():
        probe.predictor(torch.from_numpy(x))
        if arch == "googlenet":
            probe.predictor.forward_with_aux(torch.from_numpy(x))
    jlinks = dict(jmodel.namedlinks())
    for path, link in probe.namedlinks():
        if isinstance(link, L.Linear) and jlinks[path].W.array is None:
            jlinks[path]._init_params(link.in_size)
    npz = str(tmp_path / f"{arch}.npz")
    save_npz(npz, jmodel, compression=False)
    with torch.no_grad():   # every weight must come from the file
        for p in probe.parameters():
            p.fill_(float("nan"))
    return jmodel, load_npz(npz, probe), size


def _jax_call(jmodel, fn, grad=False):
    """``fn(jmodel)`` jitted over the model's parameters; with ``grad``,
    ``(value, gradients)`` of its first output."""
    state = extract_state(jmodel)

    def call(params):
        with bind_state(jmodel, {"params": params, "state": state["state"]}):
            out = fn(jmodel)
        return (out[0], out) if grad else out

    if grad:
        return jax.jit(jax.value_and_grad(call, has_aux=True))(
            state["params"])
    return jax.jit(call)(state["params"])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_arch_matches_jax_under_eval(arch, tmp_path):
    jmodel, model, size = _pair(arch, tmp_path)
    x, t = _batch(size)
    with using_config("train", False), jusing_config("train", False):
        logits = model.predictor(torch.from_numpy(x))
        loss = F.softmax_cross_entropy(logits, torch.from_numpy(t))
        loss.backward()

        def jloss(m):
            y = m.predictor(jnp.asarray(x))
            return JF.softmax_cross_entropy(y, jnp.asarray(t)), y

        (_, (jl, jlogits)), jgrads = _jax_call(jmodel, jloss, grad=True)
    _close(logits, jlogits, RTOL)
    assert abs(loss.item() - float(jl)) <= RTOL * abs(float(jl))
    grads = {p: v.grad for p, v in model.namedparams() if v.grad is not None}
    assert grads and set(grads) <= set(jgrads)
    for p, g in grads.items():
        _close(g, jgrads[p], RTOL_GRAD)
    # what takes no gradient is the aux heads' (not on the main path)
    assert all(p.startswith("/predictor/aux")
               for p in set(jgrads) - set(grads))


def test_googlenet_aux_heads_match_jax(tmp_path):
    jmodel, model, size = _pair("googlenet", tmp_path)
    net = model.predictor
    x, t = _batch(size, seed=4)
    with using_config("train", False), jusing_config("train", False):
        got = net.forward_with_aux(torch.from_numpy(x))
        want = _jax_call(jmodel, lambda m: (
            m.predictor.forward_with_aux(jnp.asarray(x)),
            m.predictor.loss(jnp.asarray(x), jnp.asarray(t))))
        for a, b in zip(got, want[0]):
            _close(a, b, RTOL)
        eval_loss = net.loss(torch.from_numpy(x), torch.from_numpy(t))
        main_only = F.softmax_cross_entropy(got[0], torch.from_numpy(t))
        assert eval_loss.item() == main_only.item()
    jl = float(want[1])
    assert abs(eval_loss.item() - jl) <= RTOL * abs(jl)
    # in training the aux terms join with weight 0.3 (dropout live)
    train_loss = net.loss(torch.from_numpy(x), torch.from_numpy(t))
    assert np.isfinite(train_loss.item())
    assert train_loss.item() != eval_loss.item()


def test_nin_momentum_sgd_step_matches_jax(tmp_path):
    """NIN has no dropout: one training step is deterministic."""
    jmodel, model, size = _pair("nin", tmp_path)
    x, t = _batch(size, seed=5)
    opt = MomentumSGD(lr=0.01, momentum=0.9).setup(model)
    opt.add_hook(WeightDecay(1e-4))
    jopt = JO.MomentumSGD(lr=0.01, momentum=0.9).setup(jmodel)
    jopt.add_hook(JO.WeightDecay(1e-4))
    for step in range(2):
        xb, tb = _batch(size, seed=5 + step)
        loss = opt.update(model, torch.from_numpy(xb), torch.from_numpy(tb))
        jloss = jopt.update(jmodel, jnp.asarray(xb), jnp.asarray(tb))
        assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = {p: np.asarray(v.array) for p, v in jmodel.namedparams()}
    for p, v in model.namedparams():
        _close(v, want[p], 1e-5)


# -- per-step randomness -------------------------------------------------------

class _Dropper(Chain):
    def __init__(self):
        super().__init__()
        self.l1 = L.Linear(8, 64, seed=0, device="cpu")

    def forward(self, x, t):
        h = F.dropout(self.l1(x), 0.5)
        return F.softmax_cross_entropy(h, t)


def _xt():
    r = np.random.RandomState(2)
    return (torch.from_numpy(r.normal(0, 1, (16, 8)).astype(np.float32)),
            torch.from_numpy(r.randint(0, 64, 16)))


def _losses(opt, model, steps):
    x, t = _xt()
    return [opt.update(model, x, t).item() for _ in range(steps)]


def _seeded(seed=0, comm=None):
    model = _Dropper()
    opt = SGD(lr=0.1)
    opt.seed = seed
    if comm is not None:
        opt = create_multi_node_optimizer(opt, comm)
    return opt.setup(model), model


def test_keys_split_fold_and_load():
    key = rng.make_key(7)
    assert key.dtype == np.uint32 and key.tolist() == [0, 7]
    assert np.array_equal(np.asarray(jax.random.PRNGKey(7)), key)
    a, b = rng.split(key)
    assert not np.array_equal(a, b) and np.array_equal(rng.split(key)[1], b)
    assert not np.array_equal(rng.fold_in(key, 0), rng.fold_in(key, 1))
    g1 = rng.generator(b, "cpu")
    g2 = rng.generator(b, "cpu")
    assert torch.equal(torch.rand(5, generator=g1),
                       torch.rand(5, generator=g2))
    assert rng.next_key() is None
    with rng.key_scope(b):
        first = rng.next_key()
        assert rng.next_key() is first   # one generator for the scope
    assert rng.next_key() is None


def test_masks_are_new_each_step_and_reproducible_from_the_seed():
    opt, model = _seeded(0)
    losses = _losses(opt, model, 3)
    opt2, model2 = _seeded(0)
    assert _losses(opt2, model2, 3) == losses
    # new masks each step: an SGD of lr 0 leaves the weights, not the loss
    opt3, model3 = _seeded(0)
    opt3.lr = 0.0
    still = _losses(opt3, model3, 3)
    assert len(set(still)) == 3
    opt4, model4 = _seeded(1)
    opt4.lr = 0.0
    assert _losses(opt4, model4, 1)[0] != still[0]


def test_each_rank_draws_its_own_masks():
    class Rank1(DummyCommunicator):
        rank = property(lambda self: 1)

    losses = {}
    for name, comm in (("0", DummyCommunicator()), ("1", Rank1())):
        opt, model = _seeded(0, comm)
        opt.lr = 0.0
        losses[name] = _losses(opt, model, 2)
    assert losses["0"] != losses["1"]
    opt, model = _seeded(0, DummyCommunicator())
    opt.lr = 0.0
    assert _losses(opt, model, 2) == losses["0"]


def test_a_resumed_run_draws_the_uninterrupted_masks():
    opt, model = _seeded(3)
    whole = _losses(opt, model, 4)
    opt, model = _seeded(3)
    first = _losses(opt, model, 2)
    s = DictionarySerializer()
    opt.serialize(s)
    assert s.target["rng_key"].dtype == np.uint32
    opt2, model2 = _seeded(99)   # the snapshot's key wins over the seed
    opt2.serialize(NpzDeserializer(s.target))
    assert first + _losses(opt2, model2, 2) == whole
