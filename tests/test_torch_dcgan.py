"""The port's DCGAN (functions, ``Deconvolution2D``, ``Generator``,
``Discriminator``, ``DCGANUpdater``) against the JAX package's.

The same inputs, made with numpy from a seed, go through both packages:
the functions and their ``jax.grad``; the links' seeded weights; the
models on weights a JAX model saved (``serializers.npz``); one and three
updater iterations from shared weights with the same noise ``z`` injected
on both sides (threefry's draws cannot be reproduced by the port's
generator); and a 2-rank gloo data-parallel run against the JAX
data-parallel updater over 2 of ``tests/conftest.py``'s CPU devices, each
rank taking its rows of the JAX global batch and ``z``.  The JAX package
is imported inside the tests only, so the spawned ranks never start JAX.

Tolerances, with their reasons:

* ``leaky_relu`` and ``deconvolution_2d``'s shape rule: bitwise (one
  select and one multiply per element; integer arithmetic);
* ``sigmoid_cross_entropy``: 1e-6 relative (``exp``/``log1p`` from two
  math libraries);
* ``deconvolution_2d``, the models and one iteration: 1e-5 absolute in
  fp32 (convolutions summed in another order);
* biases that feed a batch normalization (``NULL_BIASES``): their exact
  gradient is 0 (the normalization removes a per-channel constant), so
  what each framework computes is rounding noise, and Adam's first steps,
  ``m / (sqrt(v) + eps)``, turn noise into moves of up to ``alpha`` in
  either direction: band ``2 alpha`` per iteration;
* three iterations: the same sign-like first steps move any weight whose
  gradient is at the noise level by up to ``2 alpha`` the other way in
  one framework, and the generator's gradient, taken through the updated
  discriminator, inherits it: parameters 1e-4 absolute (measured 2.8e-5),
  Adam's moment estimates 5e-3 absolute (measured 1.2e-3, against
  moments up to 0.3), running statistics 5e-4 (they average the pre-norm
  biases in with weight 1 - decay); the losses, taken before each
  update, 1e-5 relative;
* the data-parallel run: the one-iteration tolerances (its mean gradient
  is summed in another order), the running statistics widened by the
  pre-norm biases' band times 1 - decay; the two ranks against each
  other, bitwise.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_communicator import spawn_ranks

NH, CH, B = 16, 32, 8
ALPHA, BETA1 = 2e-4, 0.5
TOL = dict(rtol=0, atol=1e-5)
LOSS_RTOL = 1e-5
#: biases ahead of a batch normalization (gradient exactly 0)
NULL_BIASES = ("gen/target/l0/b", "gen/target/dc1/b", "gen/target/dc2/b",
               "gen/target/dc3/b", "dis/target/c1/b", "dis/target/c2/b")
TRAJ_STEPS = 3
TRAJ_TOL = {"param": 1e-4, "moment": 5e-3, "stat": 5e-4}
WORLD = 2


def _rng(seed=0):
    return np.random.RandomState(seed)


def _data(n, seed=0):
    return _rng(seed).normal(0, 0.5, (n, 3, 32, 32)).astype(np.float32)


def _noise(steps, rows, seed=1):
    rng = _rng(seed)
    return [rng.normal(0, 1, (rows, NH)).astype(np.float32)
            for _ in range(steps)]


# -- functions ----------------------------------------------------------------

@pytest.mark.parametrize("slope", [0.2, 0.5])
def test_leaky_relu_equals_jax_with_gradient_one_at_zero(slope):
    import jax
    import jax.numpy as jnp
    from chainermn_tpu.nn import functions as JF
    from chainermn_tpu_torch.nn import functions as TF
    x = _rng(0).normal(0, 1, (4, 6)).astype(np.float32)
    x[0, :3] = 0.0
    w = _rng(1).normal(0, 1, x.shape).astype(np.float32)
    jy = JF.leaky_relu(jnp.asarray(x), slope)
    jg = jax.grad(lambda a: (JF.leaky_relu(a, slope) * w).sum())(
        jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    ty = TF.leaky_relu(tx, slope)
    (ty * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tx.grad.numpy()[0, :3], w[0, :3])


@pytest.mark.parametrize("reduce", ["mean", "no"])
def test_sigmoid_cross_entropy_equals_jax(reduce):
    import jax
    import jax.numpy as jnp
    from chainermn_tpu.nn import functions as JF
    from chainermn_tpu_torch.nn import functions as TF
    rng = _rng(2)
    x = rng.normal(0, 3, (8, 3)).astype(np.float32)
    x[0] = [0.0, 40.0, -40.0]
    t = rng.randint(0, 2, x.shape).astype(np.int32)
    w = rng.normal(0, 1, x.shape).astype(np.float32)

    def jloss(a):
        out = JF.sigmoid_cross_entropy(a, jnp.asarray(t), reduce=reduce)
        return (out * w).sum() if reduce == "no" else out

    tx = torch.tensor(x, requires_grad=True)
    out = TF.sigmoid_cross_entropy(tx, torch.from_numpy(t), reduce=reduce)
    (((out * torch.from_numpy(w)).sum()) if reduce == "no"
     else out).backward()
    want = JF.sigmoid_cross_entropy(jnp.asarray(x), jnp.asarray(t),
                                    reduce=reduce)
    assert out.shape == tuple(np.shape(want))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tx.grad.numpy(),
                               np.asarray(jax.grad(jloss)(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


#: (in, out, ksize, stride, pad, h, outsize): stride 1 and 2, pad 0 and
#: 1, outsizes that need output_padding (1, and (1, 2) at stride 3)
DECONV_CASES = [(3, 5, 3, 1, 0, 5, None), (3, 5, 3, 1, 1, 5, None),
                (4, 2, 4, 2, 1, 4, None), (4, 2, 4, 2, 0, 4, None),
                (4, 3, 3, 2, 1, 4, (8, 8)), (2, 3, 4, 2, 1, 4, (9, 9)),
                (2, 3, 4, 3, 1, 4, (12, 13))]


@pytest.mark.parametrize("case", DECONV_CASES)
@pytest.mark.parametrize("bias", [True, False])
def test_deconvolution_2d_equals_jax_with_gradients(case, bias):
    import jax
    import jax.numpy as jnp
    from chainermn_tpu.nn import functions as JF
    from chainermn_tpu_torch.nn import functions as TF
    cin, cout, k, s, p, h, outsize = case
    rng = _rng(3)
    x = rng.normal(0, 1, (2, cin, h, h + 1 if outsize is None else h)) \
        .astype(np.float32)
    W = rng.normal(0, 0.5, (cin, cout, k, k)).astype(np.float32)
    b = rng.normal(0, 0.5, (cout,)).astype(np.float32) if bias else None

    def jf(x_, W_, b_):
        return JF.deconvolution_2d(x_, W_, b_, stride=s, pad=p,
                                   outsize=outsize)

    jy = jf(jnp.asarray(x), jnp.asarray(W), None if b is None
            else jnp.asarray(b))
    g = rng.normal(0, 1, jy.shape).astype(np.float32)
    argnums = (0, 1, 2) if bias else (0, 1)
    jgrads = jax.grad(lambda *a: (jf(*a) * g).sum(), argnums=argnums)(
        jnp.asarray(x), jnp.asarray(W),
        None if b is None else jnp.asarray(b))
    tin = [torch.tensor(a, requires_grad=True) for a in (x, W, b)
           if a is not None]
    ty = TF.deconvolution_2d(tin[0], tin[1], tin[2] if bias else None,
                             stride=s, pad=p, outsize=outsize)
    assert tuple(ty.shape) == tuple(jy.shape)
    if outsize is not None:
        assert tuple(ty.shape[2:]) == tuple(outsize)
    (ty * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    for t, j in zip(tin, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("outsize", [(11, 11), (6, 6), (9, 7)])
def test_deconvolution_2d_refuses_what_jax_refuses(outsize):
    import jax.numpy as jnp
    from chainermn_tpu.nn import functions as JF
    from chainermn_tpu_torch.nn import functions as TF
    x = np.zeros((1, 2, 4, 4), np.float32)
    W = np.zeros((2, 3, 4, 4), np.float32)
    with pytest.raises(ValueError, match="invalid outsize") as jerr:
        JF.deconvolution_2d(jnp.asarray(x), jnp.asarray(W), stride=2, pad=1,
                            outsize=outsize)
    with pytest.raises(ValueError, match="invalid outsize") as terr:
        TF.deconvolution_2d(torch.from_numpy(x), torch.from_numpy(W),
                            stride=2, pad=1, outsize=outsize)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("args", [(8, 4, 4, 2, 1, 7), (3, 6, 3, 1, 1, 11),
                                  (5, 2, (3, 2), 1, 0, None)])
def test_deconvolution2d_link_weights_equal_jax(args):
    from chainermn_tpu.nn import links as JL
    from chainermn_tpu_torch.nn import links as TL
    cin, cout, k, s, p, seed = args
    j = JL.Deconvolution2D(cin, cout, k, stride=s, pad=p, seed=seed)
    t = TL.Deconvolution2D(cin, cout, k, stride=s, pad=p, seed=seed,
                           device="cpu")
    np.testing.assert_array_equal(t.W.detach().numpy(),
                                  np.asarray(j.W.array))
    np.testing.assert_array_equal(t.b.detach().numpy(),
                                  np.asarray(j.b.array))
    assert dict(t.namedparams()).keys() == {"/W", "/b"}
    x = _rng(4).normal(0, 1, (2, cin, 5, 5)).astype(np.float32)
    np.testing.assert_allclose(t(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(j(x)), **TOL)


def test_deconvolution2d_he_normal_reads_fan_in_from_the_4d_shape():
    """HeNormal's fan-in of a kernel ``(in, out, kh, kw)`` is ``out kh
    kw`` (the JAX ``_fans`` rule: axis 1 times the receptive field)."""
    from chainermn_tpu_torch.nn import links as TL
    t = TL.Deconvolution2D(64, 32, 4, seed=3, device="cpu")
    std = float(t.W.detach().std())
    want = np.sqrt(2.0 / (32 * 4 * 4))
    assert abs(std - want) < 0.03 * want
    assert TL.Deconvolution2D(4, 2, 3, nobias=True, device="cpu").b is None


# -- models ---------------------------------------------------------------------

def _jax_nets(tmp_path, seeds=(0, 1)):
    """JAX nets from seeds, and their npz files."""
    from chainermn_tpu.models import Discriminator, Generator
    from chainermn_tpu.serializers import save_npz
    jg = Generator(n_hidden=NH, ch=CH, seed=seeds[0])
    jd = Discriminator(ch=CH, seed=seeds[1])
    paths = (str(tmp_path / "gen.npz"), str(tmp_path / "dis.npz"))
    save_npz(paths[0], jg)
    save_npz(paths[1], jd)
    return jg, jd, paths


def _port_nets(paths):
    """Port nets built from other seeds, then loaded from the JAX npz."""
    from chainermn_tpu_torch.models import Discriminator, Generator
    from chainermn_tpu_torch.serializers import load_npz
    tg = Generator(n_hidden=NH, ch=CH, seed=7, device="cpu")
    td = Discriminator(ch=CH, seed=8, device="cpu")
    load_npz(paths[0], tg)
    load_npz(paths[1], td)
    return tg, td


def _stats(link):
    return {p: v.detach().numpy().copy() for p, v in link.namedpersistent()}


def test_models_from_jax_npz_equal_jax_in_train_and_eval(tmp_path):
    from chainermn_tpu.core.config import using_config as jusing
    from chainermn_tpu_torch.core.config import using_config as tusing
    jg, jd, paths = _jax_nets(tmp_path)
    tg, td = _port_nets(paths)
    assert tg.count_params() == jg.count_params()
    assert td.count_params() == jd.count_params()
    z = _noise(1, B)[0]
    x = _data(B)
    for train in (True, False):
        with jusing("train", train), tusing("train", train):
            jimg, jlogit = jg(z), jd(x)
            with torch.no_grad():
                timg = tg(torch.from_numpy(z))
                tlogit = td(torch.from_numpy(x))
        assert tuple(timg.shape) == (B, 3, 32, 32)
        assert tuple(tlogit.shape) == (B, 1)
        np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), **TOL)
        np.testing.assert_allclose(tlogit.numpy(), np.asarray(jlogit), **TOL)
        for link, jlink in ((tg, jg), (td, jd)):
            jstats = dict(jlink.namedpersistent())
            for path, value in _stats(link).items():
                np.testing.assert_allclose(value, np.asarray(jstats[path]),
                                           err_msg=path, **TOL)


def _updaters(tmp_path, data, zs):
    """A JAX and a port ``DCGANUpdater`` on the same weights, data and
    injected noise (plain ``Adam(alpha, beta1=0.5)``, the example's)."""
    import jax.numpy as jnp
    from chainermn_tpu.core.optimizer import Adam as JAdam
    from chainermn_tpu.dataset import SerialIterator as JSI
    from chainermn_tpu.models import DCGANUpdater as JU
    from chainermn_tpu_torch.core.optimizer import Adam as TAdam
    from chainermn_tpu_torch.dataset import SerialIterator as TSI
    from chainermn_tpu_torch.models import DCGANUpdater as TU
    jg, jd, paths = _jax_nets(tmp_path)
    tg, td = _port_nets(paths)
    ju = JU(JSI(data, B, shuffle=False),
            JAdam(alpha=ALPHA, beta1=BETA1).setup(jg),
            JAdam(alpha=ALPHA, beta1=BETA1).setup(jd))
    tu = TU(TSI(data, B, shuffle=False),
            TAdam(alpha=ALPHA, beta1=BETA1).setup(tg),
            TAdam(alpha=ALPHA, beta1=BETA1).setup(td))
    jz, tz = iter(zs), iter(zs)
    jg.make_hidden = lambda n, key=None: jnp.asarray(next(jz))
    tg.make_hidden = lambda n, key=None: torch.from_numpy(next(tz))
    return ju, tu


def _step(updater, reporter_module):
    obs = {}
    with reporter_module.Reporter().scope(obs):
        updater.update()
    return {k: float(v) for k, v in obs.items()}


def _state(updater, serializer_cls):
    """The updater's optimizers as the serializer writes them:
    parameters, Adam's leaves, running statistics, ``t``."""
    s = serializer_cls()
    updater.serialize(s)
    return {k[len("optimizer:"):]: np.asarray(v) for k, v in s.target.items()
            if k.startswith("optimizer:")}


def _compare_states(got, want, param_tol, moment_tol, stat_tol, null_band):
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if w.dtype.kind != "f":
            np.testing.assert_array_equal(g, w, err_msg=key)
            continue
        if any(key.endswith(n.split("/", 1)[1]) and key.startswith(n[:3])
               for n in NULL_BIASES):
            tol = null_band
        elif "opt_state" in key:
            tol = moment_tol
        elif "avg_" in key:
            tol = stat_tol
        else:
            tol = param_tol
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=key)


def test_one_iteration_equals_jax(tmp_path):
    """Both losses, both nets' parameters, Adam's state and both nets'
    running statistics after one iteration from shared weights and
    noise (the discriminator's from its two forwards, the generator's
    from one)."""
    from chainermn_tpu.core import reporter as jrep
    from chainermn_tpu.serializers.npz import DictionarySerializer as JDS
    from chainermn_tpu_torch.core import reporter as trep
    from chainermn_tpu_torch.serializers.npz import \
        DictionarySerializer as TDS
    ju, tu = _updaters(tmp_path, _data(2 * B), _noise(1, B))
    jobs, tobs = _step(ju, jrep), _step(tu, trep)
    assert tobs.keys() == jobs.keys() == {"gen/loss", "dis/loss"}
    for k in jobs:
        np.testing.assert_allclose(tobs[k], jobs[k], rtol=LOSS_RTOL)
    got, want = _state(tu, TDS), _state(ju, JDS)
    _compare_states(got, want, TOL["atol"], TOL["atol"], TOL["atol"],
                    2 * ALPHA)
    # the statistics moved: two discriminator forwards, one generator one
    assert np.abs(want["dis/target/bn1/avg_mean"]).max() > 0
    assert np.abs(want["gen/target/bn0/avg_mean"]).max() > 0
    assert int(got["gen/t"]) == int(got["dis/t"]) == 1


def test_three_iterations_follow_jax(tmp_path):
    from chainermn_tpu.core import reporter as jrep
    from chainermn_tpu.serializers.npz import DictionarySerializer as JDS
    from chainermn_tpu_torch.core import reporter as trep
    from chainermn_tpu_torch.serializers.npz import \
        DictionarySerializer as TDS
    ju, tu = _updaters(tmp_path, _data(2 * B), _noise(TRAJ_STEPS, B))
    for _ in range(TRAJ_STEPS):
        jobs, tobs = _step(ju, jrep), _step(tu, trep)
        for k in jobs:
            np.testing.assert_allclose(tobs[k], jobs[k], rtol=LOSS_RTOL)
    _compare_states(_state(tu, TDS), _state(ju, JDS), TRAJ_TOL["param"],
                    TRAJ_TOL["moment"], TRAJ_TOL["stat"],
                    2 * ALPHA * TRAJ_STEPS)
    assert tu.get_optimizer("gen").epoch == ju.get_optimizer("gen").epoch \
        == 1


def test_generator_step_leaves_the_discriminator_as_its_step_left_it():
    """The generator loss's forward through the discriminator neither
    moves its running statistics nor gives its parameters a gradient:
    what the discriminator's update left stays, and its parameters take
    gradients again afterwards."""
    from chainermn_tpu_torch.core import reporter as trep
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.dataset import SerialIterator
    from chainermn_tpu_torch.models import (DCGANUpdater, Discriminator,
                                            Generator)
    gen = Generator(n_hidden=NH, ch=CH, device="cpu")
    dis = Discriminator(ch=CH, device="cpu")
    opt_dis = Adam().setup(dis)
    seen = {}
    real_update = opt_dis.update

    def update_and_record(*a, **kw):
        out = real_update(*a, **kw)
        seen["stats"] = _stats(dis)
        seen["grads"] = {p: v.grad.clone() for p, v in dis.namedparams()}
        return out

    opt_dis.update = update_and_record
    updater = DCGANUpdater(SerialIterator(_data(B), B, shuffle=False),
                           Adam().setup(gen), opt_dis)
    _step(updater, trep)
    for path, value in _stats(dis).items():
        np.testing.assert_array_equal(value, seen["stats"][path], path)
    for path, p in dis.namedparams():
        assert p.requires_grad, path
        assert torch.equal(p.grad, seen["grads"][path]), path


def test_make_hidden_draws_from_its_key():
    from chainermn_tpu_torch.core import rng
    from chainermn_tpu_torch.models import Generator
    gen = Generator(n_hidden=NH, ch=CH, device="cpu")
    a = gen.make_hidden(4, key=rng.make_key(3))
    assert a.shape == (4, NH) and a.dtype == torch.float32
    assert torch.equal(a, gen.make_hidden(4, key=rng.make_key(3)))
    assert not torch.equal(a, gen.make_hidden(4, key=rng.make_key(4)))


def test_dcgan_updater_steps():
    """Twin of ``tests/models_tests/test_models.py::
    test_dcgan_updater_steps``: two updates move both nets."""
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.dataset import SerialIterator
    from chainermn_tpu_torch.models import (DCGANUpdater, Discriminator,
                                            Generator)
    gen = Generator(n_hidden=16, ch=32, seed=0, device="cpu")
    dis = Discriminator(ch=32, seed=1, device="cpu")
    data = _rng(0).normal(0, 0.5, (16, 3, 32, 32)).astype(np.float32)
    updater = DCGANUpdater(SerialIterator(data, 8, shuffle=False),
                           Adam(alpha=1e-3).setup(gen),
                           Adam(alpha=1e-3).setup(dis))
    w_gen0 = gen.l0.W.detach().clone()
    w_dis0 = dis.l4.W.detach().clone()
    updater.update()
    updater.update()
    assert not torch.allclose(gen.l0.W, w_gen0)
    assert not torch.allclose(dis.l4.W, w_dis0)


# -- data parallel: one 2-rank gloo world ---------------------------------------

DP_STEPS = 2


def _dp_worker(rank, paths, data, zs):
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.core import reporter as trep
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.dataset import SerialIterator
    from chainermn_tpu_torch.models import (DCGANUpdater, Discriminator,
                                            Generator)
    from chainermn_tpu_torch.serializers.npz import DictionarySerializer
    comm = create_communicator("pure_nccl", device="cpu")
    out = {}
    # the JAX DP run's rows: rank r takes rows [r B, (r + 1) B) of each
    # global batch of 2 B and of each global z
    rows = [data[i * 2 * B + rank * B:i * 2 * B + (rank + 1) * B]
            for i in range(len(data) // (2 * B))]
    tg, td = _port_nets(paths)
    comm.bcast_data(tg)
    comm.bcast_data(td)
    updater = DCGANUpdater(
        SerialIterator(np.concatenate(rows), B, shuffle=False),
        create_multi_node_optimizer(Adam(alpha=ALPHA, beta1=BETA1),
                                    comm).setup(tg),
        create_multi_node_optimizer(Adam(alpha=ALPHA, beta1=BETA1),
                                    comm).setup(td))
    mine = iter([z[rank * B:(rank + 1) * B] for z in zs])
    tg.make_hidden = lambda n, key=None: torch.from_numpy(next(mine))
    out["losses"] = [_step(updater, trep) for _ in range(DP_STEPS)]
    out["state"] = _state(updater, DictionarySerializer)
    out["collectives"] = dict(comm.calls)
    # the twin of test_models.py::test_dcgan_data_parallel: the updater's
    # own noise, each rank its own rows
    gen = Generator(n_hidden=16, ch=32, seed=0, device="cpu")
    dis = Discriminator(ch=32, seed=1, device="cpu")
    own = DCGANUpdater(
        SerialIterator(_data(16, seed=rank), 8, shuffle=False),
        create_multi_node_optimizer(Adam(alpha=1e-3), comm).setup(gen),
        create_multi_node_optimizer(Adam(alpha=1e-3), comm).setup(dis))
    drawn = []
    make_hidden = gen.make_hidden
    gen.make_hidden = lambda n, key=None: drawn.append(
        make_hidden(n, key)) or drawn[-1]
    _step(own, trep)
    out["own_z"] = drawn[0]
    out["own_w"] = gen.l0.W.detach().clone()
    return out


def test_data_parallel_run_equals_jax(tmp_path):
    import jax
    import jax.numpy as jnp
    import chainermn_tpu as jct
    from chainermn_tpu.core import reporter as jrep
    from chainermn_tpu.core.optimizer import Adam as JAdam
    from chainermn_tpu.dataset import SerialIterator as JSI
    from chainermn_tpu.models import DCGANUpdater as JU
    from chainermn_tpu.serializers.npz import DictionarySerializer as JDS
    data = _data(2 * B * DP_STEPS)
    zs = _noise(DP_STEPS, 2 * B)
    jg, jd, paths = _jax_nets(tmp_path)
    r0, r1 = spawn_ranks(tmp_path, _dp_worker, world=WORLD, paths=paths,
                         data=data, zs=zs)
    jcomm = jct.create_communicator("jax_ici", devices=jax.devices()[:WORLD])
    ju = JU(JSI(data, 2 * B, shuffle=False),
            jct.create_multi_node_optimizer(
                JAdam(alpha=ALPHA, beta1=BETA1), jcomm).setup(jg),
            jct.create_multi_node_optimizer(
                JAdam(alpha=ALPHA, beta1=BETA1), jcomm).setup(jd))
    jz = iter(zs)
    jg.make_hidden = lambda n, key=None: jnp.asarray(next(jz))
    jlosses = [_step(ju, jrep) for _ in range(DP_STEPS)]
    for step in range(DP_STEPS):
        assert r0["losses"][step] == r1["losses"][step]   # one mean
        for k, v in jlosses[step].items():
            np.testing.assert_allclose(r0["losses"][step][k], v,
                                       rtol=LOSS_RTOL)
    want = _state(ju, JDS)
    for key, value in r0["state"].items():
        if "avg_" not in key:   # running statistics stay per rank
            np.testing.assert_array_equal(value, r1["state"][key], key)
    # JAX's statistics: those of its first device, rank 0's rows; they
    # average the pre-norm biases in with weight 1 - decay
    _compare_states(r0["state"], want, TOL["atol"], TOL["atol"],
                    TOL["atol"] + 2 * ALPHA * (1 - 0.9) * DP_STEPS,
                    2 * ALPHA * DP_STEPS)
    # one gradient allreduce per net and iteration, one loss allreduce
    assert r0["collectives"].get("allreduce_grad", 0) == 2 * DP_STEPS
    # the updater's own noise: each rank its own rows, finite weights
    assert not torch.equal(r0["own_z"], r1["own_z"])
    assert torch.isfinite(r0["own_w"]).all()
    assert torch.equal(r0["own_w"], r1["own_w"])
