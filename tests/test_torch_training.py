"""The port's training path against the JAX package's, on the CPU.

``Trainer`` → ``StandardUpdater`` → ``Optimizer.update(model, x, t)`` at a
small size (2 layers, d 64, T 32), with the same weights (same seeds, or
carried over by ``load_params``) and the same numpy-seeded data on both
sides.

Tolerances (fp32): losses and gradients agree to float noise (1e-5
absolute; the two frameworks sum in other orders).  Adam's
``m_hat / (sqrt(v_hat) + eps)`` turns a gradient that is 0 up to float
noise (the key bias of ``qkv``: softmax ignores a constant added to every
score of a row) into a step of size lr on one side and not the other, so
the tests that compare parameters after Adam steps take eps = 1e-3, which
keeps such noise below 1e-6 of a step; the rule tests use a model whose
gradients all lie well away from 0 and the default eps.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chainermn_tpu.core import optimizer as JO
from chainermn_tpu.core.link import Chain as JChain
from chainermn_tpu.dataset import SerialIterator as JSerialIterator
from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.nn import functions as JF
from chainermn_tpu.nn import links as JL
from chainermn_tpu.serializers.npz import (DictionarySerializer,
                                           NpzDeserializer, save_npz)
from chainermn_tpu.training import StandardUpdater as JStandardUpdater
from chainermn_tpu.training import Trainer as JTrainer
from chainermn_tpu_torch.core import optimizer as O
from chainermn_tpu_torch.core import reporter
from chainermn_tpu_torch.core.link import Chain
from chainermn_tpu_torch.dataset import (SerialIterator, concat_examples,
                                         to_device)
from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.nn import functions as F
from chainermn_tpu_torch.nn import links as L
from chainermn_tpu_torch.serializers import (load_optimizer_state,
                                             load_params)
from chainermn_tpu_torch.training import StandardUpdater, Trainer

VOCAB, T = 61, 32
KW = dict(n_vocab=VOCAB, d_model=64, n_heads=2, n_layers=2, max_len=64)
ATOL = 1e-5


def _tokens(n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, VOCAB, (n, T)).astype(np.int32)
    return x, np.roll(x, -1, axis=1)


def _jax_params(model):
    return {p: np.asarray(v.array) for p, v in model.namedparams()}


def _port_params(model):
    return {p: v.detach().numpy() for p, v in model.namedparams()}


def _assert_params_close(port_model, jax_params, atol=ATOL):
    got = _port_params(port_model)
    assert sorted(got) == sorted(jax_params)
    for path, ref in jax_params.items():
        np.testing.assert_allclose(got[path], ref, rtol=0, atol=atol,
                                   err_msg=path)


# -- loss functions ----------------------------------------------------------

@pytest.mark.parametrize("reduce,normalize", [("mean", True),
                                              ("mean", False), ("no", True)])
@pytest.mark.parametrize("weighted", [False, True])
def test_softmax_cross_entropy_matches_jax(reduce, normalize, weighted):
    rng = np.random.RandomState(4)
    x = rng.normal(0, 2, (12, 7)).astype(np.float32)
    t = rng.randint(0, 7, 12).astype(np.int32)
    t[[1, 5, 6]] = -1                       # ignored entries
    w = rng.uniform(0.5, 2, 7).astype(np.float32) if weighted else None
    kw = dict(ignore_label=-1, reduce=reduce, normalize=normalize)
    xt = torch.from_numpy(x).requires_grad_()
    got = F.softmax_cross_entropy(xt, torch.from_numpy(t), class_weight=w,
                                  **kw)
    ref = JF.softmax_cross_entropy(jnp.asarray(x), jnp.asarray(t),
                                   class_weight=w, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=ATOL)
    got.sum().backward()
    jgrad = jax.grad(lambda a: JF.softmax_cross_entropy(
        a, jnp.asarray(t), class_weight=w, **kw).sum())(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), atol=ATOL)


def test_softmax_cross_entropy_of_bf16_logits_runs_in_fp32():
    rng = np.random.RandomState(5)
    x = rng.normal(0, 3, (16, 33)).astype(np.float32)
    t = rng.randint(0, 33, 16)
    got = F.softmax_cross_entropy(torch.from_numpy(x).bfloat16(),
                                  torch.from_numpy(t))
    ref = JF.softmax_cross_entropy(jnp.asarray(x).astype(jnp.bfloat16),
                                   jnp.asarray(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), atol=ATOL)


def test_softmax_log_softmax_and_accuracy_match_jax():
    rng = np.random.RandomState(6)
    x = rng.normal(0, 1, (10, 5)).astype(np.float32)
    t = rng.randint(0, 5, 10)
    t[3] = -1
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    np.testing.assert_allclose(F.softmax(xt).numpy(),
                               np.asarray(JF.softmax(jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_allclose(F.log_softmax(xt).numpy(),
                               np.asarray(JF.log_softmax(jnp.asarray(x))),
                               atol=1e-6)
    for ignore in (None, -1):
        assert float(F.accuracy(xt, tt, ignore_label=ignore)) \
            == pytest.approx(float(JF.accuracy(jnp.asarray(x),
                                               jnp.asarray(t),
                                               ignore_label=ignore)))


# -- the model ---------------------------------------------------------------

def test_lm_loss_and_every_gradient_match_jax():
    """JAX's ``opt.update`` leaves its gradients on ``Parameter.grad``;
    the port's ``loss.backward()`` on ``.grad`` of the same weights."""
    x, t = _tokens(2)
    jmodel = JaxLM(seed=0, **KW)
    jopt = JO.SGD(lr=0.0)
    jopt.setup(jmodel)
    jloss = jopt.update(jmodel, jnp.asarray(x), jnp.asarray(t))
    model = load_params(TransformerLM(seed=1, device="cpu", **KW),
                        _jax_params(jmodel))
    loss = model(torch.from_numpy(x), torch.from_numpy(t))
    loss.backward()
    assert loss.item() == pytest.approx(float(jloss), abs=ATOL)
    jgrads = {p: np.asarray(v.grad) for p, v in jmodel.namedparams()}
    for path, p in model.namedparams():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[path], rtol=0,
                                   atol=ATOL, err_msg=path)


def test_lm_loss_ignores_label_minus_one():
    x, t = _tokens(2)
    t[:, -1] = -1
    model = TransformerLM(seed=0, device="cpu", **KW)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t)).item()
    ref = float(JaxLM(seed=0, **KW)(jnp.asarray(x), jnp.asarray(t)))
    assert got == pytest.approx(ref, abs=ATOL)


def test_lm_reports_its_loss_to_the_active_reporter():
    x, t = _tokens(2)
    model = TransformerLM(seed=0, device="cpu", **KW)
    rep = reporter.Reporter()
    rep.add_observer("main", model)
    obs = {}
    with rep.scope(obs):
        loss = model(torch.from_numpy(x), torch.from_numpy(t))
    assert set(obs) == {"main/loss"}
    assert isinstance(obs["main/loss"], torch.Tensor)   # not synced
    assert obs["main/loss"].item() == pytest.approx(loss.item())


@pytest.mark.parametrize("remat", [True, "full", "dots"])
def test_remat_gives_the_same_loss_and_gradients(remat):
    x, t = _tokens(2, seed=3)
    results = []
    for policy in (False, remat):
        model = TransformerLM(seed=0, remat=policy, device="cpu", **KW)
        loss = model(torch.from_numpy(x), torch.from_numpy(t))
        loss.backward()
        results.append((loss.item(), {p: v.grad.clone()
                                      for p, v in model.namedparams()}))
    (l0, g0), (l1, g1) = results
    assert l1 == pytest.approx(l0, abs=1e-6)
    for path in g0:
        torch.testing.assert_close(g1[path], g0[path], rtol=0, atol=1e-6)


def test_unknown_remat_policy_and_sequence_parallelism_raise():
    """An unknown remat policy and an unknown sequence-parallel mode
    raise at construction (sequence parallelism itself is tested in
    ``tests/test_torch_sequence_parallel.py``)."""
    with pytest.raises(ValueError, match="remat"):
        TransformerLM(seed=0, remat="everything", device="cpu", **KW)
    with pytest.raises(ValueError, match="sp_mode"):
        TransformerLM(seed=0, sp_comm=object(), sp_mode="spiral",
                      device="cpu", **KW)


# -- optimizer rules and hooks ----------------------------------------------

class _JaxNet(JChain):
    def __init__(self):
        super().__init__()
        with self.init_scope():
            self.l1 = JL.Linear(8, 16, seed=1)
            self.l2 = JL.Linear(16, 4, seed=2)

    def forward(self, x, y):
        return jnp.mean((self.l2(jnp.tanh(self.l1(x))) - y) ** 2)


class _Net(Chain):
    def __init__(self):
        super().__init__()
        self.l1 = L.Linear(8, 16, seed=1, device="cpu")
        self.l2 = L.Linear(16, 4, seed=2, device="cpu")

    def forward(self, x, y):
        return torch.mean((self.l2(torch.tanh(self.l1(x))) - y) ** 2)


def _regression(step):
    rng = np.random.RandomState(100 + step)
    return (rng.normal(0, 1, (16, 8)).astype(np.float32),
            rng.normal(0, 1, (16, 4)).astype(np.float32))


RULES = {
    "SGD": lambda m: m.SGD(lr=0.1),
    "MomentumSGD": lambda m: m.MomentumSGD(lr=0.05, momentum=0.9),
    "NesterovAG": lambda m: m.NesterovAG(lr=0.05, momentum=0.9),
    "Adam": lambda m: m.Adam(alpha=0.01),
    "Adam-amsgrad": lambda m: m.Adam(alpha=0.01, amsgrad=True),
    "Adam-decay": lambda m: m.Adam(alpha=0.01, weight_decay_rate=0.1),
    "AdamW": lambda m: m.AdamW(alpha=0.01),
    "RMSprop": lambda m: m.RMSprop(lr=0.01),
    "AdaGrad": lambda m: m.AdaGrad(lr=0.1),
    "AdaDelta": lambda m: m.AdaDelta(),
}

HOOKS = {
    "WeightDecay": lambda m: m.WeightDecay(0.1),
    "Lasso": lambda m: m.Lasso(0.01),
    "GradientClipping-clips": lambda m: m.GradientClipping(0.05),
    "GradientClipping-passes": lambda m: m.GradientClipping(100.0),
    "GradientHardClipping": lambda m: m.GradientHardClipping(-0.02, 0.02),
    "GradientScaling": lambda m: m.GradientScaling(0.5),
}


def _run_both(make_opt, hooks=(), steps=3):
    jnet, net = _JaxNet(), _Net()
    jopt, opt = make_opt(JO), make_opt(O)
    jopt.setup(jnet)
    opt.setup(net)
    for make_hook in hooks:
        jopt.add_hook(make_hook(JO))
        opt.add_hook(make_hook(O))
    for step in range(steps):
        x, y = _regression(step)
        jloss = jopt.update(jnet, jnp.asarray(x), jnp.asarray(y))
        loss = opt.update(net, torch.from_numpy(x), torch.from_numpy(y))
        assert loss.item() == pytest.approx(float(jloss), abs=1e-6)
    return jnet, jopt, net, opt


def _jax_state_leaves(jopt):
    s = DictionarySerializer()
    jopt.serialize(s)
    n = int(s.target["opt_state_len"])
    return [s.target[f"opt_state_{i}"] for i in range(n)]


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_matches_jax_for_three_steps(rule):
    jnet, jopt, net, opt = _run_both(RULES[rule])
    _assert_params_close(net, _jax_params(jnet), atol=1e-6)
    assert opt.t == jopt.t == 3
    # the state in the JAX optimizer's flat optax layout, leaf by leaf
    ref = _jax_state_leaves(jopt)
    got = opt.state_leaves()
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert np.shape(a) == np.shape(b), i
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7,
                                   err_msg=f"leaf {i}")


@pytest.mark.parametrize("hook", sorted(HOOKS))
@pytest.mark.parametrize("rule", ["SGD", "Adam"])
def test_hook_matches_jax_for_three_steps(rule, hook):
    jnet, _, net, _ = _run_both(RULES[rule], hooks=[HOOKS[hook]])
    _assert_params_close(net, _jax_params(jnet), atol=1e-6)


def test_hooks_chain_in_registration_order():
    jnet, _, net, _ = _run_both(
        RULES["MomentumSGD"],
        hooks=[HOOKS["WeightDecay"], HOOKS["GradientClipping-clips"]])
    _assert_params_close(net, _jax_params(jnet), atol=1e-6)


def test_update_from_stored_gradients_equals_update_with_loss():
    x, y = _regression(0)
    nets = [_Net(), _Net()]
    opts = [O.Adam(alpha=0.01).setup(n) for n in nets]
    opts[0].update(nets[0], torch.from_numpy(x), torch.from_numpy(y))
    nets[1].cleargrads()
    nets[1](torch.from_numpy(x), torch.from_numpy(y)).backward()
    assert opts[1].update() is None
    for (_, a), (_, b) in zip(nets[0].namedparams(), nets[1].namedparams()):
        assert torch.equal(a, b)
    assert opts[0].t == opts[1].t == 1


def test_hook_lifecycle():
    opt = O.SGD(lr=0.1)
    with pytest.raises(RuntimeError, match="setup"):
        opt.add_hook(O.WeightDecay(0.1))
    with pytest.raises(RuntimeError, match="setup"):
        opt.update(lambda: None)
    opt.setup(_Net())
    opt.add_hook(O.WeightDecay(0.1))
    opt.add_hook(O.WeightDecay(0.2), name="second")
    assert list(opt._hooks) == ["WeightDecay", "second"]
    opt.remove_hook("WeightDecay")
    assert list(opt._hooks) == ["second"]
    opt.new_epoch()
    assert opt.epoch == 1


def test_cleargrads_and_zerograds():
    net = _Net()
    x, y = _regression(0)
    net(torch.from_numpy(x), torch.from_numpy(y)).backward()
    assert all(p.grad is not None for p in net.params())
    net.zerograds()
    assert all(torch.count_nonzero(p.grad) == 0 for p in net.params())
    net.cleargrads()
    assert all(p.grad is None for p in net.params())


# -- the loop ------------------------------------------------------------------

def _trajectory(trainer_cls, updater_cls, iterator_cls, model, opt, data,
                out, steps=5):
    it = iterator_cls(data, 2, shuffle=False)
    updater = updater_cls(it, opt)
    trainer = trainer_cls(updater, (steps, "iteration"), out=str(out))
    losses = []
    trainer.extend(lambda tr: losses.append(tr.observation["main/loss"]),
                   name="record")
    trainer.run()
    return trainer, [float(np.asarray(
        l.detach() if isinstance(l, torch.Tensor) else l)) for l in losses]


def test_trainer_trajectory_matches_jax(tmp_path):
    """Five steps of Trainer → StandardUpdater → Adam over a
    SerialIterator (batch 2, no shuffle, so the fourth step starts the
    second epoch): the same losses step by step."""
    x, t = _tokens(6, seed=7)
    data = list(zip(x, t))
    jmodel = JaxLM(seed=0, **KW)
    jopt = JO.Adam(alpha=3e-3)
    jopt.setup(jmodel)
    jtrainer, jlosses = _trajectory(JTrainer, JStandardUpdater,
                                    JSerialIterator, jmodel, jopt, data,
                                    tmp_path / "jax")
    model = TransformerLM(seed=0, device="cpu", **KW)
    opt = O.Adam(alpha=3e-3)
    opt.setup(model)
    trainer, losses = _trajectory(Trainer, StandardUpdater, SerialIterator,
                                  model, opt, data, tmp_path / "port")
    assert len(losses) == len(jlosses) == 5
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=ATOL)
    assert losses[-1] < losses[0]
    assert trainer.updater.iteration == jtrainer.updater.iteration == 5
    assert opt.epoch == jopt.epoch == 1
    assert trainer.updater.epoch_detail == jtrainer.updater.epoch_detail


def test_updater_puts_the_batch_on_the_models_device():
    seen = []

    class Probe(_Net):
        def forward(self, x, y):
            seen.append((x.device, y.device))
            return super().forward(x, y)

    data = [_regression(0)[0][i:i + 1].reshape(8) for i in range(4)]
    data = [(a, np.zeros(4, np.float32)) for a in data]
    net = Probe()
    opt = O.SGD(lr=0.1).setup(net)
    StandardUpdater(SerialIterator(data, 2), opt).update()
    assert seen == [(torch.device("cpu"), torch.device("cpu"))]


def test_serial_iterator_visits_the_jax_order():
    data = list(range(10))
    ours = SerialIterator(data, 3, shuffle=True, seed=5)
    ref = JSerialIterator(data, 3, shuffle=True, seed=5)
    for _ in range(8):
        assert ours.next() == ref.next()
        assert ours.epoch == ref.epoch
        assert ours.is_new_epoch == ref.is_new_epoch
        assert ours.epoch_detail == pytest.approx(ref.epoch_detail)


def test_concat_examples_stacks_on_the_host_then_places_once():
    batch = [(np.arange(3), np.float32(i)) for i in range(4)]
    xs, ys = concat_examples(batch)
    assert isinstance(xs, np.ndarray) and xs.shape == (4, 3)
    xs, ys = concat_examples(batch, device="cpu")
    assert isinstance(xs, torch.Tensor) and ys.shape == (4,)
    padded = concat_examples([np.arange(2), np.arange(4)], padding=-1)
    np.testing.assert_array_equal(padded, [[0, 1, -1, -1], [0, 1, 2, 3]])
    src = np.zeros(3)
    placed = to_device({"a": src}, "cpu")
    src[0] = 5
    assert placed["a"][0].item() == 0       # a copy


def test_using_config_sets_a_flag_for_one_block_and_one_thread():
    import threading
    from chainermn_tpu_torch.core import config, using_config
    seen = []
    with using_config("train", False):
        with using_config("user_flag", 3):
            assert (config.train, config.user_flag) == (False, 3)
            worker = threading.Thread(target=lambda: seen.append(config.train))
            worker.start()
            worker.join()
        assert not hasattr(config, "user_flag")
    assert config.train is True and seen == [True]


def test_report_scope_collects_into_the_given_observation():
    obs = {}
    with reporter.Reporter():
        with reporter.report_scope(obs):
            reporter.report({"accuracy": torch.tensor(0.5)})
    assert list(obs) == ["accuracy"]
    reporter.report({"dropped": 1.0})        # no active reporter: a no-op


def test_summaries_convert_tensors_only_when_computed():
    s = reporter.DictSummary()
    for v in (1.0, 2.0, 4.0):
        s.add({"loss": torch.tensor(v), "skip": torch.zeros(3)})
    assert s.compute_mean() == {"loss": pytest.approx(7.0 / 3)}
    one = reporter.Summary()
    for v in (1.0, 3.0):
        one.add(torch.tensor(v))
    assert one.make_statistics() == (pytest.approx(2.0), pytest.approx(1.0))


# -- resuming a JAX run ---------------------------------------------------------

def test_resume_a_jax_adam_run_in_the_port():
    """JAX trains two steps; its weights and Adam state go to the port,
    which takes step 3: the same loss, moments and weights as JAX's own
    step 3."""
    batches = [_tokens(2, seed=s) for s in range(3)]
    jmodel = JaxLM(seed=0, **KW)
    jopt = JO.Adam(alpha=3e-3, eps=1e-3)
    jopt.setup(jmodel)
    for x, t in batches[:2]:
        jopt.update(jmodel, jnp.asarray(x), jnp.asarray(t))
    snap = DictionarySerializer()
    jopt.serialize(snap)

    model = load_params(TransformerLM(seed=9, device="cpu", **KW),
                        _jax_params(jmodel))
    opt = O.Adam(alpha=3e-3, eps=1e-3)
    opt.setup(model)
    load_optimizer_state(opt, snap.target)
    assert opt.t == 2
    x, t = batches[2]
    loss = opt.update(model, torch.from_numpy(x), torch.from_numpy(t))
    jloss = jopt.update(jmodel, jnp.asarray(x), jnp.asarray(t))
    assert loss.item() == pytest.approx(float(jloss), abs=ATOL)
    _assert_params_close(model, _jax_params(jmodel))
    for i, (a, b) in enumerate(zip(opt.state_leaves(),
                                   _jax_state_leaves(jopt))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-9,
                                   err_msg=f"leaf {i}")


def test_port_trainer_resumes_a_jax_trainer_snapshot(tmp_path):
    """A JAX ``Trainer`` snapshot (``save_npz`` of the trainer: weights,
    Adam state, iteration, a shuffling iterator's order and RNG, trigger
    state) read by the port's ``Trainer.serialize``: the port's steps 4
    and 5 are the JAX run's steps 4 and 5."""
    x, t = _tokens(5, seed=8)
    data = list(zip(x, t))

    def make(lm, opt_mod, iter_cls, updater_cls, trainer_cls, model_kw,
             steps, out):
        model = lm(seed=0, **KW, **model_kw)
        opt = opt_mod.Adam(alpha=3e-3, eps=1e-3)
        opt.setup(model)
        it = iter_cls(data, 2, shuffle=True, seed=3)
        trainer = trainer_cls(updater_cls(it, opt), (steps, "iteration"),
                              out=str(out))
        losses = []
        trainer.extend(lambda tr: losses.append(
            float(np.asarray(tr.observation["main/loss"]))), name="record")
        return trainer, losses

    jax_side = (JaxLM, JO, JSerialIterator, JStandardUpdater, JTrainer, {})
    full, jlosses = make(*jax_side, 5, tmp_path / "full")
    full.run()
    first, _ = make(*jax_side, 3, tmp_path / "first")
    first.run()
    snap = tmp_path / "snapshot.npz"
    save_npz(str(snap), first)

    trainer, losses = make(TransformerLM, O, SerialIterator, StandardUpdater,
                           Trainer, dict(device="cpu"), 5, tmp_path / "port")
    with np.load(snap) as npz:
        trainer.serialize(NpzDeserializer(npz))
    assert trainer.updater.iteration == 3
    assert trainer.updater.get_optimizer().t == 3
    trainer.run()
    assert len(losses) == 2
    np.testing.assert_allclose(losses, jlosses[3:], rtol=0, atol=ATOL)
    assert trainer.updater.epoch_detail == full.updater.epoch_detail


def test_load_optimizer_state_refuses_another_tree():
    jnet = _JaxNet()
    jopt = JO.MomentumSGD(lr=0.1)
    jopt.setup(jnet)
    x, y = _regression(0)
    jopt.update(jnet, jnp.asarray(x), jnp.asarray(y))
    snap = DictionarySerializer()
    jopt.serialize(snap)
    opt = O.Adam().setup(_Net())
    with pytest.raises(ValueError, match="leaves"):
        load_optimizer_state(opt, snap.target)
    with pytest.raises(KeyError, match="opt_state_len"):
        load_optimizer_state(opt, {})
    # the right rule on a model of another shape
    other = O.MomentumSGD().setup(TransformerLM(seed=0, device="cpu", **KW))
    with pytest.raises(ValueError):
        load_optimizer_state(other, snap.target)


def test_port_optimizer_snapshot_round_trips_through_the_jax_format():
    """``Optimizer.serialize`` writes the JAX keys; a second port
    optimizer reads them back (the protocol the trainer snapshot uses)."""
    _, _, net, opt = _run_both(RULES["Adam"], steps=2)
    snap = DictionarySerializer()
    opt.serialize(snap)
    assert {"t", "epoch", "opt_state_len", "target/l1/W"} <= set(snap.target)

    class Reader:
        is_writer = False

        def __init__(self, d, path=""):
            self.d, self.path = d, path

        def __getitem__(self, name):
            return Reader(self.d, self.path + name + "/")

        def __call__(self, key, value):
            return self.d[self.path + key]

    net2 = _Net()
    opt2 = O.Adam(alpha=0.01).setup(net2)
    opt2.serialize(Reader(snap.target))
    assert opt2.t == 2
    for (_, a), (_, b) in zip(net.namedparams(), net2.namedparams()):
        assert torch.equal(a, b)
    for a, b in zip(opt.state_leaves(), opt2.state_leaves()):
        np.testing.assert_array_equal(a, b)
