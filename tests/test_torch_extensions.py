"""The port's trainer extensions, evaluators and snapshots against the
JAX package's.

Each check feeds both packages the same inputs: the same observation
sequence through ``LogReport`` (its entries and its ``log`` file), the
same optimizer through ``ExponentialShift``, ``LinearShift`` and
``observe_lr``, the same weights and validation data (a ragged last
batch) through ``Evaluator``, and the same gathered values through the
multi-node evaluator and the observation aggregator (a stand-in
communicator whose ``allgather_obj`` returns fixed ranks' values).
Then whole trainers: a JAX ``snapshot_iter_N`` of a tiny MNIST trainer
resumes in the port's trainer, and the port's in the JAX trainer.

Tolerances: ``LogReport`` entries are means of the same float32 values
in the same order, so they are compared exactly; the evaluator and the
resumed trainers run the model in both frameworks, fp32, 1e-5 (other
summation orders).
"""

import json
import os

import numpy as np
import pytest
import torch

from chainermn_tpu_torch.core.optimizer import Adam as TAdam
from chainermn_tpu_torch.dataset import SerialIterator as TSerialIterator
from chainermn_tpu_torch.dataset import get_mnist as tget_mnist
from chainermn_tpu_torch.evaluators import \
    create_multi_node_evaluator as tcreate_evaluator
from chainermn_tpu_torch.extensions import \
    ObservationAggregator as TAggregator
from chainermn_tpu_torch.models import MLP as TMLP
from chainermn_tpu_torch.models import Classifier as TClassifier
from chainermn_tpu_torch.serializers import load_npz as tload_npz
from chainermn_tpu_torch.serializers import save_npz as tsave_npz
from chainermn_tpu_torch.training import StandardUpdater as TUpdater
from chainermn_tpu_torch.training import Trainer as TTrainer
from chainermn_tpu_torch.training import extensions as TE
from chainermn_tpu_torch.training import make_extension as tmake_extension

import chainermn_tpu as ct
from chainermn_tpu.core.optimizer import Adam as JAdam
from chainermn_tpu.dataset import SerialIterator as JSerialIterator
from chainermn_tpu.dataset import get_mnist as jget_mnist
from chainermn_tpu.extensions import ObservationAggregator as JAggregator
from chainermn_tpu.models import MLP as JMLP
from chainermn_tpu.models import Classifier as JClassifier
from chainermn_tpu.serializers import load_npz as jload_npz
from chainermn_tpu.training import StandardUpdater as JUpdater
from chainermn_tpu.training import Trainer as JTrainer
from chainermn_tpu.training import extensions as JE

TOL = dict(rtol=0, atol=1e-5)
UNITS, BATCH = 16, 50
METRICS = ("main/loss", "main/accuracy", "validation/main/loss",
           "validation/main/accuracy")


class _Updater:
    """The part of an updater extensions read, advanced by hand."""

    def __init__(self, optimizer=None, per_epoch=4):
        self.iteration = 0
        self.per_epoch = per_epoch
        self.optimizer = optimizer

    @property
    def epoch(self):
        return self.iteration // self.per_epoch

    @property
    def epoch_detail(self):
        return self.iteration / self.per_epoch

    def get_optimizer(self, name="main"):
        return self.optimizer

    def get_all_optimizers(self):
        return {"main": self.optimizer}


class _Trainer:
    """The part of a trainer extensions read; ``elapsed_time`` fixed so
    the two packages' log files can be compared."""

    def __init__(self, out, optimizer=None):
        self.out = out
        self.updater = _Updater(optimizer)
        self.observation = {}
        self.elapsed_time = 1.5


class _Holder:
    """An optimizer stand-in with the attributes the shifts move."""

    def __init__(self):
        self.lr = 0.1
        self.alpha = 1e-3


class _Comm:
    """``allgather_obj`` of a fixed world: this rank's value and the
    others' given."""

    def __init__(self, others):
        self.others = others

    def allgather_obj(self, obj):
        return [obj] + list(self.others)


def _observations(n=8):
    rng = np.random.RandomState(3)
    return [{"main/loss": np.float32(rng.rand()),
             "main/accuracy": np.float32(rng.rand()),
             "validation/main/loss": np.float32(rng.rand())}
            for _ in range(n)]


def _drive(extension, trainer, observations, wrap):
    for obs in observations:
        trainer.updater.iteration += 1
        trainer.observation = {k: wrap(v) for k, v in obs.items()}
        extension(trainer)


# -- LogReport, the shifts, observe_lr -----------------------------------------

@pytest.mark.parametrize("trigger", [(2, "iteration"), (1, "epoch")])
def test_log_report_entries_and_file_equal_jax(tmp_path, trigger):
    obs = _observations()
    logs = {}
    for name, LogReport, wrap in (
            ("jax", JE.LogReport, np.asarray),
            ("port", TE.LogReport, lambda v: torch.tensor(v))):
        out = tmp_path / name
        out.mkdir()
        ext = LogReport(trigger=trigger)
        _drive(ext, _Trainer(str(out)), obs, wrap)
        logs[name] = (ext.log, json.loads((out / "log").read_text()),
                      (out / "log").read_text())
    assert logs["port"][0] == logs["jax"][0]
    assert logs["port"][1] == logs["jax"][1]
    assert logs["port"][2] == logs["jax"][2]
    assert len(logs["port"][0]) == (4 if trigger[1] == "iteration" else 2)


def test_log_report_keys_and_serialized_log(tmp_path):
    from chainermn_tpu.serializers.npz import DictionarySerializer as JDS
    from chainermn_tpu_torch.serializers import DictionarySerializer
    obs = _observations()
    jext, text = JE.LogReport(keys=["main/loss"]), TE.LogReport(
        keys=["main/loss"])
    _drive(jext, _Trainer(str(tmp_path)), obs, np.asarray)
    _drive(text, _Trainer(str(tmp_path)), obs, torch.tensor)
    js, ts = JDS(), DictionarySerializer()
    jext.serialize(js)
    text.serialize(ts)
    assert sorted(js.target) == sorted(ts.target)
    for key in js.target:
        np.testing.assert_array_equal(js.target[key], ts.target[key])


@pytest.mark.parametrize("kind", ["exponential", "exponential_target",
                                  "linear", "observe_lr"])
def test_shifts_and_observe_lr_equal_jax(tmp_path, kind):
    from chainermn_tpu.core import reporter as jreporter
    from chainermn_tpu_torch.core import reporter as treporter
    seen = {}
    for name, E, rep in (("jax", JE, jreporter), ("port", TE, treporter)):
        holder = _Holder()
        trainer = _Trainer(str(tmp_path), holder)
        ext = {"exponential": lambda: E.ExponentialShift("lr", 0.5),
               "exponential_target": lambda: E.ExponentialShift(
                   "alpha", 3.0, target=2e-2),
               "linear": lambda: E.LinearShift("lr", (0.1, 0.4), (2, 6)),
               "observe_lr": lambda: E.observe_lr()}[kind]()
        if hasattr(ext, "initialize"):
            ext.initialize(trainer)
        values = []
        for _ in range(8):
            trainer.updater.iteration += 1
            holder.lr *= 1.25 if kind == "observe_lr" else 1.0
            observation = {}
            with rep.Reporter().scope(observation):
                ext(trainer)
            values.append((holder.lr, holder.alpha, dict(observation)))
        seen[name] = values
    assert seen["port"] == seen["jax"]


def test_resumed_exponential_shift_sets_its_value_at_initialize(tmp_path):
    """``initialize`` runs before the first iteration of a resumed
    trainer too: the snapshot's ``t`` gives the value back."""
    from chainermn_tpu_torch.serializers import (DictionarySerializer,
                                                 NpzDeserializer)
    holder = _Holder()
    trainer = _Trainer(str(tmp_path), holder)
    ext = TE.ExponentialShift("lr", 0.5)
    ext.initialize(trainer)
    for _ in range(3):
        ext(trainer)
    s = DictionarySerializer()
    ext.serialize(s)
    fresh, holder2 = TE.ExponentialShift("lr", 0.5), _Holder()
    fresh.serialize(NpzDeserializer(s.target))
    fresh.initialize(_Trainer(str(tmp_path), holder2))
    assert holder2.lr == holder.lr == 0.1 * 0.5 ** 3


def test_make_extension_and_extension_defaults():
    @tmake_extension(trigger=(2, "epoch"), priority=150)
    def ext(trainer):
        pass

    assert (ext.trigger, ext.priority, ext.default_name) == (
        (2, "epoch"), 150, "ext")
    base = TE.LogReport()
    assert base.default_name == "LogReport" and base.name is None


# -- Evaluator, the multi-node evaluator, the aggregator ---------------------

def _models(n_in=784, seed=0):
    """A JAX and a port ``Classifier(MLP)`` holding the same weights."""
    jmodel = JClassifier(JMLP(n_units=UNITS, n_out=10, seed=seed))
    tmodel = TClassifier(TMLP(n_units=UNITS, n_out=10, seed=seed,
                              device="cpu"))
    x = np.zeros((1, n_in), np.float32)
    jmodel(x, np.zeros(1, np.int32))
    tmodel(torch.from_numpy(x), torch.zeros(1, dtype=torch.long))
    return jmodel, tmodel


def test_evaluator_means_and_sample_counts_on_a_ragged_batch():
    _, test = jget_mnist(n_train=10, n_test=70)
    _, ttest = tget_mnist(n_train=10, n_test=70)
    jmodel, tmodel = _models()
    jev = JE.Evaluator(JSerialIterator(test, 32, repeat=False,
                                       shuffle=False), jmodel)
    tev = TE.Evaluator(TSerialIterator(ttest, 32, repeat=False,
                                       shuffle=False), tmodel)
    want, got = jev(), tev()
    assert sorted(got) == sorted(want) == [
        "validation/main/accuracy", "validation/main/loss"]
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), **TOL)
    assert tev._mn_counts == jev._mn_counts == {
        "validation/main/loss": 70, "validation/main/accuracy": 70}
    # a second call starts the iterator again
    np.testing.assert_allclose(float(tev()["validation/main/loss"]),
                               float(got["validation/main/loss"]), rtol=0,
                               atol=0)


def test_multi_node_evaluator_weights_ranks_by_their_examples():
    others = [{"validation/main/loss": (2.0, 10.0),
               "validation/main/accuracy": (0.5, 10.0),
               "validation/main/other": (7.0, 0.0)}]
    results = []
    for create in (ct.create_multi_node_evaluator, tcreate_evaluator):
        class Ev:
            def evaluate(self):
                self._mn_counts = {"validation/main/loss": 30,
                                   "validation/main/accuracy": 30,
                                   "validation/main/other": 0}
                return {"validation/main/loss": np.float32(1.0),
                        "validation/main/accuracy": np.float32(0.9),
                        "validation/main/other": np.float32(3.0)}

        ev = create(Ev(), _Comm(others))
        results.append(ev.evaluate())
    assert results[1] == results[0]
    assert results[1]["validation/main/loss"] == (30 * 1.0 + 10 * 2.0) / 40
    assert results[1]["validation/main/other"] == 5.0   # no counts: mean


def test_observation_aggregator_equals_jax():
    seen = []
    for Agg, wrap in ((JAggregator, np.asarray), (TAggregator,
                                                  torch.tensor)):
        trainer = _Trainer("unused")
        trainer.observation = {"main/loss": wrap(np.float32(1.5))}
        Agg(_Comm([0.5, 4.0]), "main/loss", "main/loss_mean")(trainer)
        seen.append(trainer.observation["main/loss_mean"])
    assert seen[1] == seen[0] == 2.0


def test_parameter_statistics_and_fail_on_non_number():
    jmodel, tmodel = _models(seed=2)
    want = JE.ParameterStatistics(jmodel, report_grads=False)()
    got = TE.ParameterStatistics(tmodel, report_grads=False)()
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-6, atol=1e-7, err_msg=key)
    trainer = _Trainer("unused", TAdam().setup(tmodel))
    TE.FailOnNonNumber()(trainer)
    with torch.no_grad():
        tmodel.predictor.l2.b[3] = float("nan")
    with pytest.raises(RuntimeError, match="NaN"):
        TE.FailOnNonNumber()(trainer)


# -- whole trainers: snapshots across the packages ---------------------------

def _jax_trainer(out, stop=2):
    model = JClassifier(JMLP(n_units=UNITS, n_out=10, seed=0))
    opt = JAdam().setup(model)
    train, test = jget_mnist(n_train=200, n_test=60)
    trainer = JTrainer(JUpdater(JSerialIterator(train, BATCH, seed=0), opt),
                       (stop, "epoch"), out=out)
    trainer.extend(JE.Evaluator(JSerialIterator(test, BATCH, repeat=False,
                                                shuffle=False), model))
    trainer.extend(JE.LogReport())
    trainer.extend(JE.snapshot(), trigger=(1, "epoch"))
    return trainer


def _port_trainer(out, stop=2):
    model = TClassifier(TMLP(n_units=UNITS, n_out=10, seed=0, device="cpu"))
    opt = TAdam().setup(model)
    train, test = tget_mnist(n_train=200, n_test=60)
    trainer = TTrainer(TUpdater(TSerialIterator(train, BATCH, seed=0), opt),
                       (stop, "epoch"), out=out)
    trainer.extend(TE.Evaluator(TSerialIterator(test, BATCH, repeat=False,
                                                shuffle=False), model))
    trainer.extend(TE.LogReport())
    trainer.extend(TE.snapshot(), trigger=(1, "epoch"))
    return trainer


def _log(trainer):
    return trainer.get_extension("LogReport").log


def _metrics_close(got, want):
    assert [e["epoch"] for e in got] == [e["epoch"] for e in want]
    assert [e["iteration"] for e in got] == [e["iteration"] for e in want]
    for g, w in zip(got, want):
        for key in METRICS:
            np.testing.assert_allclose(g[key], w[key], err_msg=key, **TOL)


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """An uninterrupted 2-epoch run in each package, each snapshotting
    after epoch 1 (``snapshot_iter_4``)."""
    tmp = tmp_path_factory.mktemp("trainers")
    jt, tt = _jax_trainer(str(tmp / "jax")), _port_trainer(str(tmp / "port"))
    jt.run()
    tt.run()
    return tmp, jt, tt


def test_uninterrupted_runs_agree(trainers):
    _, jt, tt = trainers
    _metrics_close(_log(tt), _log(jt))
    assert _log(tt)[-1]["main/loss"] < _log(tt)[0]["main/loss"]


def test_a_jax_snapshot_resumes_in_the_port(trainers):
    tmp, jt, _ = trainers
    resumed = _port_trainer(str(tmp / "port_from_jax"))
    tload_npz(str(tmp / "jax" / "snapshot_iter_4"), resumed)
    assert resumed.updater.iteration == 4
    resumed.run()
    # the JAX run's epoch-1 entry came with the snapshot; epoch 2 is the
    # port's continuation of it
    assert _log(resumed)[0] == _log(jt)[0]
    _metrics_close(_log(resumed), _log(jt))
    assert resumed.updater.get_optimizer().t == 8


def test_a_port_snapshot_resumes_in_jax(trainers):
    tmp, _, tt = trainers
    resumed = _jax_trainer(str(tmp / "jax_from_port"))
    jload_npz(str(tmp / "port" / "snapshot_iter_4"), resumed)
    resumed.run()
    assert _log(resumed)[0] == _log(tt)[0]
    _metrics_close(_log(resumed), _log(tt))


def test_the_port_snapshot_has_the_jax_keys(trainers):
    """The same keys, shapes and dtypes, the optimizer's per-step PRNG
    key (``core.rng``, two uint32 words) included."""
    tmp, _, _ = trainers
    with np.load(str(tmp / "jax" / "snapshot_iter_4")) as j, \
            np.load(str(tmp / "port" / "snapshot_iter_4")) as t:
        assert set(t.files) == set(j.files)
        for key in t.files:
            assert t[key].dtype == j[key].dtype, key
            if not key.endswith("log_json"):   # the log's JSON bytes
                assert t[key].shape == j[key].shape, key
        for key in ("updater/iteration", "updater/iterator:main/order",
                    "updater/iterator:main/rng_keys",
                    "updater/optimizer:main/opt_state_0",
                    "extension_triggers/LogReport/previous_iteration"):
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)


def test_a_loaded_rng_key_is_written_back(trainers, tmp_path):
    tmp, _, _ = trainers
    resumed = _port_trainer(str(tmp_path))
    tload_npz(str(tmp / "jax" / "snapshot_iter_4"), resumed)
    path = str(tmp_path / "again.npz")
    tsave_npz(path, resumed)
    with np.load(path) as again, \
            np.load(str(tmp / "jax" / "snapshot_iter_4")) as j:
        assert sorted(again.files) == sorted(j.files)
        np.testing.assert_array_equal(
            again["updater/optimizer:main/rng_key"],
            j["updater/optimizer:main/rng_key"])
        np.testing.assert_array_equal(
            again["updater/optimizer:main/target/predictor/l1/W"],
            j["updater/optimizer:main/target/predictor/l1/W"])


def test_snapshot_object_and_the_loader_signature(tmp_path):
    trainer = _port_trainer(str(tmp_path), stop=1)
    model = trainer.updater.get_optimizer().target
    trainer.extend(TE.snapshot_object(model, "model_{.updater.epoch}"),
                   trigger=(1, "epoch"))
    trainer.run()
    assert sorted(os.listdir(tmp_path)) == ["log", "model_1",
                                            "snapshot_iter_4"]
    fresh = TClassifier(TMLP(n_units=UNITS, n_out=10, seed=5, device="cpu"))
    assert tload_npz(str(tmp_path / "model_1"), fresh) is fresh
    for (p, a), (_, b) in zip(model.namedparams(), fresh.namedparams()):
        assert torch.equal(a, b), p
    # the optimizer's state alone, from under the trainer's path
    opt = TAdam().setup(fresh)
    tload_npz(str(tmp_path / "snapshot_iter_4"), opt,
              path="updater/optimizer:main/")
    assert opt.t == 4 and opt.state_leaves()[0] == 4
    with pytest.raises(KeyError):
        tload_npz(str(tmp_path / "model_1"), TAdam().setup(fresh))
