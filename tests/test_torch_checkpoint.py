"""The port's multi-node checkpointer, its per-rank DCP sibling and the
global except hook against the JAX package's.

Twins of ``tests/extensions_tests/test_checkpoint.py`` (the two Orbax
tests against the DCP sibling), ``tests/resilience_tests/
test_checkpoint_integrity.py``, ``tests/extensions_tests/
test_orbax_trainer.py`` and ``tests/resilience_tests/
test_global_except_hook.py``, on the port's trainer in a world of one
(gloo); then a JAX checkpointer's snapshot resumed in the port, a DCGAN
resume, and one spawned 2-rank gloo world for what needs two processes:
the consensus when one rank lacks the newest generation, the ranks'
distinct files in one directory (the JAX package keys its files by
``inter_rank``, which two processes on one host share), a ZeRO-sharded
resume through the DCP sibling, each rank holding only its chunk, and the
except hook that ``create_communicator`` installs.  The JAX package is
imported inside the tests only.

Tolerances: a resume within the port is compared bitwise (the same
operations on the same values); the JAX snapshot's continuation, 1e-5
absolute (fp32 in two frameworks, other summation orders).
"""

import os
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_communicator import spawn_ranks

JAX_TOL = dict(rtol=0, atol=1e-5)


# -- the port's trainers ---------------------------------------------------------

def _mlp(sizes=(16, 10), seeds=(7, 8)):
    from chainermn_tpu_torch import Chain
    from chainermn_tpu_torch.nn import functions as F
    from chainermn_tpu_torch.nn import links as L

    class MLP(Chain):
        def __init__(self):
            super().__init__()
            self.l1 = L.Linear(784, sizes[0], seed=seeds[0], device="cpu")
            self.l2 = L.Linear(sizes[0], sizes[1], seed=seeds[1],
                               device="cpu")

        def forward(self, x, t):
            return F.softmax_cross_entropy(self.l2(F.relu(self.l1(x))), t)

    return MLP()


@pytest.fixture
def comm():
    from chainermn_tpu_torch import create_communicator
    c = create_communicator("jax_ici", device="cpu")
    yield c
    c.finalize()


def _make_trainer(comm, out, stop, n_train=256, scatter=True, batch=8,
                  sizes=(16, 10), seeds=(7, 8)):
    """The JAX tests' trainer: an MLP under the multi-node SGD."""
    from chainermn_tpu_torch import (create_multi_node_optimizer,
                                     scatter_dataset)
    from chainermn_tpu_torch.core.optimizer import SGD
    from chainermn_tpu_torch.dataset import SerialIterator, get_mnist
    from chainermn_tpu_torch.training import StandardUpdater, Trainer
    model = _mlp(sizes, seeds)
    opt = create_multi_node_optimizer(SGD(lr=0.05), comm).setup(model)
    opt.seed = 11
    train, _ = get_mnist(n_train=n_train, n_test=8)
    if scatter:
        train = scatter_dataset(train, comm, shuffle=True, seed=0)
    it = SerialIterator(train, batch * comm.size, shuffle=False)
    return model, Trainer(StandardUpdater(it, opt), stop, out=out)


def _snapshots(out, prefix):
    return [f for f in os.listdir(out)
            if f.startswith(prefix) and not f.endswith(".sum")]


# -- test_checkpoint.py twins -------------------------------------------------------

def test_checkpoint_save_and_consensus_resume(tmp_path, comm):
    from chainermn_tpu_torch import create_multi_node_checkpointer
    out = str(tmp_path / "run")
    model, trainer = _make_trainer(comm, out, (4, "epoch"))
    cp = create_multi_node_checkpointer(comm, name="ckpt")
    trainer.extend(cp, trigger=(1, "epoch"))
    trainer.run()
    files = _snapshots(out, "ckpt.")
    assert files, "snapshots written"
    model2, trainer2 = _make_trainer(comm, out, (4, "epoch"))
    cp2 = create_multi_node_checkpointer(comm, name="ckpt")
    resumed = cp2.maybe_load(trainer2)
    assert resumed == max(int(f.split(".")[1]) for f in files)
    assert trainer2.updater.iteration == resumed
    assert torch.equal(model.l1.W, model2.l1.W)


def test_checkpoint_gc_keeps_cp_interval(tmp_path, comm):
    from chainermn_tpu_torch import create_multi_node_checkpointer
    out = str(tmp_path / "run")
    _, trainer = _make_trainer(comm, out, (8, "epoch"))
    cp = create_multi_node_checkpointer(comm, name="g", cp_interval=3)
    trainer.extend(cp, trigger=(1, "epoch"))
    trainer.run()
    files = _snapshots(out, "g.")
    assert len(files) <= 3 + 1
    sums = [f for f in os.listdir(out) if f.endswith(".sum")]
    assert {f + ".sum" for f in files} == set(sums)
    assert cp.stats["snapshots"] == 8
    assert cp.stats["gc"] >= 4


def test_maybe_load_empty_dir_returns_none(tmp_path, comm):
    from chainermn_tpu_torch import create_multi_node_checkpointer
    _, trainer = _make_trainer(comm, str(tmp_path / "none"), (4, "epoch"))
    cp = create_multi_node_checkpointer(comm, name="x")
    assert cp.maybe_load(trainer) is None
    assert trainer.updater.iteration == 0


def test_dcp_checkpointer_roundtrip(tmp_path):
    """Twin of ``test_orbax_checkpointer_roundtrip``: a link's parameters
    and running statistics through ``save_link``/``restore_link``."""
    from chainermn_tpu_torch.extensions.orbax_checkpoint import \
        OrbaxCheckpointer
    from chainermn_tpu_torch.nn import links as L
    link = L.BatchNormalization(4, device="cpu")
    with torch.no_grad():
        link.gamma.fill_(3.0)
        link.avg_mean.fill_(0.5)
    cp = OrbaxCheckpointer(str(tmp_path / "dcp"), max_to_keep=2)
    cp.save_link(1, link)
    cp.save_link(2, link)
    cp.save_link(3, link)
    assert cp.latest_step() == 3 and cp.all_steps() == [2, 3]
    link2 = L.BatchNormalization(4, device="cpu")
    assert cp.restore_link(link2)
    assert torch.equal(link2.gamma, torch.full((4,), 3.0))
    assert torch.equal(link2.avg_mean, torch.full((4,), 0.5))
    assert not OrbaxCheckpointer(str(tmp_path / "empty")).restore_link(link2)
    cp.close()


def test_dcp_step_is_whole_or_absent(tmp_path, monkeypatch):
    """A step is written to a tmp directory and renamed: a write that
    fails leaves no step and no tmp directory."""
    import torch.distributed.checkpoint as dcp
    from chainermn_tpu_torch.extensions.orbax_checkpoint import \
        OrbaxCheckpointer
    cp = OrbaxCheckpointer(str(tmp_path / "dcp"))
    cp.save(1, {"a": torch.arange(3.0), "n": 5})
    assert cp.restore(1)["a"].tolist() == [0.0, 1.0, 2.0]

    def boom(*a, **kw):
        raise OSError("disk gone mid-write")

    monkeypatch.setattr(dcp, "save", boom)
    with pytest.raises(OSError):
        cp.save(2, {"a": torch.arange(3.0)})
    assert os.listdir(cp.directory) == ["1"]


# -- test_checkpoint_integrity.py twins -----------------------------------------------

def _run_with_checkpoints(comm, out, iters=12, trigger=(3, "iteration"),
                          **kw):
    from chainermn_tpu_torch import create_multi_node_checkpointer
    model, trainer = _integrity_trainer(comm, out, iters)
    cp = create_multi_node_checkpointer(comm, name="c", **kw)
    trainer.extend(cp, trigger=trigger)
    trainer.run()
    return model, cp


def _integrity_trainer(comm, out, iters=12):
    return _make_trainer(comm, out, (iters, "iteration"), n_train=64,
                         scatter=False, sizes=(8, 10), seeds=(3, 4))


def test_snapshots_carry_verifying_sidecars(tmp_path, comm):
    out = str(tmp_path / "run")
    _, cp = _run_with_checkpoints(comm, out)
    files = _snapshots(out, "c.")
    assert files
    for f in files:
        assert os.path.exists(os.path.join(out, f + ".sum"))
        assert cp._verify(os.path.join(out, f))
    assert cp.stats["verify_failures"] == 0


def test_corrupt_snapshot_excluded_from_consensus(tmp_path, comm):
    from chainermn_tpu_torch import create_multi_node_checkpointer
    out = str(tmp_path / "run")
    _run_with_checkpoints(comm, out)  # snapshots at 3/6/9/12
    with open(os.path.join(out, "c.12.0"), "r+b") as f:
        f.seek(10)
        f.write(b"\xde\xad\xbe\xef")
    _, trainer2 = _integrity_trainer(comm, out)
    cp2 = create_multi_node_checkpointer(comm, name="c")
    assert cp2.maybe_load(trainer2) == 9
    assert trainer2.updater.iteration == 9
    assert cp2.stats["verify_failures"] == 1


def test_all_generations_corrupt_returns_none(tmp_path, comm):
    from chainermn_tpu_torch import create_multi_node_checkpointer
    out = str(tmp_path / "run")
    _run_with_checkpoints(comm, out)
    for f in _snapshots(out, "c."):
        with open(os.path.join(out, f), "r+b") as fh:
            fh.seek(4)
            fh.write(b"\x00\x00\x00\x00")
    _, trainer2 = _integrity_trainer(comm, out)
    cp2 = create_multi_node_checkpointer(comm, name="c")
    assert cp2.maybe_load(trainer2) is None
    assert trainer2.updater.iteration == 0


def test_sidecarless_legacy_snapshot_still_admitted(tmp_path, comm):
    from chainermn_tpu_torch import create_multi_node_checkpointer
    out = str(tmp_path / "run")
    _run_with_checkpoints(comm, out)
    for f in os.listdir(out):
        if f.endswith(".sum"):
            os.remove(os.path.join(out, f))
    _, trainer2 = _integrity_trainer(comm, out)
    cp2 = create_multi_node_checkpointer(comm, name="c")
    assert cp2.maybe_load(trainer2) == 12


def test_gc_protects_consensus_resumed_generation(tmp_path, comm):
    from chainermn_tpu_torch import create_multi_node_checkpointer
    out = str(tmp_path / "run")
    _run_with_checkpoints(comm, out, iters=6, cp_interval=2, gc_interval=2)
    _, trainer2 = _integrity_trainer(comm, out, iters=18)
    cp2 = create_multi_node_checkpointer(comm, name="c", cp_interval=2,
                                         gc_interval=2)
    assert cp2.maybe_load(trainer2) == 6
    assert cp2._protected_iteration == 6
    trainer2.extend(cp2, trigger=(3, "iteration"))
    trainer2.run()  # saves 9/12/15/18
    files = _snapshots(out, "c.")
    assert "c.6.0" in files, \
        "GC must never delete the generation consensus resumed from"
    assert "c.18.0" in files and "c.15.0" in files
    assert len(files) == 3


def test_resave_after_rollback_keeps_one_entry_per_generation(tmp_path,
                                                             comm):
    from chainermn_tpu_torch import create_multi_node_checkpointer
    out = str(tmp_path / "run")
    _, trainer = _integrity_trainer(comm, out, iters=3)
    cp = create_multi_node_checkpointer(comm, name="c", cp_interval=2,
                                        gc_interval=2)
    cp.save(trainer, 3)
    cp.save(trainer, 3)
    assert cp._files.count("c.3.0") == 1
    for it in (6, 9, 12):
        cp.save(trainer, it)
    assert os.path.exists(os.path.join(out, "c.9.0"))
    assert os.path.exists(os.path.join(out, "c.12.0"))


def test_write_fault_leaves_no_visible_snapshot(tmp_path, comm):
    from chainermn_tpu_torch import create_multi_node_checkpointer
    out = str(tmp_path / "run")
    _, trainer = _integrity_trainer(comm, out, iters=3)
    cp = create_multi_node_checkpointer(comm, name="c")

    def boom(tmp, fname):
        raise OSError("disk gone mid-write")

    cp._write_fault_hook = boom
    with pytest.raises(OSError):
        cp.save(trainer, 3)
    leftovers = os.listdir(out) if os.path.isdir(out) else []
    assert [f for f in leftovers if f.startswith("c.3")] == [], leftovers


def test_save_and_load_leave_their_spans(tmp_path, comm):
    """``train/checkpoint_serialize`` around a save,
    ``recover/consensus_load`` around a consensus load."""
    from chainermn_tpu_torch import create_multi_node_checkpointer
    from chainermn_tpu_torch import observability
    out = str(tmp_path / "run")
    _, trainer = _integrity_trainer(comm, out, iters=3)
    cp = create_multi_node_checkpointer(comm, name="c")
    prev = observability.mode()
    observability.set_mode("events")
    try:
        observability.reset_tracer()
        cp.save(trainer, 3)
        cp.maybe_load(trainer)
        names = [e["name"] for e in observability.tracer().events()]
    finally:
        observability.set_mode(prev)
        observability.reset_tracer()
    assert "train/checkpoint_serialize" in names
    assert "recover/consensus_load" in names


# -- test_orbax_trainer.py twins (the DCP sibling) -------------------------------------

def test_dcp_save_and_consensus_resume_continues_exactly(tmp_path, comm):
    from chainermn_tpu_torch.extensions import \
        create_multi_node_orbax_checkpointer as create
    ckpt_dir = str(tmp_path / "dcp")
    golden, trainer_g = _make_trainer(comm, str(tmp_path / "g"),
                                      (4, "epoch"))
    trainer_g.run()
    model1, trainer1 = _make_trainer(comm, str(tmp_path / "r1"),
                                     (2, "epoch"))
    cp1 = create(comm, ckpt_dir)
    trainer1.extend(cp1, trigger=(1, "epoch"))
    trainer1.run()
    assert cp1.stats["snapshots"] == 2
    saved = trainer1.updater.iteration
    model2, trainer2 = _make_trainer(comm, str(tmp_path / "r2"),
                                     (4, "epoch"))
    cp2 = create(comm, ckpt_dir)
    assert cp2.maybe_load(trainer2) == saved
    assert trainer2.updater.iteration == saved
    assert torch.equal(model2.l1.W, model1.l1.W)
    trainer2.extend(cp2, trigger=(1, "epoch"))
    trainer2.run()
    assert torch.equal(model2.l1.W, golden.l1.W)
    assert os.listdir(ckpt_dir) == ["rank0"]


def test_dcp_maybe_load_empty_dir_returns_none(tmp_path, comm):
    from chainermn_tpu_torch.extensions import \
        create_multi_node_orbax_checkpointer as create
    _, trainer = _make_trainer(comm, str(tmp_path / "r"), (1, "epoch"))
    assert create(comm, str(tmp_path / "none")).maybe_load(trainer) is None


def test_dcp_gc_keeps_cp_interval_and_pins_protected(tmp_path, comm):
    from chainermn_tpu_torch.extensions import \
        create_multi_node_orbax_checkpointer as create
    ckpt_dir = str(tmp_path / "dcp")
    _, trainer = _make_trainer(comm, str(tmp_path / "r"), (1, "epoch"))
    cp = create(comm, ckpt_dir, cp_interval=2)
    for it in (1, 2, 3, 4, 5):
        cp.save(trainer, it)
    assert cp._ckpt.all_steps() == [4, 5]
    assert cp.stats["gc"] == 3
    _, trainer2 = _make_trainer(comm, str(tmp_path / "r2"), (1, "epoch"))
    cp2 = create(comm, ckpt_dir, cp_interval=2)
    assert cp2.maybe_load(trainer2) == 5
    for it in (6, 7, 8):
        cp2.save(trainer2, it)
    steps = cp2._ckpt.all_steps()
    assert 5 in steps, "the resumed generation must never be swept"
    assert steps[-2:] == [7, 8]


# -- test_global_except_hook.py twins ----------------------------------------------

@pytest.fixture
def fresh_hook_state(monkeypatch):
    from chainermn_tpu_torch import global_except_hook
    monkeypatch.setattr(global_except_hook, "_hook_installed", False)
    original = sys.excepthook
    yield global_except_hook
    sys.excepthook = original


def test_chains_previously_installed_hook(fresh_hook_state, monkeypatch):
    seen, exits = [], []

    def previous_hook(exc_type, exc_value, exc_tb):
        seen.append((exc_type, str(exc_value)))

    monkeypatch.setattr(sys, "excepthook", previous_hook)
    monkeypatch.setattr(os, "_exit", exits.append)
    fresh_hook_state.add_hook()
    assert sys.excepthook is not previous_hook
    sys.excepthook(RuntimeError, RuntimeError("boom"), None)
    assert seen == [(RuntimeError, "boom")]
    assert exits == [1]


def test_keyboard_interrupt_does_not_hard_exit(fresh_hook_state,
                                              monkeypatch):
    exits = []
    monkeypatch.setattr(os, "_exit", exits.append)
    fresh_hook_state.add_hook()
    sys.excepthook(KeyboardInterrupt, KeyboardInterrupt(), None)
    assert exits == []


def test_add_hook_idempotent(fresh_hook_state):
    fresh_hook_state.add_hook()
    installed = sys.excepthook
    fresh_hook_state.add_hook()
    assert sys.excepthook is installed


@pytest.mark.parametrize("flag,installed", [("1", True), ("0", False),
                                            (None, False)])
def test_the_flag_and_a_world_of_one(fresh_hook_state, monkeypatch, comm,
                                     flag, installed):
    """``CHAINERMN_TPU_FORCE_ABORT_ON_EXCEPTION`` forces the hook in or
    out; without it a world of one (this process's group) gets none."""
    if flag is None:
        monkeypatch.delenv("CHAINERMN_TPU_FORCE_ABORT_ON_EXCEPTION",
                           raising=False)
    else:
        monkeypatch.setenv("CHAINERMN_TPU_FORCE_ABORT_ON_EXCEPTION", flag)
    fresh_hook_state._add_hook_if_enabled()
    assert fresh_hook_state._hook_installed is installed


# -- a JAX checkpointer's snapshot resumes in the port --------------------------------

def test_a_jax_checkpointer_snapshot_resumes_in_the_port(tmp_path, comm):
    """The JAX MLP trainer (8 CPU devices, a global batch of 64) saves
    through its checkpointer after epoch 1; the port's trainer (a world
    of one, batch 64) consensus-loads that file and its next 3 steps
    match the JAX trainer's next 3."""
    import chainermn_tpu as jct
    from chainermn_tpu import F as JF
    from chainermn_tpu import L as JL
    from chainermn_tpu.core.optimizer import SGD as JSGD
    from chainermn_tpu.dataset import SerialIterator as JSI
    from chainermn_tpu.dataset import get_mnist as jget_mnist
    from chainermn_tpu.training import StandardUpdater as JU
    from chainermn_tpu.training import Trainer as JTrainer
    from chainermn_tpu_torch import create_multi_node_checkpointer

    class JMLP(jct.Chain):
        def __init__(self):
            super().__init__()
            with self.init_scope():
                self.l1 = JL.Linear(784, 16, seed=7)
                self.l2 = JL.Linear(16, 10, seed=8)

        def forward(self, x, t):
            return JF.softmax_cross_entropy(self.l2(JF.relu(self.l1(x))), t)

    out = str(tmp_path / "run")
    jcomm = jct.create_communicator("jax_ici")
    jmodel = JMLP()
    jopt = jct.create_multi_node_optimizer(JSGD(lr=0.05), jcomm).setup(
        jmodel)
    train, _ = jget_mnist(n_train=256, n_test=8)
    train = jct.scatter_dataset(train, jcomm, shuffle=True, seed=0)
    jtrainer = JTrainer(JU(JSI(train, 8 * jcomm.size, shuffle=False), jopt),
                        (4 + 3, "iteration"), out=out)
    jtrainer.extend(jct.create_multi_node_checkpointer(jcomm, name="j"),
                    trigger=(4, "iteration"))
    jtrainer.run()
    assert "j.4.0" in os.listdir(out)
    model, trainer = _make_trainer(comm, str(tmp_path / "port"),
                                   (4 + 3, "iteration"),
                                   batch=8 * jcomm.size)
    cp = create_multi_node_checkpointer(comm, name="j", path=out)
    assert cp.maybe_load(trainer) == 4
    assert trainer.updater.iteration == 4
    trainer.run()
    for name in ("l1", "l2"):
        for p in ("W", "b"):
            np.testing.assert_allclose(
                getattr(getattr(model, name), p).detach().numpy(),
                np.asarray(getattr(getattr(jmodel, name), p).array),
                err_msg=f"{name}/{p}", **JAX_TOL)


# -- a DCGAN resume within the port ---------------------------------------------------

def _dcgan_trainer(out, stop, seed=5):
    """A small DCGAN trainer whose noise is drawn per iteration from
    ``seed`` and the iteration (the snapshot carries no noise key)."""
    from chainermn_tpu_torch.core import rng
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.dataset import SerialIterator
    from chainermn_tpu_torch.models import (DCGANUpdater, Discriminator,
                                            Generator)
    from chainermn_tpu_torch.training import Trainer
    gen = Generator(n_hidden=16, ch=32, seed=0, device="cpu")
    dis = Discriminator(ch=32, seed=1, device="cpu")
    data = np.random.RandomState(0).normal(0, 0.5, (24, 3, 32, 32)) \
        .astype(np.float32)
    updater = DCGANUpdater(SerialIterator(data, 8, shuffle=True, seed=2),
                           Adam(alpha=2e-4, beta1=0.5).setup(gen),
                           Adam(alpha=2e-4, beta1=0.5).setup(dis))
    draw = gen.make_hidden
    gen.make_hidden = lambda n, key=None: draw(
        n, rng.fold_in(rng.make_key(seed), updater.iteration))
    return gen, dis, Trainer(updater, (stop, "iteration"), out=out)


def _all_state(trainer):
    from chainermn_tpu_torch.serializers.npz import DictionarySerializer
    s = DictionarySerializer()
    trainer.updater.serialize(s)
    return s.target


def test_dcgan_resume_is_bitwise(tmp_path, comm):
    """4 iterations uninterrupted against 2, a new trainer's
    ``maybe_load`` and 2 more: every parameter, Adam leaf and running
    statistic of both nets, bitwise.  The snapshot carries no noise key:
    a resumed updater starts its own stream again from its seed."""
    from chainermn_tpu_torch import create_multi_node_checkpointer
    _, _, golden = _dcgan_trainer(str(tmp_path / "g"), 4)
    golden.run()
    out = str(tmp_path / "r")
    _, _, first = _dcgan_trainer(out, 2)
    first.extend(create_multi_node_checkpointer(comm, name="dcgan"),
                 trigger=(2, "iteration"))
    first.run()
    _, _, second = _dcgan_trainer(out, 4)
    cp = create_multi_node_checkpointer(comm, name="dcgan")
    assert cp.maybe_load(second) == 2
    assert np.array_equal(second.updater._key,
                          _dcgan_trainer(out, 4)[2].updater._key)
    second.run()
    got, want = _all_state(second), _all_state(golden)
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert any(k.endswith("bn1/avg_mean") for k in want)


# -- one 2-rank gloo world ------------------------------------------------------------

WORLD = 2


def _zero_model():
    from chainermn_tpu_torch.models import MLP, Classifier
    return Classifier(MLP(n_units=16, n_out=3, seed=0, device="cpu"))


def _two_rank_worker(rank, out_dir):
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_checkpointer,
                                     create_multi_node_optimizer,
                                     global_except_hook)
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.extensions import \
        create_multi_node_orbax_checkpointer
    from chainermn_tpu_torch.extensions.orbax_checkpoint import \
        OrbaxCheckpointer
    os.environ.pop("CHAINERMN_TPU_FORCE_ABORT_ON_EXCEPTION", None)
    hook_before = global_except_hook._hook_installed
    comm = create_communicator("jax_ici", device="cpu")
    r = {"hook": (hook_before, global_except_hook._hook_installed,
                  sys.excepthook is not sys.__excepthook__)}
    # consensus: snapshots at 3/6/9/12 in ONE directory; rank 1 loses its
    # newest, so every rank resumes from 9
    shared = os.path.join(out_dir, "shared")
    _, trainer = _integrity_trainer(comm, shared)
    cp = create_multi_node_checkpointer(comm, name="c")
    trainer.extend(cp, trigger=(3, "iteration"))
    trainer.run()
    comm.allreduce(torch.zeros(1))     # both ranks have written
    r["files"] = sorted(f for f in os.listdir(shared)
                        if f.startswith("c."))
    if rank == 1:
        os.remove(os.path.join(shared, "c.12.1"))
    comm.allreduce(torch.zeros(1))
    model2, trainer2 = _integrity_trainer(comm, shared)
    r["resumed"] = create_multi_node_checkpointer(
        comm, name="c").maybe_load(trainer2)
    r["resumed_W"] = model2.l1.W.detach().clone()

    # ZeRO: the raw DCP checkpointer holds this rank's chunk only
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.normal(0, 1, (16, 12)).astype(np.float32))
    t = torch.from_numpy(rng.randint(0, 3, 16).astype(np.int64))
    xs, ts = x[rank * 8:(rank + 1) * 8], t[rank * 8:(rank + 1) * 8]

    def fresh():
        model = _zero_model()
        comm.bcast_data(model)
        opt = create_multi_node_optimizer(
            MomentumSGD(lr=0.1, momentum=0.9), comm,
            zero_sharding=True).setup(model)
        return model, opt

    model_a, opt_a = fresh()
    for _ in range(3):
        opt_a.update(model_a, xs, ts)
    cp = OrbaxCheckpointer(os.path.join(out_dir, "raw", f"rank{rank}"))
    state = opt_a.actual_optimizer._state
    r["chunk"] = {k: tuple(v["trace"].shape) for k, v in state.items()}
    r["flat"] = opt_a._flat_layout()
    cp.save(3, {"model": {p: v.detach() for p, v in model_a.namedparams()},
                "opt": state})
    for _ in range(2):
        opt_a.update(model_a, xs, ts)
    model_b, opt_b = fresh()
    opt_b.update(model_b, xs, ts)
    template = {
        "model": {p: v.detach().clone() for p, v in model_b.namedparams()},
        "opt": {k: {s: (v.clone() if isinstance(v, torch.Tensor) else v)
                    for s, v in st.items()}
                for k, st in opt_b.actual_optimizer._state.items()}}
    restored = cp.restore(3, template=template)
    with torch.no_grad():
        for p, v in model_b.namedparams():
            v.copy_(restored["model"][p])
    opt_b.actual_optimizer._state = restored["opt"]
    r["restored_count"] = {k: st["count"] for k, st in
                           restored["opt"].items()}
    for _ in range(2):
        opt_b.update(model_b, xs, ts)
    r["raw_a"] = {p: v.detach().clone() for p, v in model_a.namedparams()}
    r["raw_b"] = {p: v.detach().clone() for p, v in model_b.namedparams()}

    # ZeRO through the trainer: the DCP extension's per-rank snapshot
    # resumes bitwise, and its flat state is this rank's chunk
    def zero_trainer(out, epochs):
        from chainermn_tpu_torch.dataset import SerialIterator, TupleDataset
        from chainermn_tpu_torch.training import StandardUpdater, Trainer
        model, opt = fresh()
        data = TupleDataset(xs.numpy(), ts.numpy())
        return model, Trainer(StandardUpdater(
            SerialIterator(data, 4, shuffle=False), opt), (epochs, "epoch"),
            out=out)

    golden, tg = zero_trainer(os.path.join(out_dir, f"g{rank}"), 4)
    tg.run()
    dcp_dir = os.path.join(out_dir, "dcp")
    _, t1 = zero_trainer(os.path.join(out_dir, f"a{rank}"), 2)
    t1.extend(create_multi_node_orbax_checkpointer(comm, dcp_dir),
              trigger=(1, "epoch"))
    t1.run()
    model2, t2 = zero_trainer(os.path.join(out_dir, f"b{rank}"), 4)
    cp2 = create_multi_node_orbax_checkpointer(comm, dcp_dir)
    r["dcp_resumed"] = cp2.maybe_load(t2)
    t2.run()
    tree = cp2._ckpt.restore(r["dcp_resumed"])
    r["dcp_leaves"] = {k: np.shape(v) for k, v in tree.items()
                       if "opt_state" in k or k.endswith("local_chunk")}
    r["dcp_local_chunk"] = np.asarray(
        tree["updater/optimizer:main/local_chunk"]).tolist()
    r["dcp_golden"] = {p: v.detach().clone()
                       for p, v in golden.namedparams()}
    r["dcp_resumed_params"] = {p: v.detach().clone()
                               for p, v in model2.namedparams()}
    return r


def test_two_ranks_consensus_files_and_zero_resume(tmp_path):
    r0, r1 = spawn_ranks(tmp_path, _two_rank_worker, world=WORLD,
                         out_dir=str(tmp_path))
    # create_communicator installed the fail-stop hook in a world of two
    assert r0["hook"] == r1["hook"] == (False, True, True)
    # the ranks wrote distinct files into one directory
    want = sorted(f"c.{it}.{rank}{sfx}" for it in (3, 6, 9, 12)
                  for rank in (0, 1) for sfx in ("", ".sum"))
    assert r0["files"] == r1["files"] == want
    # rank 1 lacked the newest generation: both resumed from 9
    assert r0["resumed"] == r1["resumed"] == 9
    assert torch.equal(r0["resumed_W"], r1["resumed_W"])
    # the raw checkpointer held each rank's chunk, and the run continued
    # bitwise
    n, n_pad, lo, hi = r0["flat"]
    assert set(r0["chunk"].values()) == {(n_pad // WORLD,)}
    assert r1["flat"][2:] == (n_pad // WORLD, n_pad)
    assert set(r0["restored_count"].values()) == {3}
    for r in (r0, r1):
        for p, v in r["raw_a"].items():
            assert torch.equal(v, r["raw_b"][p]), p
    # the extension's per-rank snapshot: chunk-sized leaves, bitwise
    assert r0["dcp_resumed"] == r1["dcp_resumed"] == 4
    assert r0["dcp_local_chunk"] == [2, 0] and r1["dcp_local_chunk"] == [2, 1]
    leaves = [s for k, s in r0["dcp_leaves"].items()
              if "opt_state_" in k and "len" not in k and s != ()]
    assert leaves and set(leaves) == {(n_pad // WORLD,)}
    for r in (r0, r1):
        for p, v in r["dcp_golden"].items():
            assert torch.equal(v, r["dcp_resumed_params"][p]), p
