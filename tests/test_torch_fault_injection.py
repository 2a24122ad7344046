"""The port's fault schedule and fault-injection communicator against the
JAX package's (``tests/resilience_tests/test_fault_schedule.py`` and
``test_fault_injection_communicator.py``).

The schedule is a host-only module copied into the port: a JAX and a port
``FaultSchedule`` built from the same specs and seed, driven through the
same op sequence, must fire at the same call indices with the same
actions, serialize to the same dict, and raise the same kinds of
exception.  The communicator twins drive the port's
``FaultInjectionCommunicator`` over the port's ``DummyCommunicator`` and a
world-of-one ``MeshCommunicator`` (CPU, gloo).  Every check is exact.
"""

import json
import os

import numpy as np
import pytest
import torch

from chainermn_tpu_torch import create_communicator
from chainermn_tpu_torch.communicators import (DummyCommunicator,
                                               FaultInjectionCommunicator,
                                               FaultSchedule, FaultSpec,
                                               InjectedFault, RankPreempted,
                                               bind_host_channel,
                                               schedule_from_env)
from chainermn_tpu_torch.communicators._host_channel import HostChannel

CHAOS_SEED = int(os.environ.get("CHAINERMN_TPU_CHAOS_SEED", "1234"))

#: spec sets covering every matching rule: nth, prob, count budgets,
#: wildcards, exhausted probabilistic specs, rank and step targeting
SPEC_SETS = {
    "nth": [dict(op="allreduce", nth=3), dict(op="bcast_obj", nth=2,
                                              action="drop")],
    "prob": [dict(op="allgather_obj", prob=0.25, count=None),
             dict(op="*", prob=0.1, count=3, action="delay", delay_s=0.5)],
    "exhausted_prob": [dict(op="x", prob=0.9, count=2),
                       dict(op="x", prob=0.3, count=None)],
    "rank": [dict(op="bcast_obj", nth=7, action="preempt", rank=1),
             dict(op="allreduce", prob=0.5, count=None, rank=0)],
    "step": [dict(op="convert", prob=0.5, count=None, step="CONVERTING"),
             dict(op="convert", nth=4, action="preempt")],
    "hc": [dict(op="hc.get", nth=3), dict(op="hc.put", nth=1,
                                          action="lost_chunk"),
           dict(op="hc.chunk", prob=0.2, count=None)],
}
OPS = (["allreduce", "bcast_obj", "allgather_obj", "x", "convert",
        "hc.get", "hc.put", "hc.chunk"] * 25)


def _drive(schedule, ops, steps=None):
    out = []
    for i, op in enumerate(ops):
        step = None if steps is None else steps[i % len(steps)]
        fault = schedule.on_call(op, step=step)
        if fault is not None:
            exc = None
            if fault.action in ("raise", "preempt", "drop"):
                e = fault.make_exception()
                exc = (type(e).__name__, str(e))
            out.append((fault.op, fault.call_index, fault.action, exc))
    return out, list(schedule.fired)


@pytest.mark.parametrize("name", sorted(SPEC_SETS))
@pytest.mark.parametrize("rank", [None, 0, 1])
def test_schedule_replays_the_jax_schedule(name, rank):
    """Same specs and seed, same op sequence: the same faults at the same
    call indices, on every rank binding, and the same dict."""
    from chainermn_tpu.communicators import fault_schedule as jfs
    specs = SPEC_SETS[name]
    steps = ["CONVERTING", None, "DRAINING"]
    for seed in (CHAOS_SEED, CHAOS_SEED + 1):
        port = FaultSchedule(specs, seed=seed, rank=rank)
        ref = jfs.FaultSchedule(specs, seed=seed, rank=rank)
        assert _drive(port, OPS, steps) == _drive(ref, OPS, steps)
        assert port.to_dict() == ref.to_dict()
        assert [port.calls(op) for op in set(OPS)] \
            == [ref.calls(op) for op in set(OPS)]
        port.reset()
        ref.reset()
        assert _drive(port, OPS[:40]) == _drive(ref, OPS[:40])


def test_schedule_crosses_packages_as_json(monkeypatch, tmp_path):
    """A JAX schedule's JSON builds the same port schedule, inline or
    from a file (``CHAINERMN_TPU_FAULT_SCHEDULE``); the spec checks raise
    as there."""
    from chainermn_tpu.communicators import fault_schedule as jfs
    ref = jfs.FaultSchedule([jfs.FaultSpec(op="allreduce", nth=5,
                                           action="delay", delay_s=1.5,
                                           count=2, note="straggler"),
                             jfs.FaultSpec(op="bcast_obj", nth=2,
                                           action="preempt", rank=1)],
                            seed=77)
    text = json.dumps(ref.to_dict())
    assert FaultSchedule.from_json(text).to_dict() == ref.to_dict()
    monkeypatch.setenv("CHAINERMN_TPU_FAULT_SCHEDULE", text)
    assert schedule_from_env().to_dict() == ref.to_dict()
    p = tmp_path / "sched.json"
    p.write_text(text)
    monkeypatch.setenv("CHAINERMN_TPU_FAULT_SCHEDULE", f"@{p}")
    assert schedule_from_env().to_dict() == ref.to_dict()
    monkeypatch.delenv("CHAINERMN_TPU_FAULT_SCHEDULE")
    assert schedule_from_env() is None
    for bad in (dict(op="x", action="explode", nth=1), dict(op="x"),
                dict(op="x", nth=2, prob=0.5), dict(op="x", nth=0),
                dict(op="x", nth=1, rank=-1), dict(op="x", nth=1, step="")):
        with pytest.raises(ValueError):
            FaultSpec(**bad)
        with pytest.raises(ValueError):
            jfs.FaultSpec(**bad)


# -- the communicator twins --------------------------------------------------

def _wrap(specs, seed=0, base=None, sleep=None):
    sched = FaultSchedule(specs, seed=seed)
    kwargs = {} if sleep is None else {"sleep": sleep}
    return FaultInjectionCommunicator(base or DummyCommunicator(), sched,
                                      **kwargs), sched


def test_raise_on_nth_collective():
    comm, sched = _wrap([dict(op="allreduce", nth=2)])
    assert torch.equal(comm.allreduce(torch.ones(3)), torch.ones(3))
    with pytest.raises(InjectedFault):
        comm.allreduce(torch.ones(3))
    assert torch.equal(comm.allreduce(torch.ones(3)), torch.ones(3))
    assert comm.injected == 1
    assert sched.fired == [("allreduce", 2, "raise")]


def test_drop_on_send_obj_loses_message():
    comm, _ = _wrap([dict(op="send_obj", nth=1, action="drop")])
    comm.send_obj({"lost": True}, dest=0)
    comm.send_obj({"kept": True}, dest=0)
    assert comm.recv_obj(source=0) == {"kept": True}


def test_drop_on_collective_returns_input_unchanged():
    comm, _ = _wrap([dict(op="allreduce", nth=1, action="drop")])
    x = torch.arange(4.0)
    assert comm.allreduce(x) is x


def test_drop_on_kwargs_invoked_collective_returns_input():
    comm, _ = _wrap([dict(op="bcast_obj", nth=1, action="drop")])
    payload = {"iteration": 7}
    assert comm.bcast_obj(obj=payload) is payload


def test_drop_without_silent_result_degrades_to_raise():
    comm, _ = _wrap([dict(op="allgather_obj", nth=1, action="drop"),
                     dict(op="scatter", nth=1, action="drop"),
                     dict(op="reduce_scatter_grad", nth=1, action="drop")])
    with pytest.raises(InjectedFault):
        comm.allgather_obj("x")
    with pytest.raises(InjectedFault):
        comm.scatter([1, 2, 3])
    # the port's exchange entry points are intercepted as well
    with pytest.raises(InjectedFault):
        comm.reduce_scatter_grad(torch.ones(4))


def test_preempt_action_raises_rank_preempted():
    comm, sched = _wrap([dict(op="allreduce", nth=1, action="preempt",
                              rank=0)])
    assert sched.rank == 0
    with pytest.raises(RankPreempted) as e:
        comm.allreduce(torch.ones(2))
    assert e.value.rank == 0
    comm1, _ = _wrap([dict(op="allreduce", nth=1, action="preempt",
                           rank=1)])
    assert torch.equal(comm1.allreduce(torch.ones(2)), torch.ones(2))


def test_preempt_not_absorbed_by_host_channel_retry():
    class _Clock:
        t = 0.0

        def __call__(self):
            return self.t

        def sleep(self, s):
            self.t += s

    clock = _Clock()
    ch = HostChannel(namespace="t", client=object(), clock=clock,
                     sleep=clock.sleep, process_id=0, num_processes=2,
                     timeout_ms=1000)
    calls = []

    def fn(remaining_ms):
        calls.append(remaining_ms)
        raise RankPreempted("hc.get", 1, rank=0)

    with pytest.raises(RankPreempted):
        ch._retrying("p2p", "k", fn)
    assert len(calls) == 1


def test_delay_uses_injected_sleep_then_executes():
    slept = []
    comm, _ = _wrap([dict(op="bcast_obj", nth=2, action="delay",
                          delay_s=7.5)], sleep=slept.append)
    assert comm.bcast_obj("a") == "a"
    assert comm.bcast_obj("b") == "b"
    assert slept == [7.5]


def test_topology_and_delegation_transparent():
    base = DummyCommunicator()
    comm, _ = _wrap([], base=base)
    assert (comm.rank, comm.size) == (base.rank, base.size)
    assert (comm.intra_rank, comm.intra_size) == (0, 1)
    assert (comm.inter_rank, comm.inter_size) == (0, 1)
    assert comm.split(0, 0) is base.split(0, 0)
    assert comm.name == "dummy"
    assert comm._obj_mailbox is base._obj_mailbox


def test_shared_schedule_same_sites_across_ranks():
    specs = [dict(op="allgather_obj", prob=0.25, count=None)]
    ops = ["allgather_obj"] * 50 + ["bcast_obj"] * 10

    def run(seed):
        comm, sched = _wrap(specs, seed=seed)
        for op in ops:
            try:
                getattr(comm, op)("payload")
            except InjectedFault:
                pass
        return list(sched.fired)

    assert run(CHAOS_SEED) == run(CHAOS_SEED)
    assert run(CHAOS_SEED) != run(CHAOS_SEED + 1)


def test_mesh_base_eager_collectives_still_work():
    base = create_communicator("jax_ici", device="cpu")
    try:
        comm, _ = _wrap([dict(op="allreduce", nth=3)], base=base)
        out = comm.allreduce(torch.arange(4.0), op="mean")
        assert torch.equal(out, torch.arange(4.0))
        assert comm.allgather_obj("x") == ["x"] * base.size
        assert comm.calls["allreduce"] == 1   # delegated to the base
    finally:
        base.finalize()


def test_finalize_unbinds_only_own_host_channel_hook():
    class StubChannel:
        _fault_hook = None

        def set_fault_hook(self, hook):
            self._fault_hook = hook

    class StubBase(DummyCommunicator):
        def __init__(self, ch):
            super().__init__()
            self._ch = ch

        def _host_channel(self):
            return self._ch

    ch = StubChannel()
    sched = FaultSchedule([], seed=0)
    bind_host_channel(ch, sched)
    comm = FaultInjectionCommunicator(StubBase(ch), sched)
    assert ch._fault_hook is not None
    comm.finalize()
    assert ch._fault_hook is None

    def other_hook(event, ctx):
        pass
    ch.set_fault_hook(other_hook)
    comm.finalize()
    assert ch._fault_hook is other_hook


def test_factory_fault_name(monkeypatch):
    monkeypatch.setenv(
        "CHAINERMN_TPU_FAULT_SCHEDULE",
        json.dumps({"seed": 3, "faults": [{"op": "allreduce", "nth": 1}]}))
    comm = create_communicator("fault", device="cpu")
    try:
        assert isinstance(comm, FaultInjectionCommunicator)
        assert comm.base.name == "jax_ici"
        with pytest.raises(InjectedFault):
            comm.allreduce(torch.ones(2))
        # a world of one has no host channel: no transport clone bound
        assert comm.hc_schedule is None
    finally:
        comm.finalize()
    monkeypatch.delenv("CHAINERMN_TPU_FAULT_SCHEDULE")
    with pytest.raises(ValueError):
        create_communicator("fault", device="cpu")
    comm = create_communicator(
        "fault", device="cpu", allreduce_grad_dtype="bfloat16",
        fault_schedule={"seed": 1, "faults": [
            {"op": "multi_node_mean_grad", "nth": 2}]})
    try:
        assert comm.allreduce_grad_dtype == torch.bfloat16
        assert comm.schedule.to_dict()["faults"][0]["nth"] == 2
    finally:
        comm.finalize()


def test_fault_schedule_rejected_for_non_fault_communicator():
    for name in ("jax_ici", "dummy"):
        with pytest.raises(ValueError, match="only honored by the 'fault'"):
            create_communicator(name, device="cpu",
                                fault_schedule=FaultSchedule([], seed=0))


def test_exchange_fault_fires_in_the_optimizer_step():
    """A fault scheduled at the gradient exchange fires inside the
    multi-node optimizer's step, before the rule moves a parameter."""
    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.core.optimizer import SGD
    from chainermn_tpu_torch.models import MLP, Classifier
    comm = create_communicator("fault", device="cpu", fault_schedule={
        "seed": 0, "faults": [{"op": "multi_node_mean_grad", "nth": 2}]})
    try:
        model = Classifier(MLP(n_units=8, n_out=3, seed=0, device="cpu"))
        opt = create_multi_node_optimizer(SGD(lr=0.1), comm).setup(model)
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.normal(0, 1, (4, 5)).astype(np.float32))
        t = torch.from_numpy(rng.randint(0, 3, 4).astype(np.int64))
        opt.update(model, x, t)
        before = [p.detach().clone() for p in model.parameters()]
        with pytest.raises(InjectedFault) as e:
            opt.update(model, x, t)
        assert (e.value.op, e.value.call_index) \
            == ("multi_node_mean_grad", 2)
        assert all(torch.equal(a, b)
                   for a, b in zip(before, model.parameters()))
    finally:
        comm.finalize()
