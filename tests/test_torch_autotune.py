"""The port's self-tuning exchange (``communicators._autotune``) against the
JAX package's: twins of ``tests/communicator_tests/test_autotune.py`` and
``tests/test_autotune_plan.py``.

* The pure pieces (``derived_stripe_ratio``, ``derived_bucket_bytes``,
  ``reduce_measurements``, ``measurements_from_trace``,
  ``derive_exchange_plan``, ``plan_fingerprint``): the same inputs give
  the same numbers, plan dicts and fingerprints in both packages, bit for
  bit, and the committed ``tools/autotune_plan.json`` records the port's
  derivation constants.
* The factory and optimizer knobs in a world of one (``device="cpu"``,
  the micro-bench replaced by fixed measurements where the JAX test does):
  only free knobs are filled, an autotuned run is bitwise the hand-knobbed
  one, online mode re-tunes from the ``train/grad_exchange`` spans,
  ``change_communicator`` re-tunes with one artifact per axis.
* A 4-rank gloo world (a forced 2 x 2 split): the real micro-bench on
  both hops, the agreement (every rank's plan the same, rank 0's plan
  executed under injected skew, warned and counted), the artifact, and a
  startup-tuned trajectory equal to the hand-knobbed one on every rank.

The spawned workers import no JAX; the JAX package is imported inside the
tests.  Every comparison here is exact: plans are JSON of 6-digit rounded
numbers, and a plan equal to the hand knobs must run the same exchange.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from chainermn_tpu_torch import observability as obs
from chainermn_tpu_torch.communicators import _autotune
from chainermn_tpu_torch.communicators import _memory_utility as mu
from chainermn_tpu_torch.communicators._autotune import (
    derive_exchange_plan, measurements_from_trace, plan_fingerprint,
    reduce_measurements, topology_summary)
from tests.test_torch_communicator import spawn_ranks

FIXED_HIER = {"source": "startup", "probe_mb": 1.0, "iters": 4,
              "hops": {"ici": {"size": 4, "gbps": 3.0, "lat_us": 50.0},
                       "dcn": {"size": 2, "gbps": 1.0, "lat_us": 200.0}}}
FIXED_FLAT = {"source": "startup", "probe_mb": 1.0, "iters": 4,
              "hops": {"world": {"size": 8, "gbps": 2.0, "lat_us": 100.0}}}
HIER_TOPO = {"axis": "dcnxici", "kind": "hierarchical", "size": 8,
             "exchange": "flat", "inter": 2, "intra": 4}
ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "autotune_plan.json")
WORLD = 4


def _jat():
    from chainermn_tpu.communicators import _autotune as jat
    return jat


def _jmu():
    from chainermn_tpu.communicators import _memory_utility as jmu
    return jmu


@pytest.fixture
def events_mode():
    prev = obs.set_mode("events")
    obs.reset_tracer()
    obs.reset_registry()
    yield
    obs.set_mode(prev)
    obs.reset_tracer()
    obs.reset_registry()


def _fake_measure(monkeypatch, measurement=FIXED_HIER):
    monkeypatch.setattr(_autotune, "measure_fabric",
                        lambda comm, **kw: measurement)


class _Comms:
    """Communicators of a world of one, finalized newest first (the first
    one owns the world group, or hands it to its re-tuned clone)."""

    def __init__(self):
        self.made = []

    def __call__(self, *args, **kw):
        from chainermn_tpu_torch import create_communicator
        comm = create_communicator(*args, device="cpu", **kw)
        self.made.append(comm)
        return comm

    def close(self):
        import torch.distributed as dist
        owner = [c for c in self.made if c._owns_world]
        for c in reversed(self.made):
            if not c._owns_world:
                c.finalize()
        for c in owner:
            c.finalize()
        assert not dist.is_initialized()


@pytest.fixture
def comms():
    made = _Comms()
    yield made
    made.close()


# -- the pure derivations ----------------------------------------------------------

def test_derived_stripe_ratio_recovers_committed_seed():
    assert mu.derived_stripe_ratio(3.0, 1.0) == mu.DEFAULT_STRIPE_RATIO \
        == 0.25 == _jmu().derived_stripe_ratio(3.0, 1.0)


def test_derived_stripe_ratio_monotone_and_clamped():
    prev = 0.0
    for b_dcn in (0.01, 0.1, 0.5, 1.0, 3.0, 10.0, 1000.0):
        r = mu.derived_stripe_ratio(3.0, b_dcn)
        assert r > prev and r == _jmu().derived_stripe_ratio(3.0, b_dcn)
        prev = r
    assert 0.0 < mu.derived_stripe_ratio(1e12, 1e-12) < 1.0
    assert 0.0 < mu.derived_stripe_ratio(1e-12, 1e12) < 1.0


@pytest.mark.parametrize("b_ici,b_dcn", [
    (0.0, 1.0), (1.0, 0.0), (-1.0, 1.0), (1.0, -1.0),
    (float("inf"), 1.0), (1.0, float("nan"))])
def test_derived_stripe_ratio_rejects_unmeasurable(b_ici, b_dcn):
    with pytest.raises(ValueError):
        mu.derived_stripe_ratio(b_ici, b_dcn)


def test_derived_bucket_bytes_rule_and_clamps():
    # 1 GB/s x 200 us / 0.125 = 1.6e6 B = 1.526 MiB -> 1.5 MiB (2 digits)
    assert mu.derived_bucket_bytes(1.0, 200.0) == int(1.5 * (1 << 20))
    assert mu.derived_bucket_bytes(0.001, 1.0) == 1 << 20
    assert mu.derived_bucket_bytes(1000.0, 10000.0) == 32 << 20
    for bad in (0.0, -1.0, float("nan")):
        with pytest.raises(ValueError):
            mu.derived_bucket_bytes(bad, 100.0)
    with pytest.raises(ValueError):
        mu.derived_bucket_bytes(1.0, -5.0)
    # bit for bit the JAX rule over a grid of bandwidths and latencies
    for gbps in (0.013, 0.5, 1.0, 2.7, 12.5, 90.0, 450.0):
        for lat in (0.0, 3.3, 17.0, 50.0, 128.0, 999.0, 5000.0):
            assert mu.derived_bucket_bytes(gbps, lat) \
                == _jmu().derived_bucket_bytes(gbps, lat), (gbps, lat)


def test_derive_plan_from_fixed_measurements_equals_jax():
    plan = derive_exchange_plan(FIXED_HIER, HIER_TOPO)
    assert plan["bucket_mb"] == 1.5
    assert plan["stripe_ratio"] == 0.25
    assert plan["grad_dtype"] == {"ici": None, "dcn": "bfloat16"}
    assert plan["fingerprint"] == plan_fingerprint(plan)
    want = _jat().derive_exchange_plan(FIXED_HIER, HIER_TOPO)
    assert plan == want
    assert plan["fingerprint"] == want["fingerprint"]


@pytest.mark.parametrize("case", ["flat", "online", "fallback", "slow_dcn",
                                  "no_hops"])
def test_plans_and_fingerprints_equal_jax(case):
    """The same synthetic measurements give the same plan dict and the same
    fingerprint in both packages."""
    m, topo = {
        "flat": (FIXED_FLAT, {"axis": "mn_world", "kind": "flat",
                              "size": 8, "exchange": "bucketed"}),
        "online": (measurements_from_trace(_trace_events()), HIER_TOPO),
        "fallback": ({"source": "startup", "hops": {
            "ici": {"size": 1, "gbps": None, "lat_us": None},
            "dcn": {"size": 2, "gbps": 1.0, "lat_us": None}}},
            dict(HIER_TOPO, size=2, intra=1)),
        "slow_dcn": ({"source": "startup", "probe_mb": 1.0, "iters": 4,
                      "hops": {"ici": {"size": 2, "gbps": 3.0,
                                       "lat_us": 50.0},
                               "dcn": {"size": 2, "gbps": 0.5,
                                       "lat_us": 400.0}}},
                     dict(HIER_TOPO, size=4, intra=2)),
        "no_hops": ({"source": "startup", "hops": {}},
                    {"axis": "mn_world", "kind": "flat", "size": 1,
                     "exchange": "flat"}),
    }[case]
    got = derive_exchange_plan(m, topo)
    want = _jat().derive_exchange_plan(m, topo)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert plan_fingerprint(got) == _jat().plan_fingerprint(want) \
        == got["fingerprint"]


def test_derive_plan_falls_back_with_notes_when_unmeasurable():
    m = {"source": "startup",
         "hops": {"ici": {"size": 1, "gbps": None, "lat_us": None},
                  "dcn": {"size": 2, "gbps": 1.0, "lat_us": None}}}
    plan = derive_exchange_plan(m, dict(HIER_TOPO, size=2, intra=1))
    assert plan["bucket_mb"] is None
    assert plan["stripe_ratio"] == mu.DEFAULT_STRIPE_RATIO
    notes = " ".join(plan["derivation"]["notes"])
    assert "falls back" in notes and str(mu.DEFAULT_BUCKET_MB) in notes


def test_derive_plan_deterministic_across_key_order_and_roundtrip():
    a = derive_exchange_plan(FIXED_HIER, HIER_TOPO)
    shuffled = {"hops": {"dcn": dict(reversed(
        list(FIXED_HIER["hops"]["dcn"].items()))),
        "ici": FIXED_HIER["hops"]["ici"]},
        "iters": 4, "probe_mb": 1.0, "source": "startup"}
    b = derive_exchange_plan(shuffled, dict(reversed(list(HIER_TOPO.items()))))
    assert a["fingerprint"] == b["fingerprint"]
    assert plan_fingerprint(json.loads(json.dumps(a))) == a["fingerprint"]


def test_reduce_measurements_median_with_fixed_tiebreak():
    gathered = [{"source": "startup", "probe_mb": 1.0, "iters": 4,
                 "hops": {"world": {"size": 8, "gbps": gbps,
                                    "lat_us": 100.0 * gbps}}}
                for gbps in (5.0, 1.0, 3.0, 4.0)]
    agreed = reduce_measurements(gathered)
    assert agreed["hops"]["world"]["gbps"] == 3.0
    assert agreed["hops"]["world"]["lat_us"] == 300.0
    assert agreed["ranks"] == 4
    assert reduce_measurements(list(reversed(gathered))) == agreed
    assert agreed == _jat().reduce_measurements(gathered)
    with pytest.raises(ValueError):
        reduce_measurements([None, {}])


def _trace_events():
    mb = 1 << 20
    return [
        {"name": "train/grad_exchange", "ph": "B", "ts": 0.0, "pid": 0,
         "tid": 0, "args": {"payload_bytes": 8 * mb, "hop": "dcn"}},
        {"name": "train/grad_exchange", "ph": "E", "ts": 4000.0, "pid": 0,
         "tid": 0},
        {"name": "train/grad_exchange", "ph": "B", "ts": 5000.0, "pid": 0,
         "tid": 0, "args": {"payload_bytes": 8 * mb, "hop": "dcn"}},
        {"name": "train/grad_exchange", "ph": "E", "ts": 7000.0, "pid": 0,
         "tid": 0},
        {"name": "train/grad_exchange", "ph": "B", "ts": 8000.0, "pid": 0,
         "tid": 0},
        {"name": "train/grad_exchange", "ph": "E", "ts": 9000.0, "pid": 0,
         "tid": 0},
        {"name": "train/optimizer_update", "ph": "B", "ts": 0.0, "pid": 0,
         "tid": 0, "args": {"payload_bytes": 1}},
        {"name": "train/optimizer_update", "ph": "E", "ts": 1.0, "pid": 0,
         "tid": 0},
    ]


def test_measurements_from_trace_payload_spans():
    m = measurements_from_trace(_trace_events())
    assert m["source"] == "online" and set(m["hops"]) == {"dcn"}
    hop = m["hops"]["dcn"]
    assert hop["samples"] == 2 and hop["lat_us"] is None
    np.testing.assert_allclose(hop["gbps"], 16 * (1 << 20) / 6e-3 / 1e9,
                               rtol=1e-6)
    assert m == _jat().measurements_from_trace(_trace_events())


def test_measurements_from_trace_take_the_device_twins_duration():
    """On the card the host span times only the exchange's enqueue: a 5 µs
    span whose device twin read 10 ms gives payload / 10 ms, and the twin
    (``train/grad_exchange/device``) is not a second sample; a span
    without a twin still counts its own duration."""
    mb = 1 << 20
    events = [
        {"name": "train/grad_exchange", "ph": "B", "ts": 100, "pid": 0,
         "tid": 1, "args": {"payload_bytes": 8 * mb, "span_id": 4}},
        {"name": "train/grad_exchange", "ph": "E", "ts": 105, "pid": 0,
         "tid": 1},
        {"name": "train/grad_exchange/device", "ph": "B", "ts": 300,
         "pid": 0, "tid": 1 << 50,
         "args": {"device_ms": 10.0, "span_id": 4}},
        {"name": "train/grad_exchange/device", "ph": "E", "ts": 10300,
         "pid": 0, "tid": 1 << 50},
    ]
    hop = measurements_from_trace(events)["hops"]["world"]
    assert hop["samples"] == 1
    np.testing.assert_allclose(hop["gbps"], 8 * mb / 10e-3 / 1e9, rtol=1e-9)
    # rank 1's span of the same id has no twin of its own: its duration
    events += [
        {"name": "train/grad_exchange", "ph": "B", "ts": 0, "pid": 1,
         "tid": 1, "args": {"payload_bytes": 8 * mb, "span_id": 4}},
        {"name": "train/grad_exchange", "ph": "E", "ts": 30000, "pid": 1,
         "tid": 1}]
    hop = measurements_from_trace(events)["hops"]["world"]
    assert hop["samples"] == 2
    np.testing.assert_allclose(hop["gbps"], 16 * mb / 40e-3 / 1e9,
                               rtol=1e-9)


def _twinned_exchanges(rank, device_ms, payload=8 << 20):
    """One rank's exchange spans, 5 µs each on the host, with device twins
    of ``device_ms`` (one a step)."""
    events = []
    for step, ms in enumerate(device_ms):
        t = 1000 * step
        events += [
            {"name": "train/grad_exchange", "ph": "B", "ts": t, "pid": rank,
             "tid": 1, "args": {"payload_bytes": payload, "span_id": step}},
            {"name": "train/grad_exchange", "ph": "E", "ts": t + 5,
             "pid": rank, "tid": 1},
            {"name": "train/grad_exchange/device", "ph": "B", "ts": t + 10,
             "pid": rank, "tid": 1 << 50,
             "args": {"device_ms": ms, "span_id": step}},
            {"name": "train/grad_exchange/device", "ph": "E",
             "ts": t + 10 + int(ms * 1e3), "pid": rank, "tid": 1 << 50}]
    return events


class _GatherComm:
    """``allgather_obj`` over ranks whose objects are given up front: the
    caller's own object stands in for rank ``rank``'s."""

    def __init__(self, others, rank=0):
        self.others, self.rank = others, rank

    def allgather_obj(self, obj):
        out = list(self.others)
        out.insert(self.rank, obj)
        return out


def test_online_measurement_takes_each_steps_fastest_rank():
    """Each rank's twin holds its wait for the slowest rank: every step
    takes the minimum over the ranks, over the last steps all of them
    hold (rank 2's ring kept one step more), and every rank brings the
    same measurement; ranks whose twins differ in their hops, or a rank
    without twins, fall back to the rank's own spans."""
    from chainermn_tpu_torch.communicators._autotune import (
        exchange_twin_samples, online_measurement)
    mb = 8 << 20
    twins = [[24.0, 3.0, 50.0], [2.0, 40.0, 4.0], [99.0, 30.0, 2.0, 5.0]]
    samples = [exchange_twin_samples(_twinned_exchanges(r, ms))
               for r, ms in enumerate(twins)]
    assert samples[0] == {"world": [[mb, 24e-3], [mb, 3e-3], [mb, 50e-3]]}
    got = []
    for rank in range(3):
        comm = _GatherComm(samples[:rank] + samples[rank + 1:], rank)
        got.append(online_measurement(
            comm, _twinned_exchanges(rank, twins[rank])))
    assert got[0] == got[1] == got[2]
    hop = got[0]["hops"]["world"]
    assert hop["samples"] == 3 and hop["lat_us"] is None
    # steps aligned from the end: min(24, 2, 30), min(3, 40, 2),
    # min(50, 4, 5)
    np.testing.assert_allclose(hop["gbps"], 3 * mb / 8e-3 / 1e9, rtol=1e-9)
    # the median of the ranks' own readings, as the agreement took them
    own = sorted(measurements_from_trace(_twinned_exchanges(r, ms))[
        "hops"]["world"]["gbps"] for r, ms in enumerate(twins))
    assert hop["gbps"] > 5 * own[1]
    # a rank without twins: every rank keeps its own measurement
    events = _twinned_exchanges(0, twins[0])
    comm = _GatherComm([samples[1], {}])
    assert online_measurement(comm, events) \
        == measurements_from_trace(events)
    comm = _GatherComm([samples[1], {"dcn": samples[2]["world"]}])
    assert online_measurement(comm, events) \
        == measurements_from_trace(events)


# -- the committed plan artifact (tests/test_autotune_plan.py's twins) ---------

def _artifact():
    with open(ARTIFACT) as f:
        return json.load(f)


def test_artifact_schema():
    art = _artifact()
    assert art["status"] in ("pending_on_chip", "measured")
    for key in ("derivation", "plan", "measurements",
                "steps_per_sec_delta_vs_hand", "regression_tolerance_pct",
                "plan_version"):
        assert key in art
    assert art["regression_tolerance_pct"] > 0


def test_derivation_constants_track_the_port_planner():
    art = _artifact()
    d = art["derivation"]
    assert art["plan_version"] == _autotune.PLAN_VERSION
    assert d["overhead_frac"] == _autotune.OVERHEAD_FRAC
    assert d["fallbacks"]["stripe_ratio"] == mu.DEFAULT_STRIPE_RATIO
    assert d["fallbacks"]["bucket_mb"] == mu.DEFAULT_BUCKET_MB
    probe = derive_exchange_plan(
        {"source": "startup", "hops": {"world": {"size": 2, "gbps": 1.0,
                                                 "lat_us": 100.0}}},
        {"axis": "probe", "kind": "flat", "size": 2,
         "exchange": "allreduce"})
    assert d["formula"] == probe["derivation"]["formula"]
    assert d["bucket_rule"] == probe["derivation"]["bucket_rule"]


def test_pending_refuses_numbers_off_chip():
    """While the artifact is ``pending_on_chip`` its numeric fields stay
    null: no CPU number is written there (the port's chip runs record
    their plans in PERF.md instead)."""
    art = _artifact()
    assert art["status"] == "pending_on_chip"
    for key in ("plan", "measurements", "steps_per_sec_delta_vs_hand"):
        assert art[key] is None


def test_a_measured_plan_rederives_bit_identically():
    """What the JAX gate requires of a stamped artifact, held on a plan
    the port derives: re-derived from its own measurements and topology,
    the same fingerprint, in the port and in the JAX package."""
    plan = derive_exchange_plan(FIXED_HIER, HIER_TOPO)
    body = json.loads(json.dumps(plan))
    again = derive_exchange_plan(body["measurements"], body["topology"])
    assert again["fingerprint"] == plan["fingerprint"] \
        == _jat().derive_exchange_plan(body["measurements"],
                                       body["topology"])["fingerprint"]
    assert plan_fingerprint(body) == plan["fingerprint"]


# -- the knobs in a world of one ---------------------------------------------------

def test_factory_autotune_fills_only_free_knobs(monkeypatch, comms):
    _fake_measure(monkeypatch)
    comm = comms("hierarchical", autotune=True)
    assert comm.autotune_plan is not None and comm.striped
    assert comm.stripe_ratio == 0.25
    assert comm.dcn_grad_dtype == torch.bfloat16
    assert comm._autotune_mode == "startup"
    hand = comms("hierarchical", stripe_ratio=0.6, autotune=True)
    assert hand.stripe_ratio == 0.6
    assert hand.autotune_plan is not None
    assert hand._hand_knobs["stripe_ratio"] is True
    assert hand.dcn_grad_dtype == torch.bfloat16
    # the plan and the provenance ride on a split
    sub = hand.split(0, 0)
    comms.made.append(sub)
    assert sub.autotune_plan is hand.autotune_plan
    assert sub._hand_knobs == hand._hand_knobs
    # bucket_mb fills a bucketed exchange only, unless set by hand
    _fake_measure(monkeypatch, FIXED_FLAT)
    bucketed = comms("jax_ici", batch_collectives="bucketed", autotune=True)
    assert bucketed.bucket_mb == derive_exchange_plan(
        reduce_measurements([FIXED_FLAT]),
        topology_summary(bucketed))["bucket_mb"]
    pinned = comms("jax_ici", batch_collectives="bucketed", bucket_mb=8,
                   autotune=True)
    assert pinned.bucket_mb == 8.0


def test_recorded_plan_dict_is_applied(comms):
    plan = derive_exchange_plan(FIXED_HIER, HIER_TOPO)
    comm = comms("hierarchical", autotune=plan)
    assert comm.autotune_plan is plan and comm.stripe_ratio == 0.25
    flat = comms("jax_ici", autotune=plan)
    assert flat.autotune_plan is plan and not flat.striped


def test_autotune_rejected_on_dummy_and_bad_mode():
    from chainermn_tpu_torch import create_communicator
    for name in ("dummy", "debug"):
        with pytest.raises(ValueError, match="autotune"):
            create_communicator(name, device="cpu", autotune=True)
    with pytest.raises(ValueError, match="autotune"):
        create_communicator("flat", device="cpu", autotune="sometimes")
    import torch.distributed as dist
    assert not dist.is_initialized()


def _data(seed=0, n=32, d=8, k=4):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.normal(0, 1, (n, d)).astype(np.float32)),
            torch.from_numpy(rng.randint(0, k, n).astype(np.int64)))


def _losses(comm, steps=3, opt=None):
    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.models import MLP, Classifier
    model = Classifier(MLP(n_units=16, n_out=4, seed=0, device="cpu"))
    if opt is None:
        opt = create_multi_node_optimizer(MomentumSGD(lr=0.1, momentum=0.9),
                                          comm)
    opt.communicator.bcast_data(model)
    opt.setup(model)
    x, t = _data()
    return [opt.update(model, x, t).item() for _ in range(steps)]


def test_golden_trajectory_autotune_equals_hand_knobs(monkeypatch, comms):
    """An autotuned run whose plan equals the hand knobs runs the same
    exchange: losses bitwise equal, step for step."""
    _fake_measure(monkeypatch)
    auto = comms("hierarchical", autotune=True)
    hand = comms("hierarchical", stripe_ratio=0.25,
                 allreduce_grad_dtype={"ici": None, "dcn": "bfloat16"})
    assert _losses(auto) == _losses(hand)


def test_optimizer_level_autotune_startup(monkeypatch, comms):
    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    _fake_measure(monkeypatch)
    comm = comms("hierarchical")
    opt = create_multi_node_optimizer(MomentumSGD(lr=0.1, momentum=0.9),
                                      comm, autotune=True)
    comms.made.append(opt.communicator)
    assert opt.communicator is not comm
    assert opt.communicator.autotune_plan is not None
    assert opt.communicator.stripe_ratio == 0.25
    hand = comms("hierarchical", stripe_ratio=0.25,
                 allreduce_grad_dtype={"ici": None, "dcn": "bfloat16"})
    assert _losses(None, opt=opt) == _losses(hand)


def _eager_opt(comms, autotune=None):
    from chainermn_tpu_torch import L, create_multi_node_optimizer
    from chainermn_tpu_torch.core.optimizer import SGD
    comm = comms("flat")
    model = L.Linear(4, 2, seed=0, device="cpu")
    comm.bcast_data(model)
    opt = create_multi_node_optimizer(SGD(lr=0.1), comm,
                                      autotune=autotune).setup(model)
    if opt.communicator is not comm:
        comms.made.append(opt.communicator)
    return opt, model


def _set_grads(model):
    model.W.grad = torch.ones_like(model.W)
    model.b.grad = torch.ones_like(model.b)


def test_eager_span_carries_payload_bytes(events_mode, comms):
    opt, model = _eager_opt(comms)
    _set_grads(model)
    opt.update()
    spans = [e for e in obs.tracer().events()
             if e.get("name") == "train/grad_exchange"
             and e.get("ph") == "B"]
    assert spans
    args = spans[0].get("args") or {}
    assert args.get("payload_bytes") == 40 and args.get("buckets") == 1


def test_online_autotune_derives_after_n_steps(events_mode, comms):
    opt, model = _eager_opt(comms, autotune=2)
    assert opt._autotune_online_after == 2
    assert opt.communicator.autotune_plan is None
    assert opt.communicator._autotune_mode == "online"
    for _ in range(2):
        _set_grads(model)
        opt.update()
    assert opt._autotune_online_after == 0
    plan = opt.communicator.autotune_plan
    assert plan is not None and plan["measurements"]["source"] == "online"
    # the two updates' spans, reduced over the ranks: a bandwidth, no
    # latency (so bucket_mb keeps its default)
    world = plan["measurements"]["hops"]["world"]
    assert world["gbps"] > 0 and world["lat_us"] is None
    assert plan["bucket_mb"] is None


def test_online_autotune_without_tracing_falls_back_to_startup(
        monkeypatch, comms):
    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.core.optimizer import SGD
    assert obs.mode() == "off"
    _fake_measure(monkeypatch, FIXED_FLAT)
    comm = comms("flat")
    with pytest.warns(UserWarning, match="tracing is off"):
        opt = create_multi_node_optimizer(SGD(lr=0.1), comm,
                                          autotune="online")
    assert opt.communicator.autotune_plan is not None
    assert opt._autotune_online_after == 0
    with pytest.raises(ValueError, match="autotune"):
        create_multi_node_optimizer(SGD(lr=0.1), comm, autotune=-1)


def test_change_communicator_retunes_fresh_plan_per_axis(monkeypatch,
                                                         tmp_path, comms):
    """The non-elastic part of the JAX re-tune on ``change_communicator``:
    a communicator without a plan, swapped in for a tuned one, is
    re-tuned (provenance carried, a fresh plan and artifact per axis)."""
    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.models import MLP, Classifier
    monkeypatch.setenv("CHAINERMN_TPU_AUTOTUNE_DIR", str(tmp_path))
    _fake_measure(monkeypatch, FIXED_FLAT)
    comm = comms("flat", autotune=True)
    model = Classifier(MLP(n_units=16, n_out=4, seed=0, device="cpu"))
    opt = create_multi_node_optimizer(MomentumSGD(lr=0.1, momentum=0.9),
                                      comm).setup(model)
    x, t = _data()
    opt.update(model, x, t)
    first = comm.autotune_plan
    slow = {"source": "startup", "probe_mb": 1.0, "iters": 4,
            "hops": {"ici": {"size": 2, "gbps": 3.0, "lat_us": 50.0},
                     "dcn": {"size": 2, "gbps": 0.5, "lat_us": 400.0}}}
    _fake_measure(monkeypatch, slow)
    other = comms("hierarchical")
    opt.change_communicator(other)
    comms.made.append(opt.communicator)
    second = opt.communicator.autotune_plan
    assert second is not None and second["fingerprint"] != first["fingerprint"]
    assert opt.communicator.stripe_ratio == pytest.approx(0.5 / 3.5, abs=1e-6)
    assert opt.update(model, x, t).item() > 0
    arts = sorted(p.name for p in tmp_path.glob("autotune_plan_*.json"))
    assert arts == ["autotune_plan_dcnxici.json",
                    "autotune_plan_mn_world.json"]


# -- the 4-rank world -------------------------------------------------------------

def _worker(rank, out_dir):
    import chainermn_tpu_torch.communicators._autotune as at
    from chainermn_tpu_torch import create_communicator
    os.environ["CHAINERMN_TPU_AUTOTUNE_DIR"] = out_dir
    split = dict(device="cpu", intra_size=2, inter_size=2)
    flat = create_communicator("jax_ici", device="cpu")
    hier = create_communicator("hierarchical", **split)
    out = {"measure_hier": at.measure_fabric(hier, probe_mb=0.125, iters=2),
           "measure_flat": at.measure_fabric(flat, probe_mb=0.125, iters=2),
           "topology": at.topology_summary(hier)}
    out["agreed"] = at.agree_exchange_plan(flat, FIXED_FLAT)
    out["gauge"] = obs.registry().get(
        "chainermn_tpu_autotune_plan_fingerprint").value(axis="mn_world")

    # injected skew: rank 0 derives another plan; every rank runs it
    orig = at.derive_exchange_plan
    if rank == 0:
        def tampered(m, topo):
            plan = orig(m, topo)
            plan["bucket_mb"] = 99.0
            plan["fingerprint"] = at.plan_fingerprint(plan)
            return plan
        at.derive_exchange_plan = tampered
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["skewed"] = at.agree_exchange_plan(flat, FIXED_FLAT)
    at.derive_exchange_plan = orig
    out["skew_warned"] = any("diverged" in str(w.message) for w in caught)
    counter = obs.registry().get(
        "chainermn_tpu_autotune_plan_divergence_total")
    out["divergence"] = 0 if counter is None \
        else counter.value(axis="mn_world")

    # startup tuning on the real fabric: one plan on every rank
    tuned = create_communicator("hierarchical", autotune=True, **split)
    out["startup_plan"] = tuned.autotune_plan

    # the golden trajectory across ranks (fixed measurements)
    at.measure_fabric = lambda comm, **kw: FIXED_HIER
    auto = create_communicator("hierarchical", autotune=True, **split)
    hand = create_communicator(
        "hierarchical", stripe_ratio=0.25,
        allreduce_grad_dtype={"ici": None, "dcn": "bfloat16"}, **split)
    rows = 32 // WORLD

    def run(comm):
        from chainermn_tpu_torch import create_multi_node_optimizer
        from chainermn_tpu_torch.core.optimizer import MomentumSGD
        from chainermn_tpu_torch.models import MLP, Classifier
        model = Classifier(MLP(n_units=16, n_out=4, seed=0, device="cpu"))
        comm.bcast_data(model)
        opt = create_multi_node_optimizer(MomentumSGD(lr=0.1, momentum=0.9),
                                          comm).setup(model)
        x, t = _data()
        x, t = x[rank * rows:(rank + 1) * rows], t[rank * rows:(rank + 1)
                                                   * rows]
        return [opt.update(model, x, t).item() for _ in range(3)]

    out["golden"] = (run(auto), run(hand))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("autotune")
    return spawn_ranks(tmp, _worker, world=WORLD, out_dir=str(tmp)), tmp


def test_real_microbench_measures_every_hop(world):
    """The micro-bench over the real gloo groups: at a 2 x 2 split both
    hops have size 2 and finite bandwidth and latency; the flat world's
    one hop has size 4."""
    ranks, _ = world
    for r in ranks:
        m = r["measure_hier"]
        assert set(m["hops"]) == {"ici", "dcn"}
        for hop in m["hops"].values():
            assert hop["size"] == 2
            assert hop["gbps"] > 0 and hop["lat_us"] > 0
        assert r["measure_flat"]["hops"]["world"]["size"] == WORLD
        assert r["topology"] == {"axis": "dcnxici", "kind": "hierarchical",
                                 "size": 4, "exchange": "flat", "inter": 2,
                                 "intra": 2}


def test_agree_over_real_comm_records_artifact(world):
    ranks, tmp = world
    plans = [r["agreed"] for r in ranks]
    assert all(p == plans[0] for p in plans)
    plan = plans[0]
    assert plan["fingerprint"] == plan_fingerprint(plan)
    # the JAX planner derives the same plan from the agreed measurements
    assert plan["fingerprint"] == _jat().derive_exchange_plan(
        plan["measurements"], plan["topology"])["fingerprint"]
    path = tmp / "autotune_plan_mn_world.json"
    assert json.loads(path.read_text())["fingerprint"] in (
        plan["fingerprint"], ranks[0]["skewed"]["fingerprint"])
    for r in ranks:
        assert r["gauge"] == float(int(plan["fingerprint"][:12], 16))


def test_rank0_broadcast_wins_under_injected_skew(world):
    ranks, _ = world
    skewed = ranks[0]["skewed"]
    assert skewed["bucket_mb"] == 99.0
    for rank, r in enumerate(ranks):
        assert r["skewed"] == skewed
        assert r["skew_warned"] == (rank != 0)
        assert r["divergence"] == (0 if rank == 0 else 1)


def test_startup_autotune_agrees_on_every_rank(world):
    ranks, _ = world
    fps = {r["startup_plan"]["fingerprint"] for r in ranks}
    assert len(fps) == 1
    plan = ranks[0]["startup_plan"]
    assert set(plan["measurements"]["hops"]) == {"ici", "dcn"}
    assert plan["measurements"]["ranks"] == WORLD


def test_golden_trajectory_across_ranks(world):
    ranks, _ = world
    for r in ranks:
        auto, hand = r["golden"]
        assert auto == hand
        assert auto == ranks[0]["golden"][0]
