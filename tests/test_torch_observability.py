"""The port's observability (``chainermn_tpu_torch.observability``, the
trainer's trace export, ``utils.profiling``) against the JAX package's.

Twins of ``tests/observability_tests/``: ``test_tracing.py`` (22: the
schema validator, recording and export, the off path's cost, ``full``
mode, and the JAX ``tools/trace_merge.py`` merging the port's shards),
``test_metrics.py`` (12), ``test_profile_leak.py`` (6, with a fake
``torch.profiler`` in place of the fake ``jax.profiler``: they also gate
``Trainer.run``'s isolated finalizers), and the cases of
``test_instrumentation.py`` that need neither the checkpointer nor
``bench.py`` (the trainer's trace, off emits nothing, the input-stall
counter for every iterator kind and both updaters, the four serving
cases).  Then the JAX ``validate_events`` on a shard the port's trainer
wrote, and ``trace_merge`` over two of its rank shards.  Everything is
host code and runs on the CPU (a world of one gloo process for the
trainer).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from chainermn_tpu_torch import observability as obs
from chainermn_tpu_torch.observability import metrics as metrics_mod
from chainermn_tpu_torch.observability import tracing


@pytest.fixture
def events_mode():
    prev = obs.set_mode("events")
    obs.reset_tracer()
    obs.reset_registry()
    yield
    obs.set_mode(prev)
    obs.reset_tracer()
    obs.reset_registry()


def _tools():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import trace_merge
    return trace_merge


def _ev(name="x", ph="B", ts=0, pid=0, tid=1, **kw):
    return dict({"name": name, "ph": ph, "ts": ts, "pid": pid,
                 "tid": tid}, **kw)


# -- test_tracing.py's twins: the schema validator ----------------------------------

def test_validator_accepts_wellformed():
    events = [_ev("process_name", "M"),
              _ev("a", "B", 0), _ev("b", "B", 1), _ev("mark", "i", 2),
              _ev("b", "E", 3), _ev("a", "E", 4)]
    assert obs.validate_events(events) == 6


def test_validator_rejects_missing_key():
    bad = _ev()
    del bad["ts"]
    with pytest.raises(ValueError, match="missing key"):
        obs.validate_events([bad])


def test_validator_rejects_backwards_ts():
    with pytest.raises(ValueError, match="backwards"):
        obs.validate_events([_ev("a", "B", 5), _ev("a", "E", 3)])


def test_validator_rejects_unbalanced():
    with pytest.raises(ValueError, match="no open B"):
        obs.validate_events([_ev("a", "E", 0)])
    with pytest.raises(ValueError, match="unclosed"):
        obs.validate_events([_ev("a", "B", 0)])


def test_validator_rejects_bad_nesting():
    with pytest.raises(ValueError, match="innermost"):
        obs.validate_events([_ev("a", "B", 0), _ev("b", "B", 1),
                             _ev("a", "E", 2), _ev("b", "E", 3)])


def test_validator_separate_tracks_independent():
    events = [_ev("a", "B", 0, tid=1), _ev("b", "B", 1, tid=2),
              _ev("a", "E", 2, tid=1), _ev("b", "E", 3, tid=2)]
    assert obs.validate_events(events) == 4


# -- recording and export ----------------------------------------------------------

def test_span_records_balanced_pair(events_mode):
    with obs.span("train/input_stall", tags={"k": 1}):
        pass
    evs = obs.tracer().events()
    assert [e["ph"] for e in evs] == ["B", "E"]
    assert evs[0]["name"] == evs[1]["name"] == "train/input_stall"
    assert evs[0]["args"] == {"k": 1}
    obs.validate_events(evs)


def test_instant_and_rank_epoch_tags(events_mode):
    obs.tracer().configure(rank=3, epoch=7)
    obs.instant("elastic/preempt_detect", tags={"exc": "X"})
    (ev,) = obs.tracer().events()
    assert ev["ph"] == "i" and ev["pid"] == 3
    assert ev["args"]["epoch"] == 7 and ev["args"]["exc"] == "X"


def test_complete_retroactive_span_is_valid(events_mode):
    obs.tracer().complete("serve/queue_wait", 0.001, tid=42)
    evs = obs.tracer().events()
    assert [e["ph"] for e in evs] == ["B", "E"]
    assert evs[0]["ts"] <= evs[1]["ts"]
    assert evs[0]["args"]["duration_ms"] == 1.0
    obs.validate_events(evs)


def test_complete_clamps_to_track_floor(events_mode):
    tr = obs.tracer()
    with tr.span("first", tid=7):
        pass
    tr.complete("second", duration_s=1e6, tid=7)
    evs = tr.events()
    first_end = evs[1]["ts"]
    b2 = evs[2]
    assert b2["ts"] >= first_end
    assert b2["args"]["duration_ms"] == 1e9
    obs.validate_events(sorted(evs, key=lambda e: e["ts"]))


def test_ring_buffer_bounds_and_export_repair(events_mode, tmp_path):
    tr = tracing.SpanTracer(rank=0, capacity=8)
    for i in range(10):
        with tr.span(f"s{i}"):
            pass
    assert len(tr.events()) == 8
    path = tmp_path / "t.jsonl"
    n = tr.export(str(path))
    events = obs.read_jsonl(str(path))
    obs.validate_events(events)
    assert n == sum(1 for e in events if e["ph"] != "M")


def test_export_closes_unclosed_spans(events_mode, tmp_path):
    tr = obs.tracer()
    span = tr.span("left/open")
    tr.instant("mark")
    del span
    path = tmp_path / "t.jsonl"
    tr.export(str(path))
    events = obs.read_jsonl(str(path))
    obs.validate_events(events)
    assert any(e["ph"] == "E" and e["name"] == "left/open"
               for e in events)


def test_export_writes_rank_metadata(events_mode, tmp_path):
    obs.tracer().configure(rank=2)
    obs.instant("x")
    path = tmp_path / "t.jsonl"
    obs.tracer().export(str(path))
    meta = [e for e in obs.read_jsonl(str(path)) if e["ph"] == "M"]
    assert meta and meta[0]["args"]["name"] == "rank2"
    assert meta[0]["pid"] == 2


# -- the off path's cost -------------------------------------------------------------

def test_off_is_default_and_emits_nothing():
    assert obs.mode() == "off"
    assert not obs.enabled()
    obs.reset_tracer()
    with obs.span("anything", tags={"a": 1}):
        obs.instant("nothing")
    assert obs.tracer().events() == []


def test_off_span_returns_singleton_no_alloc():
    assert obs.mode() == "off"
    first = obs.span("a")
    assert obs.span("b") is first is tracing._NOOP
    import gc
    for _ in range(64):
        with obs.span("warm"):
            pass
    gc.collect()
    before = sys.getallocatedblocks()
    for _ in range(10_000):
        with obs.span("hot"):
            pass
    gc.collect()
    after = sys.getallocatedblocks()
    assert after - before < 100, (before, after)


def test_set_mode_rejects_unknown():
    with pytest.raises(ValueError, match="expected one of"):
        obs.set_mode("loud")


def test_full_mode_opens_record_function(events_mode, monkeypatch):
    """``full``: each span also opens ``torch.profiler.record_function``
    (``/`` as ``.``), where the JAX package opens ``jax.named_scope``."""
    opened = []

    class _Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    import torch.profiler
    monkeypatch.setattr(torch.profiler, "record_function", _Range)
    obs.set_mode("full")
    with obs.span("train/optimizer_update"):
        pass
    assert opened == ["train.optimizer_update"]
    assert [e["ph"] for e in obs.tracer().events()] == ["B", "E"]


# -- trace_merge (the JAX tool) over the port's shards ---------------------------------

def test_trace_merge_lossless_and_sorted(events_mode, tmp_path):
    trace_merge = _tools()
    shards = []
    for rank in (0, 1):
        tr = tracing.SpanTracer(rank=rank)
        with tr.span("train/optimizer_update"):
            tr.instant("mark", tags={"rank": rank})
        p = tmp_path / f"trace-rank{rank}.jsonl"
        tr.export(str(p))
        shards.append(str(p))
    out = tmp_path / "merged.json"
    merged = trace_merge.merge_files(shards, str(out))
    obs.validate_events(merged)
    shard_events = [e for p in shards for e in obs.read_jsonl(p)]
    key = trace_merge._dedupe_key
    assert {key(e) for e in shard_events} == {key(e) for e in merged}
    assert {e["pid"] for e in merged} == {0, 1}
    assert json.loads(out.read_text()) == merged
    ts = [e["ts"] for e in merged if e["ph"] != "M"]
    assert ts == sorted(ts)


def test_trace_merge_preserves_same_key_events_within_shard(tmp_path):
    trace_merge = _tools()
    shard = [_ev("s", "B", 100), _ev("s", "E", 100),
             _ev("s", "B", 100), _ev("s", "E", 101)]
    obs.validate_events(shard)
    merged = trace_merge.merge_events([shard])
    assert len(merged) == 4
    obs.validate_events(merged)
    assert len(trace_merge.merge_events([shard, list(shard)])) == 4


def test_trace_merge_dedupes_reexported_shard(events_mode, tmp_path):
    trace_merge = _tools()
    tr = tracing.SpanTracer(rank=0)
    with tr.span("s"):
        pass
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    tr.export(str(a))
    tr.export(str(b))
    merged = trace_merge.merge_events([obs.read_jsonl(str(a)),
                                       obs.read_jsonl(str(b))])
    assert len(merged) == len(obs.read_jsonl(str(a)))


def test_trace_merge_cli_refuses_invalid(tmp_path):
    trace_merge = _tools()
    bad = tmp_path / "bad.jsonl"
    ev = _ev("a", "B", 0)
    del ev["ts"]
    bad.write_text(json.dumps(ev) + "\n")
    rc = trace_merge.main([str(bad), "-o", str(tmp_path / "out.json")])
    assert rc == 1
    assert not (tmp_path / "out.json").exists()


def test_trace_merge_checkpoint_plus_exit_export(events_mode, tmp_path):
    trace_merge = _tools()
    tr = obs.tracer()
    span = tr.span("train/run")
    p1 = tmp_path / "ckpt.jsonl"
    tr.export(str(p1))
    span.close()
    p2 = tmp_path / "exit.jsonl"
    tr.export(str(p2))
    merged = trace_merge.merge_files([str(p1), str(p2)],
                                     str(tmp_path / "m.json"))
    obs.validate_events(merged)
    pairs = [e for e in merged if e["name"] == "train/run"]
    assert [e["ph"] for e in pairs] == ["B", "E"]


# -- test_metrics.py's twins ---------------------------------------------------------

def test_counter_inc_and_labels():
    reg = obs.MetricsRegistry()
    c = reg.counter("reqs_total", help="requests")
    c.inc()
    c.inc(2, tenant="a")
    c.inc(3, tenant="a")
    assert c.value() == 1 and c.value(tenant="a") == 5
    with pytest.raises(ValueError, match="negative"):
        c.inc(-1)


def test_counter_get_or_create_idempotent_and_kind_clash():
    reg = obs.MetricsRegistry()
    assert reg.counter("x") is reg.counter("x")
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("x")


def test_gauge_set():
    g = obs.MetricsRegistry().gauge("depth")
    g.set(4, tenant="a")
    g.set(2, tenant="a")
    assert g.value(tenant="a") == 2


def test_histogram_buckets_sum_count_percentile():
    reg = obs.MetricsRegistry()
    h = reg.histogram("wait_ms", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 5.0, 50.0):
        h.observe(v)
    counts, total, n = h.value()
    assert counts == [1, 2, 1, 0] and total == 60.5 and n == 4
    assert h.percentile(50) == 10.0 and h.percentile(99) == 100.0
    h.observe(1e9)
    assert h.percentile(100) == float("inf")
    assert reg.histogram("empty").percentile(50) is None


def test_histogram_rejects_unsorted_bounds():
    with pytest.raises(ValueError, match="sorted"):
        obs.MetricsRegistry().histogram("h", buckets=(10.0, 1.0))


def test_merge_counters_sum_histograms_add_gauges_rank_label():
    a, b = obs.MetricsRegistry(), obs.MetricsRegistry()
    for reg, v in ((a, 1), (b, 2)):
        reg.counter("c").inc(v)
        reg.gauge("g").set(v, tenant="t")
        reg.histogram("h", buckets=(1.0, 10.0)).observe(v)
    merged = obs.MetricsRegistry()
    merged.merge_dict(a.to_dict(), rank=0)
    merged.merge_dict(b.to_dict(), rank=1)
    assert merged.get("c").value() == 3
    assert merged.get("g").value(tenant="t", rank="0") == 1
    assert merged.get("g").value(tenant="t", rank="1") == 2
    counts, total, n = merged.get("h").value()
    assert counts == [1, 1, 0] and total == 3 and n == 2


def test_merge_rejects_mismatched_histogram_bounds():
    a, b = obs.MetricsRegistry(), obs.MetricsRegistry()
    a.histogram("h", buckets=(1.0,)).observe(0.5)
    b.histogram("h", buckets=(2.0,)).observe(0.5)
    merged = obs.MetricsRegistry()
    merged.merge_dict(a.to_dict(), rank=0)
    with pytest.raises(ValueError, match="differ"):
        merged.merge_dict(b.to_dict(), rank=1)


def test_merge_across_rides_object_collectives():
    """Over the port's ``allgather_obj``: the dummy communicator, and a
    world of one gloo process."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.communicators import DummyCommunicator
    reg = obs.MetricsRegistry()
    reg.counter("c").inc(7)
    assert reg.merge_across(DummyCommunicator()).get("c").value() == 7
    comm = create_communicator("flat", device="cpu")
    try:
        assert reg.merge_across(comm).get("c").value() == 7
    finally:
        comm.finalize()


def test_label_key_roundtrip():
    key = (("a", "1"), ("b", "x y"))
    assert metrics_mod.unjson_key(metrics_mod.json_key(key)) == key
    assert metrics_mod.unjson_key(metrics_mod.json_key(())) == ()


def test_prometheus_text_format():
    reg = obs.MetricsRegistry()
    reg.counter("c_total", help="the c").inc(2, tenant="a")
    reg.gauge("g").set(1.5)
    reg.histogram("h_ms", buckets=(1.0, 10.0)).observe(0.5)
    lines = reg.to_prometheus().strip().split("\n")
    for want in ("# HELP c_total the c", "# TYPE c_total counter",
                 'c_total{tenant="a"} 2', "# TYPE g gauge", "g 1.5",
                 "# TYPE h_ms histogram", 'h_ms_bucket{le="1.0"} 1',
                 'h_ms_bucket{le="+Inf"} 1', "h_ms_sum 0.5", "h_ms_count 1"):
        assert want in lines


def test_default_buckets_sorted():
    assert list(obs.DEFAULT_TIME_BUCKETS_MS) \
        == sorted(obs.DEFAULT_TIME_BUCKETS_MS)


def test_prometheus_escapes_hostile_label_values():
    reg = obs.MetricsRegistry()
    reg.counter("c").inc(1, tenant='a"b\\c\nd')
    (line,) = [l for l in reg.to_prometheus().splitlines()
               if not l.startswith("#")]
    assert line == 'c{tenant="a\\"b\\\\c\\nd"} 1'


# -- test_profile_leak.py's twins (they gate Trainer.run's finalizers) -----------------

class _FakeProfiler:
    def __init__(self):
        self.active = False
        self.starts = 0
        self.stops = 0

    def __call__(self):   # the module's _profiler()
        return self

    def start(self):
        assert not self.active, "start while already tracing"
        self.active = True
        self.starts += 1

    def stop(self):
        assert self.active, "stop with no active trace"
        self.active = False
        self.stops += 1

    def export_chrome_trace(self, path):
        pass


@pytest.fixture
def profiler(monkeypatch):
    from chainermn_tpu_torch.utils import profiling
    fake = _FakeProfiler()
    monkeypatch.setattr(profiling, "_profiler", fake)
    return fake


def _stub_classes():
    from chainermn_tpu_torch.training.trainer import Extension
    from chainermn_tpu_torch.training.updaters import Updater

    class _StubUpdater(Updater):
        def __init__(self, fail_at=None):
            self.iteration = 0
            self.fail_at = fail_at
            self.finalized = False

        def get_all_optimizers(self):
            return {}

        def update(self):
            self.iteration += 1
            if self.fail_at is not None and self.iteration == self.fail_at:
                raise RuntimeError("boom")

        def finalize(self):
            self.finalized = True

        def serialize(self, serializer):
            pass

    class _HostileFinalize(Extension):
        priority = 500  # finalizes before Profile (higher priority first)

        def __call__(self, trainer):
            pass

        def finalize(self):
            raise ValueError("hostile finalize")

    return _StubUpdater, _HostileFinalize


def _trainer_of(updater, stop, tmp_path):
    from chainermn_tpu_torch.training import Trainer
    return Trainer(updater, stop, out=str(tmp_path))


def test_run_ends_inside_window_trace_stopped(profiler, tmp_path):
    from chainermn_tpu_torch.utils import Profile
    stub, _ = _stub_classes()
    trainer = _trainer_of(stub(), (3, "iteration"), tmp_path)
    trainer.extend(Profile(start=1, n_steps=10))
    trainer.run()
    assert profiler.starts == 1
    assert not profiler.active, "trace leaked past a pre-window-end run"


def test_raise_inside_window_trace_stopped(profiler, tmp_path):
    from chainermn_tpu_torch.utils import Profile
    stub, _ = _stub_classes()
    trainer = _trainer_of(stub(fail_at=2), None, tmp_path)
    trainer.extend(Profile(start=1, n_steps=10))
    with pytest.raises(RuntimeError, match="boom"):
        trainer.run()
    assert profiler.starts == 1 and not profiler.active


def test_hostile_finalize_cannot_starve_profile_stop(profiler, tmp_path,
                                                     capsys):
    """Another extension's failing finalize no longer skips the others'
    (the fault the port's trainer had): it is raised after everyone's
    cleanup, the updater's included, and ``_done`` is set."""
    from chainermn_tpu_torch.utils import Profile
    stub, hostile = _stub_classes()
    updater = stub()
    trainer = _trainer_of(updater, (3, "iteration"), tmp_path)
    trainer.extend(hostile())
    trainer.extend(Profile(start=1, n_steps=10))
    with pytest.raises(ValueError, match="hostile finalize"):
        trainer.run()
    assert not profiler.active, "hostile finalize starved Profile._stop"
    assert updater.finalized and trainer._done
    assert "hostile finalize" in capsys.readouterr().err


def test_updater_finalize_isolated_too(profiler, tmp_path):
    from chainermn_tpu_torch.utils import Profile
    stub, hostile = _stub_classes()

    class _HostileUpdater(stub):
        def finalize(self):
            raise OSError("updater cleanup failed")

    trainer = _trainer_of(_HostileUpdater(), (3, "iteration"), tmp_path)
    trainer.extend(hostile())
    trainer.extend(Profile(start=1, n_steps=10))
    with pytest.raises(ValueError, match="hostile finalize"):
        trainer.run()
    assert not profiler.active and trainer._done


def test_loop_exception_wins_over_finalize_exception(profiler, tmp_path):
    from chainermn_tpu_torch.utils import Profile
    stub, hostile = _stub_classes()
    updater = stub(fail_at=1)
    trainer = _trainer_of(updater, None, tmp_path)
    trainer.extend(hostile())
    trainer.extend(Profile(start=1, n_steps=10))
    with pytest.raises(RuntimeError, match="boom"):
        trainer.run()
    assert not profiler.active and updater.finalized and trainer._done


def test_stop_is_idempotent_and_never_masks(profiler, tmp_path):
    from chainermn_tpu_torch.utils import Profile
    p = Profile(start=0, n_steps=5)
    profiler.start()
    p._active, p._prof, p._dir = True, profiler, str(tmp_path)
    p._stop()
    p._stop()
    assert profiler.stops == 1

    class _Wedged:
        def stop(self):
            raise RuntimeError("profiler wedged")

    p2 = Profile()
    p2._active, p2._prof, p2._dir = True, _Wedged(), str(tmp_path)
    with pytest.warns(UserWarning, match="wedged"):
        p2._stop()
    assert not p2._active


# -- test_instrumentation.py's twins ---------------------------------------------------

def _data(n=32, d=12, k=3, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 1, (n, d)).astype(np.float32),
            rng.randint(0, k, n).astype(np.int32))


def _train(out, iterator, n_iter=3, with_checkpoint=True, updater_cls=None,
           **updater_kw):
    """``test_instrumentation.py``'s ``_trainer``, with its checkpointer
    every 2 iterations, run; the world of one is torn down after it."""
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_checkpointer,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.models import MLP, Classifier
    from chainermn_tpu_torch.training import (StandardUpdater, Trainer)
    comm = create_communicator("flat", device="cpu")
    try:
        model = Classifier(MLP(n_units=16, n_out=3, seed=0, device="cpu"))
        opt = create_multi_node_optimizer(MomentumSGD(lr=0.05),
                                          comm).setup(model)
        updater_cls = updater_cls or StandardUpdater
        trainer = Trainer(updater_cls(iterator, opt, **updater_kw),
                          (n_iter, "iteration"), out=str(out))
        if with_checkpoint:
            trainer.extend(create_multi_node_checkpointer(
                comm, name="obs", path=str(out)), trigger=(2, "iteration"))
        trainer.run()
        return trainer
    finally:
        comm.finalize()


#: the multi-node optimizer's step phases, in their order
PHASES = ("train/forward", "train/backward", "train/grad_exchange",
          "train/rule", "train/persistent_mean", "train/global_means")


def _span_names(events):
    return {e["name"] for e in events if e["ph"] in ("B", "i")}


def test_trainer_run_produces_schema_valid_trace(events_mode, tmp_path):
    """A traced run leaves ``trace-rank0.jsonl`` in ``out``, valid under
    the port's validator and the JAX package's, with the trainer's span
    taxonomy: one ``train/optimizer_update``, ``train/input_stall`` and
    each step phase's span per iteration, the phases inside the update,
    the exchange's tags, the checkpointer's
    ``train/checkpoint_serialize``; on the CPU no device twin, and no
    per-bucket instant or payload counter."""
    import chainermn_tpu.observability as jax_obs
    from chainermn_tpu_torch.dataset import SerialIterator, TupleDataset
    x, t = _data()
    it = SerialIterator(TupleDataset(x, t), 8, shuffle=False)
    _train(tmp_path / "out", it)
    shard = tmp_path / "out" / "trace-rank0.jsonl"
    assert shard.exists()
    events = obs.read_jsonl(str(shard))
    obs.validate_events(events)
    jax_obs.validate_events(events)
    names = _span_names(events)
    assert {"train/input_stall", "train/optimizer_update",
            "train/checkpoint_serialize", *PHASES} <= names
    for name in ("train/input_stall", "train/optimizer_update", *PHASES):
        assert sum(e["name"] == name and e["ph"] == "B"
                   for e in events) == 3, name
    assert {e["pid"] for e in events} == {0}
    update = [e["ts"] for e in events
              if e["name"] == "train/optimizer_update"]
    phases = [e for e in events if e["name"] in PHASES]
    assert [e["name"] for e in phases if e["ph"] == "B"] == 3 * list(PHASES)
    assert all(update[0] <= e["ts"] <= update[-1] for e in phases)
    exchange = next(e for e in events if e["name"] == "train/grad_exchange"
                    and e["ph"] == "B")
    assert exchange["args"]["buckets"] == 1
    assert exchange["args"]["payload_bytes"] > 0
    assert "span_id" not in exchange["args"]
    assert not any(e["name"].endswith("/device")
                   or e["name"].startswith("train/grad_exchange/bucket")
                   for e in events)
    assert obs.registry().get(
        "chainermn_tpu_grad_exchange_payload_bytes_total") is None


def test_trainer_run_off_emits_nothing(tmp_path):
    from chainermn_tpu_torch.dataset import SerialIterator, TupleDataset
    assert obs.mode() == "off"
    obs.reset_tracer()
    obs.reset_registry()
    x, t = _data()
    _train(tmp_path / "out",
           SerialIterator(TupleDataset(x, t), 8, shuffle=False))
    assert not (tmp_path / "out" / "trace-rank0.jsonl").exists()
    assert obs.tracer().events() == []
    assert obs.registry().metrics() == {}


def test_input_stall_counter_every_iterator_kind_both_updaters(
        events_mode, tmp_path):
    """Every iterator kind on both updaters feeds
    ``chainermn_tpu_input_stall_ms_total``; the device-feed stage (which
    accounts its own stall) also reports ``input_stall_ms`` into the
    observation."""
    from chainermn_tpu_torch.dataset import (DevicePrefetchIterator,
                                             MultiprocessIterator,
                                             MultithreadIterator,
                                             SerialIterator, TupleDataset,
                                             concat_examples,
                                             identity_converter)
    from chainermn_tpu_torch.training import FusedUpdater
    x, t = _data()

    def kinds():
        ds = TupleDataset(x, t)
        yield "SerialIterator", SerialIterator(ds, 8, shuffle=False), {}
        yield "MultithreadIterator", MultithreadIterator(
            ds, 8, shuffle=False, n_threads=2), {}
        yield "MultiprocessIterator", MultiprocessIterator(
            ds, 8, shuffle=False, n_processes=2), {}
        # the device-feed stage converts; its batches arrive as tensors
        yield "DevicePrefetchIterator", DevicePrefetchIterator(
            SerialIterator(ds, 8, shuffle=False), device="cpu",
            converter=concat_examples), dict(converter=identity_converter)

    observed = {}
    for name, it, kw in kinds():
        trainer = _train(tmp_path / f"std-{name}", it, n_iter=2,
                         with_checkpoint=False, **kw)
        observed[name] = dict(trainer.observation)
    it = SerialIterator(TupleDataset(x, t), 8, shuffle=False)
    _train(tmp_path / "fused", it, n_iter=2, with_checkpoint=False,
           updater_cls=FusedUpdater, n_fused=2)
    counter = obs.registry().get("chainermn_tpu_input_stall_ms_total")
    labels = [dict(k) for k in counter.labels()]
    assert {("SerialIterator", "StandardUpdater"),
            ("MultithreadIterator", "StandardUpdater"),
            ("MultiprocessIterator", "StandardUpdater"),
            ("DevicePrefetchIterator", "StandardUpdater"),
            ("SerialIterator", "FusedUpdater")} \
        <= {(l["iterator"], l["updater"]) for l in labels}
    for l in labels:
        assert counter.value(**l) >= 0
    # the observation LogReport reads
    assert observed["DevicePrefetchIterator"]["input_stall_ms"] >= 0
    assert "input_stall_ms" not in observed["SerialIterator"]


def _engine(prefix_cache=False, num_pages=16):
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import ServingEngine
    lm = TransformerLM(n_vocab=64, d_model=32, n_heads=2, n_layers=1,
                       max_len=64, seed=0, device="cpu")
    return ServingEngine(lm, num_pages=num_pages, page_size=8, max_batch=2,
                         max_context=32, prefix_cache=prefix_cache,
                         device="cpu")


def _drain(eng, limit=80):
    step = 0
    while (eng.running or eng.scheduler.pending()) and step < limit:
        eng.step(now=float(step))
        step += 1


def test_serving_request_lifecycle_trace(events_mode, tmp_path):
    from chainermn_tpu_torch.serving import Request
    eng = _engine()
    req = Request(np.random.RandomState(0).randint(0, 64, 6),
                  max_new_tokens=3, arrival_time=0.0)
    eng.submit(req)
    _drain(eng)
    assert len(req.tokens) == 3
    shard = tmp_path / "trace-rank0.jsonl"
    obs.tracer().export(str(shard))
    events = obs.read_jsonl(str(shard))
    obs.validate_events(events)
    assert {"serve/queue_wait", "serve/prefill", "serve/decode_window",
            "serve/finish"} <= _span_names(events)
    lane = [e for e in events if e.get("tid") == 1 + req.request_id]
    assert {"serve/queue_wait", "serve/prefill", "serve/finish"} \
        <= _span_names(lane)
    reg = obs.registry()
    h = reg.get("chainermn_tpu_serving_queue_wait_ms")
    assert h is not None and h.value(tenant="default")[2] == 1
    g = reg.get("chainermn_tpu_serving_queue_depth")
    assert g is not None and g.value(tenant="default") == 0
    assert req.admit_time is not None


def test_serving_non_int_request_id_safe():
    from chainermn_tpu_torch.serving import Request
    prev = obs.set_mode("off")
    obs.reset_tracer()
    try:
        for mode in ("off", "events"):
            obs.set_mode(mode)
            eng = _engine()
            req = Request(np.arange(1, 7, dtype=np.int32), max_new_tokens=2,
                          request_id=f"req-{mode}", arrival_time=0.0)
            eng.submit(req)
            _drain(eng)
            assert len(req.tokens) == 2
        assert eng._req_tid(req) == eng._req_tid(req) > 0
    finally:
        obs.set_mode(prev)
        obs.reset_tracer()
        obs.reset_registry()


def test_readmitted_request_queue_wait_measured_from_last_admission(
        events_mode):
    from chainermn_tpu_torch.serving import Request
    eng = _engine(num_pages=4)
    for lo in (1, 11):
        eng.submit(Request(np.arange(lo, lo + 8, dtype=np.int32),
                           max_new_tokens=12, arrival_time=0.0))
    _drain(eng)
    assert eng.evictions >= 1
    waits = [e for e in obs.tracer().events()
             if e["ph"] == "B" and e["name"] == "serve/queue_wait"]
    readmits = [e for e in waits if e["args"].get("readmit")]
    assert readmits
    for e in readmits:
        assert e["args"]["duration_ms"] <= 3000, e["args"]
    obs.validate_events(sorted(obs.tracer().events(),
                               key=lambda e: e["ts"]))


def test_serving_eviction_and_suffix_prefill_metrics(events_mode):
    from chainermn_tpu_torch.serving import Request
    eng = _engine(prefix_cache=True, num_pages=6)
    rng = np.random.RandomState(0)
    prefix = rng.randint(0, 64, 8)
    for _ in range(2):
        eng.submit(Request(np.concatenate([prefix, rng.randint(0, 64, 4)]),
                           max_new_tokens=4, arrival_time=0.0))
    _drain(eng, 60)
    names = _span_names(obs.tracer().events())
    assert eng.prefix_hits >= 1
    assert "serve/suffix_prefill" in names
    reg = obs.registry()
    if eng.evictions:
        assert "serve/evict" in names
        assert reg.get("chainermn_tpu_serving_evictions_total") \
            .value(tenant="default") == eng.evictions
    if eng.forks:
        assert reg.get("chainermn_tpu_serving_forks_total").value() \
            == eng.forks


# -- the port's shards under the JAX tools ------------------------------------------

def _rank_shard_worker(rank, out_dir):
    """One traced step of a 2-rank gloo world; the trainer writes this
    rank's shard."""
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.dataset import SerialIterator, TupleDataset
    from chainermn_tpu_torch.models import MLP, Classifier
    from chainermn_tpu_torch.training import StandardUpdater, Trainer
    obs.set_mode("events")
    comm = create_communicator("flat", device="cpu")
    model = Classifier(MLP(n_units=16, n_out=3, seed=0, device="cpu"))
    opt = create_multi_node_optimizer(MomentumSGD(lr=0.05),
                                      comm).setup(model)
    x, t = _data(seed=rank)
    it = SerialIterator(TupleDataset(x, t), 8, shuffle=False)
    Trainer(StandardUpdater(it, opt), (2, "iteration"), out=out_dir).run()
    return obs.tracer().rank


def test_jax_tools_accept_and_merge_the_ports_rank_shards(tmp_path):
    """Two ranks' shards from the port's trainer (each stamped with its
    rank by the communicator) pass the JAX ``validate_events`` and merge
    in the JAX ``tools/trace_merge.py`` into one trace with a lane per
    rank."""
    import chainermn_tpu.observability as jax_obs
    from tests.test_torch_communicator import spawn_ranks
    out = tmp_path / "run"
    ranks = spawn_ranks(tmp_path, _rank_shard_worker, world=2,
                        out_dir=str(out))
    assert ranks == [0, 1]
    shards = [str(out / f"trace-rank{r}.jsonl") for r in (0, 1)]
    for p in shards:
        jax_obs.validate_events(jax_obs.read_jsonl(p))
    merged = _tools().merge_files(shards, str(tmp_path / "merged.json"))
    jax_obs.validate_events(merged)
    assert {e["pid"] for e in merged} == {0, 1}
    assert sum(e["name"] == "train/optimizer_update" and e["ph"] == "B"
               for e in merged) == 4


def test_device_ops_in_ranges_joins_launches_to_their_ranges():
    """``utils.device_ops_in_ranges`` on a synthetic ``torch.profiler``
    trace: a kernel or copy belongs to every matching range around its
    launch on the launching thread, nested ones each, joined by
    correlation; work launched outside, on another thread, or under
    another name is left out."""
    from chainermn_tpu_torch.utils import device_ops_in_ranges

    def rng_(name, ts, dur, tid=1):
        return {"cat": "user_annotation", "name": name, "ts": ts,
                "dur": dur, "pid": 0, "tid": tid}

    def launch(c, ts, tid=1):
        return {"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "pid": 0, "tid": tid, "args": {"correlation": c}}

    def op(c, cat="kernel", stream=7):
        return {"cat": cat, "name": f"op{c}", "ts": 100 + c, "pid": 1,
                "tid": stream, "args": {"correlation": c, "stream": stream}}

    events = [rng_("train.grad_exchange.bucket0.a", 0, 10),
              rng_("train.grad_exchange.bucket0.a.inner", 2, 3),
              rng_("other", 20, 10), rng_("train.x", 40, 10, tid=2),
              launch(1, 1), launch(2, 3), launch(3, 25), launch(4, 45),
              launch(5, 50), launch(6, 5, tid=2),
              op(1), op(2, "gpu_memcpy", 21), op(3), op(4), op(5),
              op(6, "gpu_memset")]
    got = [(name, o["name"], o["args"]["stream"]) for name, o in
           device_ops_in_ranges(events, "train.")]
    assert got == [("train.grad_exchange.bucket0.a", "op1", 7),
                   ("train.grad_exchange.bucket0.a", "op2", 21),
                   ("train.grad_exchange.bucket0.a.inner", "op2", 21)]


def test_serving_chunk_and_spec_spans(events_mode):
    """The JAX engine's chunked-prefill and speculation spans: a chunked
    admission's instant, its chunks' spans on the request's lane, and one
    ``serve/spec_window`` a verify step."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import Request, ServingEngine
    lm = TransformerLM(n_vocab=64, d_model=32, n_heads=2, n_layers=1,
                       max_len=64, seed=0, device="cpu")
    eng = ServingEngine(lm, num_pages=16, page_size=8, max_batch=2,
                        max_context=48, spec_k=2, chunk_tokens=8,
                        device="cpu")
    req = Request(np.random.RandomState(1).randint(0, 64, 20),
                  max_new_tokens=5, arrival_time=0.0)
    eng.submit(req)
    step = 0
    while (eng.running or eng.prefilling or eng.scheduler.pending()) \
            and step < 40:
        eng.step(now=float(step))
        step += 1
    assert len(req.tokens) == 5 and eng.chunk_prefills == 3
    events = sorted(obs.tracer().events(), key=lambda e: e["ts"])
    obs.validate_events(events)
    lane = [e for e in events if e.get("tid") == 1 + req.request_id]
    assert {"serve/chunk_admit", "serve/chunk_prefill", "serve/finish"} \
        <= _span_names(lane)
    chunks = [e for e in lane
              if e["ph"] == "B" and e["name"] == "serve/chunk_prefill"]
    assert [e["args"]["start"] for e in chunks] == [0, 8, 16]
    windows = [e for e in events
               if e["ph"] == "B" and e["name"] == "serve/spec_window"]
    assert len(windows) == eng.spec_steps > 0


def test_serving_disagg_transfer_span(events_mode):
    """The JAX engine's disaggregation trace: a prefix miss's
    ``serve/prefill`` tagged ``disagg``, one ``serve/page_transfer``
    instant a ship on the request's lane (pages and bytes in its tags),
    and the byte counter at the engine's ``transferred_page_bytes``."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import Request, ServingEngine
    lm = TransformerLM(n_vocab=64, d_model=32, n_heads=2, n_layers=1,
                       max_len=64, seed=0, device="cpu")
    eng = ServingEngine(lm, num_pages=16, page_size=8, max_batch=2,
                        max_context=32, disagg=True, device="cpu")
    reqs = [Request(np.random.RandomState(i).randint(0, 64, n),
                    max_new_tokens=3, arrival_time=0.0)
            for i, n in enumerate((6, 19))]
    for r in reqs:
        eng.submit(r)
    _drain(eng)
    assert eng.transfers == 2
    events = sorted(obs.tracer().events(), key=lambda e: e["ts"])
    obs.validate_events(events)
    ships = [e for e in events if e["name"] == "serve/page_transfer"]
    page = eng.kv.n_layers * eng.kv.page_bytes
    # 6 tokens: 1 page; 19 tokens: 3 pages, shipped as a block of 4
    assert [(e["tid"], e["args"]["pages"], e["args"]["bytes"])
            for e in ships] == [(1 + reqs[0].request_id, 1, page),
                                (1 + reqs[1].request_id, 4, 4 * page)]
    assert all(e["args"]["request"] == r.request_id
               for e, r in zip(ships, reqs))
    prefills = [e for e in events
                if e["ph"] == "B" and e["name"] == "serve/prefill"]
    assert len(prefills) == 2 and all(e["args"]["disagg"] for e in prefills)
    assert obs.registry().get(
        "chainermn_tpu_serving_transferred_page_bytes_total").value() \
        == eng.transferred_page_bytes == 5 * page


# -- device twins, with a fake event source -----------------------------------------

class _FakeDevice:
    """A device whose events complete when the test says so: ``now`` is
    the device clock (ms) an event recorded now reads, ``done`` the time
    up to which its work has run; it counts the synchronizes asked of
    it."""

    def __init__(self):
        self.now = 0.0
        self.done = 0.0
        self.stream = 7
        self.syncs = 0
        self.event_syncs = 0

    def accepts(self, device):
        return True

    def synchronize(self, device):
        self.syncs += 1
        self.done = self.now

    def record(self, device):
        return _FakeEvent(self, self.now), (0, self.stream)


class _FakeEvent:
    def __init__(self, dev, t):
        self.dev, self.t = dev, t

    def query(self):
        return self.t <= self.dev.done

    def synchronize(self):
        self.dev.event_syncs += 1
        self.dev.done = max(self.dev.done, self.t)

    def elapsed_time(self, later):
        return later.t - self.t


def _twin_tracer():
    dev = _FakeDevice()
    return tracing.SpanTracer(rank=1, device_events=dev), dev


def _device_span(tr, dev, name, start_ms, end_ms, tags=None):
    dev.now = start_ms
    span = tr.span(name, tags=tags, device="fake")
    dev.now = end_ms
    span.close()


def _twins(events):
    return [e for e in events if e["name"].endswith("/device")]


def test_device_twins_resolve_lazily_without_synchronize():
    """A finished pair is resolved by ``query()`` when a later device span
    opens; one still running stays pending; nothing synchronizes but the
    anchor until ``events()``, which resolves the rest and re-anchors."""
    tr, dev = _twin_tracer()
    dev.now = 5.0
    _device_span(tr, dev, "train/forward", 5.0, 9.0)
    assert dev.syncs == 1 and len(tr._pending) == 1
    dev.done = 9.0
    _device_span(tr, dev, "train/backward", 9.0, 20.0)
    assert len(tr._pending) == 1     # the forward's resolved, not this one
    assert [e["name"] for e in tr._events] == [
        "train/forward", "train/forward", "train/forward/device",
        "train/forward/device", "train/backward", "train/backward"]
    assert dev.syncs == 1 and dev.event_syncs == 0
    twins = _twins(tr.events())
    assert [(e["name"], e["ph"]) for e in twins] == [
        ("train/forward/device", "B"), ("train/forward/device", "E"),
        ("train/backward/device", "B"), ("train/backward/device", "E")]
    assert twins[0]["args"]["device_ms"] == 4.0
    assert twins[2]["args"]["device_ms"] == 11.0
    assert dev.event_syncs == 1 and dev.syncs == 2   # the new anchor
    assert not tr._pending


def test_device_twins_placed_from_the_anchor_with_the_span_id():
    """A twin's B sits at the anchor's host time plus the device time
    from the anchor, its E ``device_ms`` later, and it shares the host
    span's ``span_id``; its tags are its own."""
    tr, dev = _twin_tracer()
    _device_span(tr, dev, "train/forward", 100.0, 101.0)   # the anchor
    _device_span(tr, dev, "train/grad_exchange", 102.5, 103.25,
                  tags={"payload_bytes": 64})
    (_, anchor_us), = tr._anchors.values()
    events = tr.events()
    host = next(e for e in events if e["name"] == "train/grad_exchange"
                and e["ph"] == "B")
    b, e = _twins(events)[2:]
    assert b["ts"] == anchor_us + 2500 and e["ts"] == anchor_us + 3250
    assert b["args"] == {"device_ms": 0.75, "span_id": 2}
    assert host["args"] == {"payload_bytes": 64, "span_id": 2}
    assert b["tid"] == tracing.DEVICE_TID_BASE


def test_device_twins_one_track_per_stream_and_a_valid_shard(tmp_path):
    """Each stream is a device track of its own, named in the shard's
    metadata; the exported shard passes the port's and the JAX package's
    validators; ``clear()`` drops pending pairs and twins and keeps the
    anchor."""
    import chainermn_tpu.observability as jax_obs
    tr, dev = _twin_tracer()
    for k, stream in enumerate((7, 9, 7)):
        dev.stream = stream
        _device_span(tr, dev, f"s{k}", 2.0 * k, 2.0 * k + 1)
    path = tmp_path / "t.jsonl"
    tr.export(str(path))
    events = obs.read_jsonl(str(path))
    obs.validate_events(events)
    jax_obs.validate_events(events)
    tids = [e["tid"] for e in _twins(events) if e["ph"] == "B"]
    base = tracing.DEVICE_TID_BASE
    assert tids == [base, base + 1, base]
    names = {e["tid"]: e["args"]["name"] for e in events
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert names == {base: "cuda:0 stream 7", base + 1: "cuda:0 stream 9"}
    anchors = dict(tr._anchors)
    _device_span(tr, dev, "left", 9.0, 10.0)
    tr.clear()
    assert not tr._pending and tr._anchors == anchors
    assert tr.events() == []


def test_span_twins_only_on_a_device_the_source_accepts(events_mode):
    """The real source (``CudaEvents``) takes CUDA devices alone: a span
    given the CPU is a plain host span, with no event and no anchor."""
    tr = obs.tracer()
    assert isinstance(tr.device_events, tracing.CudaEvents)
    with obs.span("train/forward", device=torch.device("cpu")):
        pass
    assert [e["ph"] for e in tr.events()] == ["B", "E"]
    assert "args" not in tr.events()[0]
    assert not tr._anchors and not tr._pending


def test_step_phases_have_twins_with_fake_events(events_mode, tmp_path):
    """The trainer's step on the CPU with a fake event source in place of
    CUDA's: each phase span has its twin, matched by ``span_id``, and the
    update holds the six phases in order."""
    from chainermn_tpu_torch.dataset import SerialIterator, TupleDataset
    dev = _FakeDevice()
    obs.tracer().device_events = dev
    x, t = _data()
    _train(tmp_path / "out", SerialIterator(TupleDataset(x, t), 8,
                                            shuffle=False),
           with_checkpoint=False)
    events = obs.tracer().events()
    hosts = {e["args"]["span_id"]: e["name"] for e in events
             if e["ph"] == "B" and "span_id" in (e.get("args") or {})
             and not e["name"].endswith("/device")}
    twins = {e["args"]["span_id"]: e["name"] for e in _twins(events)
             if e["ph"] == "B"}
    assert twins == {k: f"{n}/device" for k, n in hosts.items()}
    assert sorted(hosts.values()) == sorted(3 * PHASES)
    # the first span's anchor, then a new one at the trainer's export
    # and at this events(): none a step
    assert dev.syncs == 3


# -- scope --------------------------------------------------------------------------

def test_scope_off_returns_singleton_no_alloc():
    assert obs.mode() == "off"
    assert obs.scope("model/bn_act") is tracing._NOOP
    import gc
    gc.collect()
    before = sys.getallocatedblocks()
    for _ in range(10_000):
        with obs.scope("model/bn_act"):
            pass
    gc.collect()
    assert sys.getallocatedblocks() - before < 100


def test_scope_full_opens_record_function_and_records_nothing(
        events_mode, monkeypatch):
    opened = []

    class _Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    import torch.profiler
    monkeypatch.setattr(torch.profiler, "record_function", _Range)
    assert obs.scope("model/bn_act") is tracing._NOOP   # events: none
    obs.set_mode("full")
    with obs.scope("model/bn_act"):
        pass
    assert opened == ["model.bn_act"] and obs.tracer().events() == []


def test_conv_bn_bitwise_the_same_off_and_full(tmp_path):
    """``ConvBN`` forward and backward (its batch norm and ReLU inside
    ``model/bn_act``) and a residual block (whose residual add and ReLU
    run in its last ``ConvBN``'s ``model/bn_act``) read bitwise the same
    with tracing off and under ``full`` in a profiler capture."""
    from torch.profiler import ProfilerActivity, profile
    from chainermn_tpu_torch.models.resnet import BottleneckBlock, ConvBN

    def run():
        torch.manual_seed(0)
        x = torch.randn(2, 8, 6, 6, requires_grad=True)
        out = {}
        for name, link in (("convbn", ConvBN(8, 8, 3, pad=1, seed=1,
                                             device="cpu")),
                           ("block", BottleneckBlock(8, 4, 8, seed=2,
                                                     device="cpu"))):
            y = link(x)
            y.square().sum().backward()
            out[name] = [y.detach()] + [x.grad.clone()] + [
                p.grad.clone() for _, p in link.namedparams()]
            x.grad = None
        return out

    assert obs.mode() == "off"
    want = run()
    prev = obs.set_mode("full")
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = run()
    finally:
        obs.set_mode(prev)
        obs.reset_tracer()
    for name in want:
        assert all(torch.equal(a, b) for a, b in zip(want[name], got[name]))
    ranges = {e.name() for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()}
    assert "model.bn_act" in ranges and "model.residual_act" not in ranges


# -- the joiner's backward pass -----------------------------------------------------

class _Kineto:
    """A raw profiler event (``kineto_results.events()``'s methods)."""

    def __init__(self, name, thread, start, end, device=False,
                 annotation=False, seq=-1, fwd=0, corr=0, linked=0):
        self._v = dict(name=name, thread=thread, start=start, end=end,
                       device=device, annotation=annotation, seq=seq,
                       fwd=fwd, corr=corr, linked=linked)

    def name(self):
        return self._v["name"]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v["device"]
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._v["annotation"]

    def start_thread_id(self):
        return self._v["thread"]

    def start_ns(self):
        return self._v["start"]

    def end_ns(self):
        return self._v["end"]

    def sequence_nr(self):
        return self._v["seq"]

    def fwd_thread_id(self):
        return self._v["fwd"]

    def correlation_id(self):
        return self._v["corr"]

    def linked_correlation_id(self):
        return self._v["linked"]


def _step_trace():
    """A step's host and device events as ``(kind, fields)`` rows: the
    main thread (1) runs the forward, with batch norm in ``model.bn_act``
    and a custom ``autograd.Function`` (the flash path) in
    ``model.attention``, and waits in ``train.backward``; autograd's
    thread (2) runs their nodes; one kernel is launched outside every
    range."""
    rows = []
    ext = iter(range(1, 100))
    corr = iter(range(1001, 1100))

    def annotate(name, a, b, thread=1):
        e = next(ext)
        rows.append(("range", dict(name=name, thread=thread, start=a,
                                   end=b, ext=e)))
        return e

    def op(name, a, b, thread=1, seq=-1, fwd=0, node=False):
        e = next(ext)
        rows.append(("node" if node else "op",
                     dict(name=name, thread=thread, start=a, end=b,
                          seq=seq, fwd=fwd, ext=e)))
        return e

    def kernel(name, at, linked, thread=1):
        c = next(corr)
        rows.append(("launch", dict(thread=thread, start=at, end=at + 1,
                                    corr=c, linked=linked)))
        rows.append(("kernel", dict(name=name, start=at + 100,
                                    end=at + 110, corr=c, linked=linked)))

    annotate("train.forward", 0, 100)
    annotate("model.bn_act", 10, 50)
    kernel("bn_fwd", 15, op("aten::native_batch_norm", 12, 30, seq=5))
    kernel("relu_fwd", 35, op("aten::relu", 33, 40, seq=6))
    annotate("model.attention", 55, 70)
    flash = op("FlashAttention", 56, 68, seq=7)
    kernel("flash_fwd", 60, op("aten::empty", 59, 61) and flash)
    kernel("conv_fwd", 80, op("aten::convolution", 78, 90, seq=8))
    annotate("train.backward", 110, 200)
    for name, seq, a in (("ReluBackward0", 6, 120), ("FlashBackward", 7, 135),
                         ("NativeBatchNormBackward0", 5, 150),
                         ("ConvolutionBackward0", 8, 165)):
        node = op(f"autograd::engine::evaluate_function: {name}", a, a + 10,
                  thread=2, seq=seq, fwd=1, node=True)
        kernel(f"{name}_kernel", a + 5, node, thread=2)
    kernel("outside", 300, op("aten::add", 299, 305))
    return rows


def _as_kineto(rows):
    out = []
    for kind, f in rows:
        if kind == "range":
            out.append(_Kineto(f["name"], f["thread"], f["start"], f["end"],
                               annotation=True, corr=f["ext"]))
        elif kind in ("op", "node"):
            out.append(_Kineto(f["name"], f["thread"], f["start"], f["end"],
                               seq=f["seq"], fwd=f["fwd"], corr=f["ext"]))
        elif kind == "launch":
            out.append(_Kineto("cudaLaunchKernel", f["thread"], f["start"],
                               f["end"], corr=f["corr"], linked=f["linked"]))
        else:
            out.append(_Kineto(f["name"], 0, f["start"], f["end"],
                               device=True, corr=f["corr"],
                               linked=f["linked"]))
    return out


def _as_chrome(rows):
    """The same trace as ``export_chrome_trace`` writes it: threads by
    their system ids (1 -> 501, 2 -> 502), a node's ``Fwd thread id`` the
    profiler's own."""
    out = []
    for kind, f in rows:
        base = {"ts": f["start"], "dur": f["end"] - f["start"]}
        if kind in ("range", "op", "node"):
            args = {"External id": f["ext"]}
            if kind != "range" and f["seq"] >= 0:
                args.update({"Sequence number": f["seq"],
                             "Fwd thread id": f["fwd"]})
            out.append(dict(base, name=f["name"], pid=9, tid=500 + f["thread"],
                            cat="user_annotation" if kind == "range"
                            else "cpu_op", args=args))
        elif kind == "launch":
            out.append(dict(base, name="cudaLaunchKernel", cat="cuda_runtime",
                            pid=9, tid=500 + f["thread"],
                            args={"correlation": f["corr"]}))
        else:
            out.append(dict(base, name=f["name"], cat="kernel", pid=0, tid=7,
                            args={"correlation": f["corr"], "stream": 7}))
    return out


@pytest.mark.parametrize("form", ["kineto", "chrome"])
def test_device_ops_in_ranges_gives_backward_kernels_their_forward_range(
        form):
    """Backward kernels, launched on autograd's thread, count in the
    ``train.backward`` range open on the thread that called backward and
    in the layer range of the forward op whose node ran them: batch
    norm's in ``model.bn_act``, the custom Function's in
    ``model.attention``; a kernel launched outside every range counts
    nowhere.  Both forms of a capture give the same join."""
    from chainermn_tpu_torch.utils import device_ops_in_ranges
    rows = _step_trace()
    events = _as_kineto(rows) if form == "kineto" else _as_chrome(rows)
    got = {}
    for name, op in device_ops_in_ranges(events, ("train.", "model.")):
        kernel = op.name() if form == "kineto" else op["name"]
        got.setdefault(kernel, []).append(name)
    assert got == {
        "bn_fwd": ["train.forward", "model.bn_act"],
        "relu_fwd": ["train.forward", "model.bn_act"],
        "flash_fwd": ["train.forward", "model.attention"],
        "conv_fwd": ["train.forward"],
        "ReluBackward0_kernel": ["model.bn_act", "train.backward"],
        "FlashBackward_kernel": ["model.attention", "train.backward"],
        "NativeBatchNormBackward0_kernel": ["model.bn_act",
                                            "train.backward"],
        "ConvolutionBackward0_kernel": ["train.backward"]}
    assert [n for n, _ in device_ops_in_ranges(events, "model.bn_act")] \
        == ["model.bn_act"] * 4


# -- one clock ----------------------------------------------------------------------

def test_export_writes_the_clock_pair(events_mode, tmp_path):
    """The shard's ``clock_sync`` metadata: the monotonic origin of
    ``ts`` and ``[monotonic_ns, time_ns]`` pairs from the tracer's
    creation and the export, which map a span's ``ts`` onto
    ``time.time_ns()``."""
    import time
    from chainermn_tpu_torch.tools import trace_merge
    tr = obs.tracer()
    before = time.time_ns()
    with tr.span("x"):
        pass
    after = time.time_ns()
    path = tmp_path / "t.jsonl"
    tr.export(str(path))
    events = obs.read_jsonl(str(path))
    clock = next(e["args"] for e in events
                 if e["ph"] == "M" and e["name"] == "clock_sync")
    assert set(clock) == {"t0_monotonic_ns", "created", "exported"}
    assert clock["created"][0] <= clock["exported"][0]
    assert clock["created"][0] >= clock["t0_monotonic_ns"]
    to_real = trace_merge.profiler_clock(clock)
    b = next(e for e in events if e["name"] == "x" and e["ph"] == "B")
    assert before - 2e6 <= to_real(b["ts"]) * 1000 <= after + 2e6


def test_trace_merge_profile_places_shards_on_the_profilers_clock(
        tmp_path):
    """``trace_merge --profile``: the shards' events join the capture's,
    each rank on its own pid, each ``ts`` mapped through its shard's
    clock pairs onto the capture's base; a shard without the pairs is
    refused."""
    from chainermn_tpu_torch.tools import trace_merge
    base = 1_700_000_000_000_000_000
    shards = []
    for rank in (0, 1):
        clock = {"t0_monotonic_ns": 5_000_000,
                 "created": [5_000_000, base + 1_000_000 + rank * 1000],
                 "exported": [9_000_000, base + 5_000_000 + rank * 1000]}
        shard = [_ev("process_name", "M", pid=rank, tid=0,
                     args={"name": f"rank{rank}"}),
                 _ev("clock_sync", "M", pid=rank, tid=0, args=clock),
                 _ev("train/forward", "B", 100, pid=rank),
                 _ev("train/forward", "E", 350, pid=rank)]
        p = tmp_path / f"trace-rank{rank}.jsonl"
        p.write_text("\n".join(json.dumps(e) for e in shard) + "\n")
        shards.append(str(p))
    kernel = {"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 7,
              "ts": 12.5, "dur": 3.0}
    profile = tmp_path / "trace.json"
    profile.write_text(json.dumps({"baseTimeNanoseconds": base,
                                   "traceEvents": [kernel]}))
    out = tmp_path / "merged.json"
    assert trace_merge.main(["--profile", str(profile), "-o", str(out),
                             *shards]) == 0
    merged = json.loads(out.read_text())
    assert merged["baseTimeNanoseconds"] == base
    assert merged["traceEvents"][0] == kernel
    spans = [(e["pid"], e["ph"], e["ts"]) for e in merged["traceEvents"]
             if e["name"] == "train/forward"]
    r = trace_merge.RANK_PID_BASE
    # 1 ms after the origin, plus 0.1 ms (0.35 ms), plus 1 µs on rank 1
    assert spans == [(r, "B", 1100.0), (r + 1, "B", 1101.0),
                     (r, "E", 1350.0), (r + 1, "E", 1351.0)]
    names = {e["pid"]: e["args"]["name"] for e in merged["traceEvents"]
             if e["name"] == "process_name"}
    assert names == {r: "rank0", r + 1: "rank1"}
    bare = tmp_path / "bare.jsonl"
    bare.write_text(json.dumps(_ev("s", "B", 1)) + "\n"
                    + json.dumps(_ev("s", "E", 2)) + "\n")
    assert trace_merge.main(["--profile", str(profile), "-o",
                             str(tmp_path / "x.json"), str(bare)]) == 1
    assert not (tmp_path / "x.json").exists()
