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


def _span_names(events):
    return {e["name"] for e in events if e["ph"] in ("B", "i")}


def test_trainer_run_produces_schema_valid_trace(events_mode, tmp_path):
    """A traced run leaves ``trace-rank0.jsonl`` in ``out``, valid under
    the port's validator and the JAX package's, with the trainer's span
    taxonomy: one ``train/optimizer_update``, ``train/grad_exchange`` and
    ``train/input_stall`` per iteration, the per-bucket instants, the
    checkpointer's ``train/checkpoint_serialize``, and the payload
    counter."""
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
            "train/grad_exchange", "train/grad_exchange/bucket0",
            "train/checkpoint_serialize"} <= names
    for name in ("train/input_stall", "train/optimizer_update",
                 "train/grad_exchange"):
        assert sum(e["name"] == name and e["ph"] == "B"
                   for e in events) == 3, name
    assert {e["pid"] for e in events} == {0}
    exchange = next(e for e in events if e["name"] == "train/grad_exchange"
                    and e["ph"] == "B")
    assert exchange["args"]["buckets"] == 1
    c = obs.registry().get("chainermn_tpu_grad_exchange_payload_bytes_total")
    assert c.value(bucket="0", exchange="flat") \
        == 3 * exchange["args"]["payload_bytes"] > 0


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
    trace: a kernel or copy belongs to the innermost matching range
    around its launch on the launching thread, joined by correlation;
    work launched outside, on another thread, or under another name is
    left out."""
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
                   ("train.grad_exchange.bucket0.a.inner", "op2", 21)]
