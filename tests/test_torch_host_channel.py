"""The port's host channel against the JAX package's tests
(``tests/resilience_tests/test_host_channel_resilience.py``): per-op
deadlines, bounded retry with exponential backoff, key cleanup in
``finally``, heartbeat -> ``PeerLostError``, generation rotation, the
abort flag, and injected transport faults (lost chunk, stale key,
transient raise).

Each twin runs on four backends: the JAX tests' own ``FakeKV`` and
``FakeClock``, and :class:`StoreKV` (the port's adapter) over a
``HashStore``, a ``FileStore`` and a ``TCPStore``.  On the real stores the
channel and the adapter's polls still read the fake clock (a blocking get
on a missing key polls until the fake deadline without waiting), so the
backoff sequences are asserted exactly on every backend; the adapter's
polls advance the clock without being recorded as the channel's sleeps.
Every check is exact (key sets, sleep lists, payloads): no tolerance.
"""

import datetime
import time

import pytest
import torch.distributed as dist

from chainermn_tpu_torch.communicators import bind_host_channel
from chainermn_tpu_torch.communicators._host_channel import (
    TOMBSTONE, ChannelTimeoutError, HostChannel, PeerLostError, StoreKV)
from chainermn_tpu_torch.communicators.fault_schedule import (FaultSchedule,
                                                              InjectedFault)
from tests.resilience_tests.test_host_channel_resilience import (FakeClock,
                                                                 FakeKV)

BACKENDS = ("fake", "hash", "file", "tcp")


def _tcp_store():
    return dist.TCPStore("127.0.0.1", 0, 1, True,
                         timeout=datetime.timedelta(seconds=30),
                         wait_for_workers=False)


class RecordingKV(StoreKV):
    """:class:`StoreKV` that remembers which keys are live, so the tests
    can read the store's key set as they read ``FakeKV.store``."""

    def __init__(self, store, clock, barrier_parties=1):
        def advance(s):
            clock.t += s
        super().__init__(store, parties=barrier_parties, clock=clock,
                         sleep=advance)
        self.live = set()

    def key_value_set(self, key, value):
        super().key_value_set(key, value)
        self.live.add(key)

    def key_value_set_bytes(self, key, value):
        super().key_value_set_bytes(key, value)
        self.live.add(key)

    def key_value_delete(self, key):
        super().key_value_delete(key)
        self.live.discard(key)

    def keys(self):
        return set(self.live)

    def value(self, key):
        return self.key_value_try_get(key)


class _FakeView(FakeKV):
    def keys(self):
        return set(self.store)

    def value(self, key):
        return self.store[key]


@pytest.fixture(params=BACKENDS)
def backend(request, tmp_path):
    """``make_kv(clock, barrier_parties=1)`` for one backend."""
    name = request.param
    stores = []

    def make_kv(clock, barrier_parties=1):
        if name == "fake":
            return _FakeView(clock, barrier_parties=barrier_parties)
        if name == "hash":
            store = dist.HashStore()
        elif name == "file":
            store = dist.FileStore(str(tmp_path / f"s{len(stores)}"), 1)
        else:
            store = _tcp_store()
        stores.append(store)
        return RecordingKV(store, clock, barrier_parties)

    make_kv.name = name
    return make_kv


def make_channel(backend, clock=None, kv=None, pid=0, nprocs=2, **kwargs):
    clock = clock or FakeClock()
    kv = kv if kv is not None else backend(clock)
    kwargs.setdefault("timeout_ms", 1000)
    ch = HostChannel(namespace="t", client=kv, clock=clock,
                     sleep=clock.sleep, process_id=pid,
                     num_processes=nprocs, **kwargs)
    return ch, kv, clock


# -- retry / backoff / deadlines --------------------------------------------

def test_recv_missing_message_times_out_typed(backend):
    ch, kv, clock = make_channel(backend, timeout_ms=1000, max_retries=2,
                                 backoff_base_s=0.05)
    with pytest.raises(ChannelTimeoutError) as ei:
        ch.recv_obj(1)
    err = ei.value
    assert err.op == "p2p" and "p2p/1-0" in err.key
    assert err.timeout_ms == 1000
    assert err.attempts >= 1


def test_backoff_sequence_doubles_and_caps(backend):
    ch, kv, clock = make_channel(backend, timeout_ms=3_600_000,
                                 max_retries=4, backoff_base_s=0.05,
                                 backoff_max_s=0.3)
    sched = FaultSchedule([dict(op="hc.get", prob=1.0, count=None)])
    bind_host_channel(ch, sched, sleep=clock.sleep)
    with pytest.raises(ChannelTimeoutError):
        ch.recv_obj(1)
    # the pauses between the 5 attempts double, then cap; none after the
    # last, already decided failure
    assert clock.sleeps == [0.05, 0.1, 0.2, 0.3]


def test_transient_fault_absorbed_by_retry(backend):
    ch, kv, clock = make_channel(backend)
    ch2, _, _ = make_channel(backend, kv=kv, clock=clock, pid=1)
    ch2.send_obj({"v": 41}, 0)
    sched = FaultSchedule([dict(op="hc.get", nth=1)])
    bind_host_channel(ch, sched, sleep=clock.sleep)
    assert ch.recv_obj(1) == {"v": 41}
    assert ch.stats["retries"] == 1


def test_per_op_timeout_overrides_default(backend):
    ch, kv, clock = make_channel(backend, timeout_ms=50_000,
                                 op_timeouts={"p2p": 500}, max_retries=0)
    t0 = clock.t
    with pytest.raises(ChannelTimeoutError) as ei:
        ch.recv_obj(1)
    assert ei.value.timeout_ms == 500
    assert clock.t - t0 <= 1.5


def test_peer_lost_not_retried(backend):
    clock = FakeClock()
    kv = backend(clock)
    ch, _, _ = make_channel(backend, clock=clock, kv=kv, max_retries=5,
                            timeout_ms=60_000)
    ch.enable_heartbeat(interval_s=1.0, stall_s=3.0, wall=clock,
                        thread=False)
    kv.key_value_set(f"{ch._prefix()}/hb/1", "1:somewhen")
    clock.t += 10.0
    with pytest.raises(PeerLostError) as ei:
        ch.recv_obj(1)
    assert ei.value.rank == 1
    assert ei.value.stale_s >= 3.0
    assert clock.sleeps == []


def test_heartbeat_clock_skew_cannot_fabricate_lost_peer(backend):
    clock = FakeClock()
    ch, kv, _ = make_channel(backend, clock=clock)
    mon = ch.enable_heartbeat(interval_s=1.0, stall_s=2.0, wall=clock,
                              thread=False)
    for step in range(10):
        kv.key_value_set(f"{ch._prefix()}/hb/1", f"{step}:-99999.0")
        clock.t += 5.0
        mon.check()


def test_heartbeat_never_accuses_silent_never_beaten_peer(backend):
    clock = FakeClock()
    ch, kv, _ = make_channel(backend, clock=clock)
    mon = ch.enable_heartbeat(interval_s=1.0, stall_s=2.0, wall=clock,
                              thread=False)
    clock.t += 100.0
    mon.check()


def test_heartbeat_beat_rate_limited(backend):
    clock = FakeClock()
    ch, kv, _ = make_channel(backend, clock=clock)
    mon = ch.enable_heartbeat(interval_s=5.0, wall=clock, thread=False)
    key = f"{ch._prefix()}/hb/0"
    first = kv.value(key)
    clock.t += 1.0
    mon.beat()
    assert kv.value(key) == first
    clock.t += 5.0
    mon.beat()
    assert kv.value(key) != first


# -- abort fail-stop ---------------------------------------------------------

def test_posted_abort_unblocks_receiver(backend):
    ch, kv, clock = make_channel(backend)
    ch.post_abort("host 1: deliberate")
    with pytest.raises(RuntimeError, match="aborted by a peer"):
        ch.recv_obj(1)
    ch.clear_abort()
    ch2, _, _ = make_channel(backend, kv=kv, clock=clock, pid=1)
    ch2.send_obj("after-clear", 0)
    assert ch.recv_obj(1) == "after-clear"


# -- key hygiene -------------------------------------------------------------

def _payload_keys(kv):
    return {k for k in kv.keys()
            if "/hb/" not in k and not k.endswith("abort")}


def test_p2p_roundtrip_leaves_no_keys(backend):
    ch, kv, clock = make_channel(backend)
    ch2, _, _ = make_channel(backend, kv=kv, clock=clock, pid=1)
    ch2.send_obj(b"x" * 3_000_000, 0)  # multi-chunk (1 MiB chunks)
    assert ch.recv_obj(1) == b"x" * 3_000_000
    assert _payload_keys(kv) == set()


def test_send_failure_cleans_chunks_and_rolls_back_seq(backend):
    ch, kv, clock = make_channel(backend)
    sched = FaultSchedule([dict(op="hc.chunk", nth=2)])
    bind_host_channel(ch, sched, sleep=clock.sleep)
    with pytest.raises(InjectedFault):
        ch.send_obj(b"y" * 3_000_000, 1)
    assert _payload_keys(kv) == set()
    ch.send_obj("retry", 1)
    ch1, _, _ = make_channel(backend, kv=kv, clock=clock, pid=1)
    assert ch1.recv_obj(0) == "retry"


def test_send_fault_after_publish_keeps_message_and_sequence(backend):
    ch, kv, clock = make_channel(backend)
    sched = FaultSchedule([dict(op="hc.put", nth=1)])
    bind_host_channel(ch, sched, sleep=clock.sleep)
    with pytest.raises(InjectedFault):
        ch.send_obj("published-despite-fault", 1)
    ch.send_obj("second", 1)
    ch1, _, _ = make_channel(backend, kv=kv, clock=clock, pid=1)
    assert ch1.recv_obj(0) == "published-despite-fault"
    assert ch1.recv_obj(0) == "second"


def test_allgather_failure_cleans_own_keys_in_finally(backend):
    ch, kv, clock = make_channel(backend, timeout_ms=500, max_retries=0,
                                 nprocs=2)
    with pytest.raises(ChannelTimeoutError):
        ch.allgather({"mine": 1})
    assert _payload_keys(kv) == set()


def test_allgather_torn_multichunk_put_cleans_written_chunks(backend):
    ch, kv, clock = make_channel(backend, nprocs=1)
    sched = FaultSchedule([dict(op="hc.chunk", nth=2)])
    bind_host_channel(ch, sched, sleep=clock.sleep)
    with pytest.raises(InjectedFault):
        ch.allgather(b"z" * 3_000_000)
    assert _payload_keys(kv) == set()


def test_bcast_root_failure_cleans_value_key(backend):
    clock = FakeClock()
    kv = backend(clock, barrier_parties=2)  # the done barrier never fills
    ch, _, _ = make_channel(backend, clock=clock, kv=kv, timeout_ms=500,
                            max_retries=0)
    with pytest.raises(ChannelTimeoutError):
        ch.bcast({"payload": 9}, root=0)
    assert _payload_keys(kv) == set()


def test_single_party_allgather_and_bcast_round_trip(backend):
    ch, kv, clock = make_channel(backend, nprocs=1)
    assert ch.allgather({"me": 0}) == [{"me": 0}]
    assert ch.bcast("b") == "b"
    ch.barrier()
    assert _payload_keys(kv) == set()


# -- generation rotation -----------------------------------------------------

def test_bump_generation_isolates_stranded_keys(backend):
    ch, kv, clock = make_channel(backend)
    ch1, _, _ = make_channel(backend, kv=kv, clock=clock, pid=1)
    ch1.send_obj("stale-from-g0", 0)
    assert _payload_keys(kv) != set()
    g = ch.bump_generation()
    assert g == 1 and ch.generation == 1
    ch1.bump_generation()
    ch1.send_obj("fresh-g1", 0)
    assert ch.recv_obj(1) == "fresh-g1"
    # the stranded g0 message is still there, unmatched
    assert any(k.startswith("t/g0/p2p/1-0") for k in _payload_keys(kv))


def test_lost_chunk_fault_times_out_then_recovers_next_generation(backend):
    ch, kv, clock = make_channel(backend, timeout_ms=400, max_retries=1)
    ch1, _, _ = make_channel(backend, kv=kv, clock=clock, pid=1)
    sched = FaultSchedule([dict(op="hc.put", nth=1, action="lost_chunk")])
    bind_host_channel(ch1, sched, sleep=clock.sleep)
    ch1.send_obj("doomed", 0)
    with pytest.raises(ChannelTimeoutError):
        ch.recv_obj(1)
    ch.bump_generation()
    ch1.bump_generation()
    ch1.send_obj("healthy", 0)
    assert ch.recv_obj(1) == "healthy"


def test_stale_key_fault_surfaces_as_timeout_not_hang(backend):
    ch, kv, clock = make_channel(backend, timeout_ms=400, max_retries=1)
    ch1, _, _ = make_channel(backend, kv=kv, clock=clock, pid=1)
    sched = FaultSchedule([dict(op="hc.put", nth=1, action="stale_key")])
    bind_host_channel(ch1, sched, sleep=clock.sleep)
    ch1.send_obj("corrupted-meta", 0)
    with pytest.raises(ChannelTimeoutError):
        ch.recv_obj(1)


def test_stats_counters(backend):
    ch, kv, clock = make_channel(backend, timeout_ms=300, max_retries=1)
    with pytest.raises(ChannelTimeoutError):
        ch.recv_obj(1)
    assert ch.stats["timeouts"] == 1
    ch2, _, _ = make_channel(backend, kv=kv, clock=clock, pid=1)
    ch2.send_obj(1, 0)
    ch.recv_obj(1)
    assert ch.stats["cleaned_keys"] >= 1


# -- the adapter itself ------------------------------------------------------

class _NoDeleteStore:
    """A store without ``delete_key`` (the adapter's tombstone fallback)."""

    def __init__(self):
        self._store = dist.HashStore()

    def __getattr__(self, name):
        return getattr(self._store, name)

    def delete_key(self, key):
        raise NotImplementedError("deleteKey")


def _store(kind, tmp_path, name="s"):
    return {"hash": dist.HashStore,
            "file": lambda: dist.FileStore(str(tmp_path / name), 1),
            "tcp": _tcp_store, "nodelete": _NoDeleteStore}[kind]()


@pytest.mark.parametrize("kind", ["hash", "file", "tcp", "nodelete"])
def test_store_adapter_surface(kind, tmp_path):
    """``StoreKV`` on each store: ``str`` where the JAX client returns
    ``str``, bytes for the ``_bytes`` calls, a delete that removes the key
    (a tombstone that reads as absent on a store without ``delete_key``),
    a probe of an absent key that creates nothing, and barriers whose
    keys the last party out removes."""
    store = _store(kind, tmp_path)
    kv = StoreKV(store, parties=1)
    base = store.num_keys()
    assert kv._probe("a") is None and store.num_keys() == base
    kv.key_value_set("a", 12)
    assert kv.key_value_try_get("a") == "12"
    kv.key_value_set_bytes("b", b"\x00\x01")
    assert kv.blocking_key_value_get_bytes("b", 100) == b"\x00\x01"
    assert kv.blocking_key_value_get("a", 100) == "12"
    kv.key_value_delete("a")
    if kind == "nodelete":
        assert store.get("a") == TOMBSTONE
    else:
        assert not store.check(["a"])
    with pytest.raises(KeyError):
        kv.key_value_try_get("a")
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        kv.blocking_key_value_get("a", 50)
    assert time.monotonic() - t0 < 5.0
    kv.key_value_set("a", "back")           # a deleted key is set again
    assert kv.key_value_try_get("a") == "back"
    kv.key_value_delete("a")
    kv.key_value_delete("b")
    kv.key_value_delete("never-set")        # creates nothing
    assert not store.check(["never-set"])
    before = store.num_keys()
    for i in range(3):
        kv.wait_at_barrier(f"bar{i}", 100)
    if kind != "nodelete":                  # tombstones stay keys there
        assert store.num_keys() == before
    two = kv.with_parties(2)
    assert two.store is store and two.parties == 2
    with pytest.raises(TimeoutError):
        two.wait_at_barrier("alone", 50)


@pytest.mark.parametrize("kind", ["hash", "file", "tcp"])
def test_store_keys_stay_bounded_over_matched_ops(kind, tmp_path):
    """Two channels in two threads over one store: after N allgathers,
    broadcasts, barriers and point-to-point round trips (some of them
    chunked) the store holds the keys it held before, so a long job's
    store does not grow with its traffic."""
    import threading
    store = _store(kind, tmp_path)
    chans = [HostChannel(namespace="job", client=StoreKV(store, parties=2),
                         process_id=p, num_processes=2, chunk_bytes=64,
                         timeout_ms=30_000) for p in (0, 1)]
    big = list(range(100))                  # several 64-byte chunks

    def ops(ch, out):
        me, peer = ch.process_id, 1 - ch.process_id
        for step in range(20):
            out.append(ch.allgather((me, step)))
            out.append(ch.bcast(big if me == 0 else None, root=0))
            ch.barrier()
            ch.send_obj((me, step, big), peer, tag=step % 2)
            out.append(ch.recv_obj(peer, tag=step % 2))

    base = store.num_keys()
    outs = [[], []]
    errors = []

    def run(p):
        try:
            ops(chans[p], outs[p])
        except BaseException as e:  # noqa: BLE001 (reported below)
            errors.append(e)
    threads = [threading.Thread(target=run, args=(p,)) for p in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert outs[0][0] == outs[1][0] == [(0, 0), (1, 0)]
    assert outs[0][2] == (1, 0, big) and outs[1][2] == (0, 0, big)
    assert store.num_keys() == base


def test_tcp_store_client_usable_after_timed_out_wait_and_get():
    """A TCPStore client whose ``wait`` or ``get`` timed out still serves
    the next calls (the channel's timeouts never leave it broken)."""
    server = _tcp_store()
    client = dist.TCPStore("127.0.0.1", server.port, 1, False,
                           timeout=datetime.timedelta(seconds=1))
    with pytest.raises(Exception):
        client.wait(["missing"], datetime.timedelta(milliseconds=100))
    client.set("k", b"v")
    assert client.get("k") == b"v"
    with pytest.raises(Exception):
        client.get("missing-too")
    client.set("k2", b"w")
    assert server.get("k2") == b"w" and client.check(["k"])
    kv = StoreKV(client)
    with pytest.raises(TimeoutError):
        kv.blocking_key_value_get("never", 30)
    kv.key_value_set("after", "ok")
    assert StoreKV(server).key_value_try_get("after") == "ok"


def test_except_hook_posts_the_abort_flag(monkeypatch):
    """The global except hook posts the channel's abort flag before its
    hard exit: a peer blocked in a channel get raises at once instead of
    waiting out its deadline (the JAX hook's ``post_abort``)."""
    import os
    import sys

    from chainermn_tpu_torch import global_except_hook
    from chainermn_tpu_torch.communicators import _host_channel
    store = dist.HashStore()
    mine = HostChannel(namespace="job", client=StoreKV(store),
                       process_id=0, num_processes=2, timeout_ms=60_000)
    peer = HostChannel(namespace="job", client=StoreKV(store),
                       process_id=1, num_processes=2, timeout_ms=60_000)
    monkeypatch.setattr(_host_channel, "get_host_channel", lambda: mine)
    monkeypatch.setattr(global_except_hook, "_hook_installed", False)
    monkeypatch.setattr(sys, "excepthook", sys.__excepthook__)
    exits = []
    monkeypatch.setattr(os, "_exit", exits.append)
    global_except_hook.add_hook()
    sys.excepthook(RuntimeError, RuntimeError("boom"), None)
    assert exits == [1]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="aborted by a peer.*boom"):
        peer.recv_obj(0)
    assert time.monotonic() - t0 < 5.0
