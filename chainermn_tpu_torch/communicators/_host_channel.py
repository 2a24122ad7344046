"""Cross-process host-side object channel over the job's key-value store.

The port of ``chainermn_tpu.communicators._host_channel`` (reference: the
pickled-object MPI transport of ``chainermn/communicators/
mpi_communicator_base.py · send_obj/recv_obj/bcast_obj/allgather_obj``).
The JAX package's control plane is ``jax.distributed``'s coordination
service; the port's is a ``torch.distributed.Store``: by default the
default process group's store (``torchrun``'s TCPStore, or the FileStore
or HashStore a program hands ``init_process_group``), reached through
:class:`StoreKV`, which gives the store the JAX client's method names.
So the JAX tests' in-memory fakes and a real store run the same channel
code.  Tensors never travel here: the data plane is NCCL (gloo on the
CPU).  The store must outlive every rank (under ``torchrun`` the agent
hosts it): the job ends with the store's host, as the JAX one ends with
its coordination service.

Design, as in the JAX package:

* Values are pickled bytes, chunked (default 1 MiB; ``chunk_bytes``).
* Point-to-point messages are sequenced per ``(src, dst, tag)`` on both
  ends, so repeated sends match repeated recvs in order.
* Collective helpers (``allgather``/``bcast``/``barrier``) are
  epoch-counted: every process calls them in the same order.
* Keys are deleted by their reader(s) once consumed, and by their writer
  in a ``finally`` when a collective fails partway, so an exception never
  strands keys that would poison the next matched op.

Failure semantics:

* Every op runs under a per-op deadline (``op_timeouts``) with bounded
  retry and exponential backoff for transient transport errors;
  exhaustion raises :class:`ChannelTimeoutError` (op and key).
* An optional heartbeat monitor posts this process's liveness and audits
  the peers' while blocked in a get, turning a stalled peer into
  :class:`PeerLostError` with the suspected rank.
* All keys live under a generation prefix; ``bump_generation()`` (the
  recovery supervisor calls it) rotates it, so keys stranded by a fault
  never match the recovered incarnation's ops.
* Fault hook points (``set_fault_hook``) let the chaos tests inject
  transport faults (lost chunk, stale meta key, straggle, transient
  raise) at the put/get/barrier sites.
* ``post_abort`` (the global except hook calls it) makes every peer
  blocked in a get raise instead of hanging.

The store's own calls differ from the JAX client's, and :class:`StoreKV`
bridges them: ``Store.get`` of a missing key blocks until the store-wide
timeout, and a TCPStore client holds its connection for the whole of a
``wait`` (the heartbeat thread's ``set`` would queue behind it), so a
probe is one ``compare_set`` that never blocks (it gives back the value,
or its own sentinel when the key is absent) and a blocking get polls it
with a short backoff up to its own deadline; a delete removes the key
(``delete_key``; a store without it gets a tombstone value that reads as
absent); a barrier is an ``add`` on a counter plus a done key that the
last arrival sets, and the last of its parties to leave removes its keys.
So every matched op takes its keys back out of the store: a long job's
store does not grow with its traffic.  The store returns ``bytes``; the
adapter returns ``str`` where the JAX client does.
"""

from __future__ import annotations

import pickle
import threading
import time

__all__ = ["HostChannel", "HeartbeatMonitor", "StoreKV",
           "get_host_channel", "reset_host_channel", "ChannelError",
           "ChannelTimeoutError", "PeerLostError"]

_DEFAULT_CHUNK = 1 << 20  # 1 MiB
_DEFAULT_TIMEOUT_MS = 600_000


class ChannelError(RuntimeError):
    """Base class for typed host-channel transport failures."""


class ChannelTimeoutError(ChannelError):
    """An op exhausted its deadline/retry budget.  Carries op and key."""

    def __init__(self, op, key, timeout_ms, attempts):
        self.op = op
        self.key = key
        self.timeout_ms = timeout_ms
        self.attempts = attempts
        super().__init__(
            f"host-channel {op!r} timed out on {key!r} after "
            f"{attempts} attempt(s) within {timeout_ms} ms")


class PeerLostError(ChannelError):
    """A peer's heartbeat went stale while we were blocked on it."""

    def __init__(self, rank, stale_s):
        self.rank = rank
        self.stale_s = stale_s
        super().__init__(
            f"peer process {rank} presumed lost: heartbeat stale for "
            f"{stale_s:.1f}s")


#: the value a delete writes on a store without ``delete_key``; it reads
#: as absent
TOMBSTONE = b"\x00chainermn-tpu-deleted\x00"
#: what a probe of an absent key gives back (``compare_set`` returns the
#: expected value when the key is missing)
_ABSENT = b"\x00chainermn-tpu-absent\x00"


class StoreKV:
    """A ``torch.distributed.Store`` with the JAX coordination client's
    method names (``key_value_set``, ``key_value_set_bytes``,
    ``key_value_try_get``, ``blocking_key_value_get``,
    ``blocking_key_value_get_bytes``, ``key_value_delete``,
    ``wait_at_barrier``).  ``parties``: how many processes a barrier
    waits for (:meth:`with_parties` gives a sibling over the same store
    for a subset of them).  ``poll_s``: the longest pause between two
    probes of a blocking get."""

    def __init__(self, store, parties=1, poll_s=0.002,
                 sleep=time.sleep, clock=time.monotonic):
        self.store = store
        self.parties = int(parties)
        self.poll_s = float(poll_s)
        self._sleep = sleep
        self._clock = clock

    def with_parties(self, parties):
        """The same store, barriers over ``parties`` processes."""
        return StoreKV(self.store, parties, self.poll_s, self._sleep,
                       self._clock)

    def key_value_set(self, key, value):
        self.store.set(key, str(value).encode())

    def key_value_set_bytes(self, key, value):
        self.store.set(key, bytes(value))

    def _probe(self, key):
        """The value under ``key``, or None (absent or deleted); never
        blocks, and one round trip: ``compare_set`` with an expected value
        no key holds sets nothing and returns the value, or the expected
        value itself when the key is absent."""
        value = self.store.compare_set(key, _ABSENT, _ABSENT)
        return None if value in (_ABSENT, TOMBSTONE) else value

    def key_value_try_get(self, key):
        value = self._probe(key)
        if value is None:
            raise KeyError(key)
        return value.decode()

    def blocking_key_value_get_bytes(self, key, timeout_ms):
        deadline = self._clock() + timeout_ms / 1000.0
        pause = 2e-5
        while True:
            value = self._probe(key)
            if value is not None:
                return value
            now = self._clock()
            if now >= deadline:
                raise TimeoutError(f"key {key!r} not set within "
                                   f"{timeout_ms} ms")
            self._sleep(min(pause, deadline - now))
            pause = min(2 * pause, self.poll_s)

    def blocking_key_value_get(self, key, timeout_ms):
        return self.blocking_key_value_get_bytes(key, timeout_ms).decode()

    def key_value_delete(self, key):
        try:
            self.store.delete_key(key)
        except (AttributeError, NotImplementedError, RuntimeError):
            if self.store.check([key]):
                self.store.set(key, TOMBSTONE)

    def wait_at_barrier(self, barrier_id, timeout_ms):
        """Every one of ``parties`` processes arrives, or ``TimeoutError``
        at the deadline.  An id names one barrier.  Each party counts
        itself out once it has seen the done key, and the last one out
        removes the barrier's keys (a party that timed out leaves them,
        under its generation's prefix)."""
        arrive, done, left = (f"{barrier_id}/arrive", f"{barrier_id}/done",
                              f"{barrier_id}/left")
        if self.store.add(arrive, 1) == self.parties:
            self.store.set(done, b"1")
        self.blocking_key_value_get_bytes(done, timeout_ms)
        if self.store.add(left, 1) == self.parties:
            for key in (arrive, done, left):
                self.key_value_delete(key)


def _kv_client():
    """The default process group's store as a :class:`StoreKV`, or None
    without a process group."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            from torch.distributed.distributed_c10d import _get_default_store
            return StoreKV(_get_default_store(),
                           parties=dist.get_world_size())
    except Exception:  # noqa: BLE001 (no group: no channel)
        pass
    return None


def _process_index():
    """``(rank, world size)`` of this process in the default process
    group, ``(0, 1)`` without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class HeartbeatMonitor:
    """Liveness over the KV store: each process posts a beat token under
    its rank; ``check()`` raises :class:`PeerLostError` for a peer whose
    token has not *changed* for longer than ``stall_s``.

    Staleness is measured entirely on the observer's clock — the time
    since this process last saw the peer's token change — never by
    differencing two hosts' wall clocks, so cross-host clock skew cannot
    fabricate a lost peer.

    A peer that has *never* beaten is not accused — processes may enable
    heartbeats at different times, and absence of the key is
    indistinguishable from "not enabled".  Detection therefore needs one
    observed beat from the peer, after which frozen silence is evidence.

    Without the background ``thread``, beats are only posted from inside
    blocked channel gets — a peer busy in a long compile/compute stretch
    would go stale and be falsely accused.  Production use should keep
    the daemon beater (the ``enable_heartbeat`` default); thread-less
    mode exists for deterministic fake-clock tests, where ``stall_s``
    must exceed the longest legitimate beat gap.
    """

    def __init__(self, channel, interval_s=2.0, stall_s=None,
                 wall=time.time):
        self._ch = channel
        self.interval_s = float(interval_s)
        self.stall_s = float(stall_s) if stall_s is not None \
            else 5.0 * self.interval_s
        self._wall = wall
        self._last_beat = float("-inf")
        self._beat_counter = 0
        self._seen = {}  # rank -> (token, observer-local first-seen time)
        self._thread = None
        self._stop = threading.Event()

    def start_thread(self):
        """Daemon beater: posts liveness every ``interval_s`` regardless
        of what the main thread is doing (compiles, compute), so only a
        truly dead/hung *process* ever goes stale."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                self.beat(force=True)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="cmn-heartbeat")
        self._thread.start()

    def stop_thread(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=self.interval_s + 1.0)
            self._thread = None

    def _key(self, rank):
        return f"{self._ch._prefix()}/hb/{rank}"

    def beat(self, force=False):
        now = self._wall()
        if not force and now - self._last_beat < self.interval_s:
            return
        self._last_beat = now
        self._beat_counter += 1
        try:
            # the value is an opaque change-token, never compared to any
            # clock: the counter guarantees every beat is a fresh value
            self._ch._client.key_value_set(
                self._key(self._ch.process_id),
                f"{self._beat_counter}:{now!r}")
        except Exception:
            pass  # liveness posting must never take the poster down

    def check(self):
        now = self._wall()
        for rank in range(self._ch.num_processes):
            if rank == self._ch.process_id:
                continue
            try:
                raw = self._ch._client.key_value_try_get(self._key(rank))
            except Exception:
                raw = None
            if raw is None:
                continue
            prev = self._seen.get(rank)
            if prev is None or prev[0] != raw:
                self._seen[rank] = (raw, now)  # fresh token: alive
                continue
            stale = now - prev[1]
            if stale > self.stall_s:
                raise PeerLostError(rank, stale)


class HostChannel:
    """Pickled-object transport between controller processes.

    One instance per (communicator, namespace).  All methods are
    host-side and blocking; they must be called in SPMD lock-step where
    documented (allgather/bcast/barrier), mirroring MPI semantics.

    ``op_timeouts`` maps op families (``"p2p"``, ``"allgather"``,
    ``"bcast"``, ``"barrier"``) to per-op deadlines in ms (default:
    ``timeout_ms``).  ``max_retries``/``backoff_base_s``/``backoff_max_s``
    bound the transient-error retry loop.  ``clock``/``sleep`` are
    injectable for deterministic tests (fake clock).  ``client``: a
    :class:`StoreKV` or anything with its methods (default: the default
    process group's store); ``process_id``/``num_processes`` default to
    this process's rank and the default group's size (a rank of the port
    is a process).
    """

    def __init__(self, namespace="cmn", client=None,
                 chunk_bytes=_DEFAULT_CHUNK,
                 timeout_ms=_DEFAULT_TIMEOUT_MS,
                 op_timeouts=None, max_retries=3,
                 backoff_base_s=0.05, backoff_max_s=2.0,
                 clock=time.monotonic, sleep=time.sleep,
                 process_id=None, num_processes=None):
        self._client = client if client is not None else _kv_client()
        self._ns = namespace
        self._chunk = int(chunk_bytes)
        self._timeout_ms = int(timeout_ms)
        self._op_timeouts = dict(op_timeouts or {})
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self._clock = clock
        self._sleep = sleep
        self._send_seq = {}
        self._recv_seq = {}
        self._epoch = 0
        self._generation = 0
        self._lock = threading.Lock()
        self._fault_hook = None
        self.monitor = None
        self.stats = {"retries": 0, "timeouts": 0, "cleaned_keys": 0}
        if process_id is not None and num_processes is not None:
            self.process_id = int(process_id)
            self.num_processes = int(num_processes)
        else:
            self.process_id, self.num_processes = _process_index()

    @property
    def available(self):
        return self._client is not None and self.num_processes > 1

    # -- resilience plumbing -------------------------------------------------
    def _prefix(self):
        return f"{self._ns}/g{self._generation}"

    @property
    def generation(self):
        return self._generation

    def bump_generation(self):
        """Rotate the key namespace after a failure: sequence and epoch
        counters re-arm and stranded keys from the failed incarnation can
        never match ops issued by the recovered one.  Lock-step: every
        surviving process must bump together (the recovery supervisor
        does this before its consensus resume)."""
        with self._lock:
            self._generation += 1
            self._send_seq = {}
            self._recv_seq = {}
            self._epoch = 0
        return self._generation

    def set_fault_hook(self, hook):
        """Install ``hook(event, ctx)`` called at transport hook points
        (``hc.put``, ``hc.chunk``, ``hc.get``, ``hc.barrier``).  The hook
        may raise (transient transport error — exercised against the
        retry loop) or mutate the store through ``ctx['client']``
        (lost-chunk / stale-key faults).  ``None`` uninstalls."""
        self._fault_hook = hook

    def _fault(self, event, **ctx):
        if self._fault_hook is not None:
            ctx.setdefault("client", self._client)
            self._fault_hook(event, ctx)

    def enable_heartbeat(self, interval_s=2.0, stall_s=None, wall=time.time,
                         thread=True):
        """Attach a :class:`HeartbeatMonitor`; blocked gets then audit
        peers' liveness, raising :class:`PeerLostError` on a stalled peer
        instead of hanging to the full deadline.  ``thread=True``
        (default) starts the daemon beater so our own liveness survives
        long compute/compile stretches; pass ``thread=False`` only in
        deterministic fake-clock tests."""
        if self.monitor is not None:  # re-arm: never leak the old beater
            self.monitor.stop_thread()
        self.monitor = HeartbeatMonitor(self, interval_s=interval_s,
                                        stall_s=stall_s, wall=wall)
        self.monitor.beat(force=True)
        if thread:
            self.monitor.start_thread()
        return self.monitor

    def _op_timeout_ms(self, op):
        return int(self._op_timeouts.get(op, self._timeout_ms))

    def _n_chunks(self, payload):
        """Chunk count _put will write for this payload — cleanup paths
        compute it from the bytes in hand (never probed from the meta
        key, which a pre-publish failure never wrote)."""
        return max(1, (len(payload) + self._chunk - 1) // self._chunk)

    def _retrying(self, op, key, fn):
        """Run one transport attempt under the op deadline, absorbing
        transient errors with exponential backoff up to ``max_retries``.

        Non-retriable: :class:`PeerLostError` (the peer is gone — more
        attempts cannot help), the posted-abort RuntimeError (fail-stop
        must win), and the injected
        :class:`~.fault_schedule.RankPreempted` (a reclaimed host does
        not come back within a backoff — the elastic supervisor must
        see it immediately).  Everything else is treated as transient
        until the retry/deadline budget runs out, then surfaces as
        :class:`ChannelTimeoutError` chained to the last failure.
        """
        from .fault_schedule import RankPreempted
        timeout_ms = self._op_timeout_ms(op)
        deadline = self._clock() + timeout_ms / 1000.0
        attempts = 0
        last_exc = None
        while True:
            remaining_ms = int((deadline - self._clock()) * 1000)
            if remaining_ms <= 0 or attempts > self.max_retries:
                self.stats["timeouts"] += 1
                raise ChannelTimeoutError(op, key, timeout_ms,
                                          attempts) from last_exc
            attempts += 1
            try:
                return fn(remaining_ms)
            except (PeerLostError, _AbortedError, RankPreempted):
                raise
            except Exception as e:
                last_exc = e
                if attempts > self.max_retries \
                        or self._clock() >= deadline:
                    continue  # decided: raise above without a dead pause
                self.stats["retries"] += 1
                pause = min(self.backoff_base_s * (2 ** (attempts - 1)),
                            self.backoff_max_s)
                self._sleep(pause)

    # -- low-level chunked put/get ------------------------------------------
    def _put(self, key, payload: bytes, published=None):
        """Chunked write; ``published`` (a mutable list, optional) gains
        an entry the moment the meta key — the publish point — lands, so
        callers can tell a pre-publish failure (rollback safe) from a
        post-publish one (message live; a consumer may already have it)
        WITHOUT probing the store, where a fast reader's key deletion
        would masquerade as never-published."""
        c = self._client
        n_chunks = self._n_chunks(payload)
        for i in range(n_chunks):
            self._fault("hc.chunk", key=key, chunk=i)
            c.key_value_set_bytes(
                f"{key}/c{i}", payload[i * self._chunk:(i + 1) * self._chunk])
        # meta last: its presence means every chunk is readable
        c.key_value_set(f"{key}/meta", f"{n_chunks}:{len(payload)}")
        if published is not None:
            published.append(True)
        self._fault("hc.put", key=key)

    def _blocking_get_or_abort(self, key, timeout_ms):
        """Blocking get that polls the job-abort flag and the heartbeat
        monitor: when a peer's except hook posts an abort (fail-stop)
        waiting ranks raise instead of hanging until the full
        timeout — the KV analog of MPI_Abort killing ranks blocked in a
        recv — and a peer whose heartbeat stalls raises
        :class:`PeerLostError` with the suspected rank."""
        c = self._client
        deadline = self._clock() + timeout_ms / 1000.0
        while True:
            reason = None
            try:
                reason = c.key_value_try_get(f"{self._ns}/abort")
            except Exception:
                pass  # no abort posted
            if reason is not None:
                raise _AbortedError(
                    f"distributed job aborted by a peer: {reason}")
            if self.monitor is not None:
                self.monitor.beat()
                self.monitor.check()
            slice_ms = int(min(2000, max(1, (deadline - self._clock())
                                         * 1000)))
            try:
                return c.blocking_key_value_get(key, slice_ms)
            except Exception:
                if self._clock() >= deadline:
                    raise

    def post_abort(self, reason="unknown"):
        """Fail-stop broadcast: unblocks every peer waiting in a channel
        get (they raise) — called by the global except hook.  Posted at
        the namespace root (generation-independent) so it reaches peers
        regardless of which incarnation they are blocked in."""
        try:
            self._client.key_value_set(f"{self._ns}/abort", str(reason))
        except Exception:
            pass

    def clear_abort(self):
        """Recovery-side reset of a posted abort flag (lock-step with
        ``bump_generation`` in the supervisor)."""
        try:
            self._client.key_value_delete(f"{self._ns}/abort")
        except Exception:
            pass

    def _get_once(self, key, timeout_ms):
        c = self._client
        self._fault("hc.get", key=key)
        meta = self._blocking_get_or_abort(f"{key}/meta", timeout_ms)
        n_chunks, total = (int(v) for v in meta.split(":"))
        parts = [c.blocking_key_value_get_bytes(f"{key}/c{i}", timeout_ms)
                 for i in range(n_chunks)]
        return b"".join(parts)[:total], n_chunks

    def _get(self, key, delete=True, op="p2p"):
        payload, n_chunks = self._retrying(op, key, lambda rem:
                                           self._get_once(key, rem))
        if delete:
            self.delete(key, n_chunks)
        return payload

    def delete(self, key, n_chunks=None):
        c = self._client
        try:
            if n_chunks is None:
                meta = c.key_value_try_get(f"{key}/meta")
                n_chunks, _ = (int(v) for v in meta.split(":"))
            for i in range(n_chunks):
                c.key_value_delete(f"{key}/c{i}")
            c.key_value_delete(f"{key}/meta")
            self.stats["cleaned_keys"] += 1
        except Exception:
            pass  # best-effort GC; unread keys die with the coordinator

    # -- point-to-point ------------------------------------------------------
    def send_obj(self, obj, dest_process, tag=0):
        """Chunked pickled send to another controller process (reference:
        ``MpiCommunicatorBase.send_obj``).  Non-blocking wrt the receiver
        (the store buffers), like MPI's eager protocol for small messages."""
        if not 0 <= dest_process < self.num_processes:
            raise ValueError(
                f"dest={dest_process} is not a controller-process rank "
                f"(num_processes={self.num_processes}); host-mode object "
                f"p2p addresses controller processes")
        with self._lock:
            seq = self._send_seq.get((dest_process, tag), 0)
            self._send_seq[(dest_process, tag)] = seq + 1
        key = (f"{self._prefix()}/p2p/{self.process_id}-{dest_process}"
               f"/t{tag}/s{seq}")
        payload = pickle.dumps(obj)
        n_chunks = self._n_chunks(payload)
        published = []
        try:
            self._put(key, payload, published=published)
        except Exception:
            # Rollback ONLY if the message never became visible.  A
            # fault after publish (e.g. an injected hc.put raise) must
            # leave the message alone — the receiver may already have
            # consumed it (deleting the keys, so probing the store here
            # would lie) and advanced its sequence; deleting and
            # re-sequencing would desync the matched stream.
            # Unpublished: scrub the chunks and roll the send sequence
            # back so a retried send re-matches.
            if not published:
                self.delete(key, n_chunks)
                with self._lock:
                    if self._send_seq.get((dest_process, tag)) == seq + 1:
                        self._send_seq[(dest_process, tag)] = seq
            raise

    def recv_obj(self, source_process, tag=0):
        """Blocking matched receive (reference: ``recv_obj``): order per
        (source, tag) is preserved by sequence numbers.  The sequence slot
        is consumed only on success, so a timed-out/aborted receive can be
        retried without desynchronizing the stream."""
        if not 0 <= source_process < self.num_processes:
            raise ValueError(
                f"source={source_process} is not a controller-process rank "
                f"(num_processes={self.num_processes}); host-mode object "
                f"p2p addresses controller processes")
        with self._lock:
            seq = self._recv_seq.get((source_process, tag), 0)
        key = (f"{self._prefix()}/p2p/{source_process}-{self.process_id}"
               f"/t{tag}/s{seq}")
        obj = pickle.loads(self._get(key, op="p2p"))
        with self._lock:
            self._recv_seq[(source_process, tag)] = seq + 1
        return obj

    # -- collectives (SPMD lock-step) ---------------------------------------
    def _next_epoch(self):
        with self._lock:
            self._epoch += 1
            return self._epoch

    def allgather(self, obj):
        """All processes contribute one object; everyone gets the list in
        process order.  Must be entered by every process (lock-step).

        Cleanup contract: this process's contribution is deleted in a
        ``finally`` — on the success path only after the all-read
        barrier, on the failure path immediately, so an exception cannot
        strand keys that would poison the next epoch (or the next
        generation after recovery).  The barrier's own keys are the
        client's to remove (the store adapter's last party out does)."""
        e = self._next_epoch()
        me = self.process_id
        n = self.num_processes
        prefix = f"{self._prefix()}/ag/{e}"
        payload = pickle.dumps(obj)
        # chunk count computed from the payload, NOT probed from the
        # meta key: a pre-publish put failure never wrote meta, and the
        # cleanup below must still reach the chunks already written
        my_chunks = self._n_chunks(payload)
        try:
            self._put(f"{prefix}/{me}", payload)
            out = [pickle.loads(self._get(f"{prefix}/{i}", delete=False,
                                          op="allgather"))
                   for i in range(n)]
            # all processes must finish reading before anyone deletes
            self._barrier_wait(f"{prefix}/done", op="allgather")
            return out
        finally:
            self.delete(f"{prefix}/{me}", my_chunks)

    def bcast(self, obj, root=0):
        """Root's object on every process (lock-step entry).  Root-side
        cleanup of the value key runs in a ``finally`` (see
        :meth:`allgather` for the contract)."""
        e = self._next_epoch()
        prefix = f"{self._prefix()}/bc/{e}"
        if self.process_id == root:
            payload = pickle.dumps(obj)
            my_chunks = self._n_chunks(payload)
            try:
                self._put(f"{prefix}/v", payload)
                out = obj
                self._barrier_wait(f"{prefix}/done", op="bcast")
            finally:
                # chunk count from the payload: cleanup must work even
                # when the put failed before publishing meta
                self.delete(f"{prefix}/v", my_chunks)
            return out
        out = pickle.loads(self._get(f"{prefix}/v", delete=False,
                                     op="bcast"))
        self._barrier_wait(f"{prefix}/done", op="bcast")
        return out

    def _barrier_wait(self, barrier_id, op="barrier"):
        self._fault("hc.barrier", key=barrier_id)
        try:
            self._client.wait_at_barrier(barrier_id,
                                         self._op_timeout_ms(op))
        except (_AbortedError, PeerLostError):
            raise
        except Exception as e:
            self.stats["timeouts"] += 1
            raise ChannelTimeoutError(op, barrier_id,
                                      self._op_timeout_ms(op), 1) from e

    def barrier(self, name=None):
        e = self._next_epoch()
        self._barrier_wait(name or f"{self._prefix()}/bar/{e}",
                           op="barrier")


class _AbortedError(RuntimeError):
    """A peer posted the fail-stop abort flag (not retriable)."""


_channel = None
_channel_lock = threading.Lock()


def get_host_channel():
    """Process-global channel (lazy; None when single-process or no
    coordination service)."""
    global _channel
    with _channel_lock:
        if _channel is None:
            ch = HostChannel()
            if not ch.available:
                return None
            _channel = ch
        return _channel


def reset_host_channel():
    """Drop the process-global channel (tests / full teardown), stopping
    its heartbeat beater so the dead incarnation stops posting liveness."""
    global _channel
    with _channel_lock:
        if _channel is not None and _channel.monitor is not None:
            _channel.monitor.stop_thread()
        _channel = None
