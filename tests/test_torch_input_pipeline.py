"""The port's input pipeline against the JAX package's, on the CPU.

Twins of ``tests/dataset_tests/test_iterator_contract.py`` (one consumer
contract over the serial, thread, process and native iterators),
``test_device_prefetch.py`` (on ``device="cpu"``: the same stream and
bookkeeping as the base iterator, tensors on the device, bit-exact
resume whatever the prefetch depth) and ``test_native_iterator.py``
(the C++ gather engine, built with ``g++`` from the port's own copy of
the source), and the shuffled order of every port iterator against the
JAX ``SerialIterator``'s for the same seed.  Everything here is integer
bookkeeping and copies: exact comparisons throughout.
"""

import os

import numpy as np
import pytest
import torch

from chainermn_tpu.dataset import SerialIterator as JSerialIterator
from chainermn_tpu_torch.dataset import (ConcatenatedDataset,
                                         DevicePrefetchIterator, DictDataset,
                                         IteratorWorkerCrashed,
                                         IteratorWorkerError,
                                         MultiprocessIterator,
                                         MultithreadIterator,
                                         NativeBatchIterator, SerialIterator,
                                         TransformDataset, TupleDataset,
                                         concat_examples, get_cifar10,
                                         identity_converter, split_dataset,
                                         split_dataset_random, to_device)
from chainermn_tpu_torch.serializers.npz import (DictionarySerializer,
                                                 NpzDeserializer)
from chainermn_tpu_torch.utils import native

KINDS = ["serial", "thread", "process", "native"]
N, BS = 24, 4


def _data(n=N):
    rng = np.random.RandomState(0)
    return [(rng.normal(0, 1, (4,)).astype(np.float32), np.int64(i))
            for i in range(n)]


def _make(kind, n=N, batch_size=BS, **kw):
    data = _data(n)
    if kind == "serial":
        return SerialIterator(data, batch_size, **kw)
    if kind == "thread":
        return MultithreadIterator(data, batch_size, **kw)
    if kind == "process":
        return MultiprocessIterator(data, batch_size, n_processes=2, **kw)
    if kind == "native":
        xs = np.stack([x for x, _ in data])
        ys = np.asarray([int(y) for _, y in data], np.int64)
        return NativeBatchIterator(TupleDataset(xs, ys), batch_size, **kw)
    raise AssertionError(kind)


def _labels(batch):
    """Labels of a list of examples or of a stacked (x, t) batch."""
    if isinstance(batch, tuple):
        return [int(v) for v in batch[1]]
    return [int(lbl) for _, lbl in batch]


@pytest.fixture(params=KINDS)
def kind(request):
    return request.param


# -- the contract, each kind -------------------------------------------------

def test_stream_and_epochs_match_the_jax_serial_iterator(kind):
    """The same (shuffle, seed) gives the JAX SerialIterator's batch
    stream, and the epoch bookkeeping moves in lock-step with it."""
    ref = JSerialIterator(_data(), BS, shuffle=True, seed=5)
    it = _make(kind, shuffle=True, seed=5)
    try:
        for _ in range(2 * (N // BS) + 3):   # crosses two epoch bounds
            assert _labels(it.next()) == _labels(ref.next())
            assert it.epoch == ref.epoch
            assert it.is_new_epoch == ref.is_new_epoch
            assert it.epoch_detail == pytest.approx(ref.epoch_detail)
            assert it.previous_epoch_detail == pytest.approx(
                ref.previous_epoch_detail)
    finally:
        it.finalize()


def test_resume_mid_epoch(kind):
    it = _make(kind, shuffle=True, seed=3)
    for _ in range(3):
        it.next()
    s = DictionarySerializer()
    it.serialize(s)
    cont = [_labels(it.next()) for _ in range(8)]   # crosses the bound
    it.finalize()
    it2 = _make(kind, shuffle=True, seed=3)
    it2.serialize(NpzDeserializer(s.target))
    resumed = [_labels(it2.next()) for _ in range(8)]
    it2.finalize()
    assert cont == resumed


def test_snapshot_keys_interchangeable_with_serial(kind):
    it = _make(kind, shuffle=True, seed=9)
    for _ in range(4):
        it.next()
    s = DictionarySerializer()
    it.serialize(s)
    cont = _labels(it.next())
    it.finalize()
    ref = SerialIterator(_data(), BS, shuffle=True, seed=9)
    ref.serialize(NpzDeserializer(s.target))
    assert _labels(ref.next()) == cont


def test_non_repeat_drains_exactly(kind):
    it = _make(kind, repeat=False, shuffle=False)
    seen = []
    try:
        while True:
            seen.extend(_labels(it.next()))
    except StopIteration:
        pass
    try:
        assert sorted(seen) == list(range(N))
        with pytest.raises(StopIteration):
            it.next()
    finally:
        it.finalize()


@pytest.mark.parametrize("consume", [0, 1])
def test_finalize_is_idempotent(kind, consume):
    it = _make(kind)
    for _ in range(consume):
        it.next()
    it.finalize()
    it.finalize()


# -- the process pool and the thread ------------------------------------------

class _Boom:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        if i == 9:
            raise ValueError("bad example 9")
        return (np.zeros(3, np.float32), np.int64(i))


class _Crash:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        if i == 9:
            os._exit(7)   # a worker dying without a traceback
        return (np.zeros(3, np.float32), np.int64(i))


def test_process_transform_error_is_typed_and_sticky():
    it = MultiprocessIterator(_Boom(), 4, shuffle=False, n_processes=2)
    try:
        with pytest.raises(IteratorWorkerError) as ei:
            for _ in range(3):
                it.next()
        assert "bad example 9" in str(ei.value)
        assert "ValueError" in str(ei.value)
        with pytest.raises(IteratorWorkerError):
            it.next()
    finally:
        it.finalize()


def test_process_worker_crash_is_typed():
    it = MultiprocessIterator(_Crash(), 4, shuffle=False, n_processes=2)
    try:
        with pytest.raises(IteratorWorkerCrashed) as ei:
            for _ in range(3):
                it.next()
        assert ei.value.exitcode == 7
    finally:
        it.finalize()


def test_thread_transform_error_is_sticky():
    it = MultithreadIterator(_Boom(), 4, shuffle=False)
    try:
        for _ in range(2):
            with pytest.raises(ValueError, match="bad example 9"):
                for _ in range(3):
                    it.next()
    finally:
        it.finalize()


def test_process_unordered_keeps_epochs_and_refuses_a_snapshot():
    it = MultiprocessIterator(_data(), BS, shuffle=True, seed=1,
                              n_processes=2, ordered=False)
    try:
        it.serialize(DictionarySerializer())   # nothing consumed: fine
        for _ in range(2):
            got = sorted(lbl for _ in range(N // BS)
                         for lbl in _labels(it.next()))
            assert got == list(range(N))
        with pytest.raises(RuntimeError, match="ordered=True"):
            it.serialize(DictionarySerializer())
    finally:
        it.finalize()


def test_process_as_arrays_and_pickle_fallback():
    it = MultiprocessIterator(_data(), BS, shuffle=False, n_processes=2,
                              as_arrays=True)
    try:
        x, y = it.next()
        assert x.shape == (BS, 4) and y.shape == (BS,)
        np.testing.assert_array_equal(y, np.arange(BS))
    finally:
        it.finalize()

    class Ragged:
        def __len__(self):
            return 12

        def __getitem__(self, i):
            return (np.full(2 + (i % 3), i, np.float32), np.int64(i))

    it = MultiprocessIterator(Ragged(), 4, shuffle=False, n_processes=2)
    try:
        batch = it.next()
        assert [int(lbl) for _, lbl in batch] == [0, 1, 2, 3]
        assert batch[2][0].shape == (4,)
    finally:
        it.finalize()


def test_process_workers_are_forked_without_cuda():
    """No card here, so CUDA is never initialized: the pool forks."""
    it = MultiprocessIterator(_data(), BS, n_processes=1)
    try:
        assert not torch.cuda.is_initialized()
        assert it._res.procs[0]._popen.method == "fork"
    finally:
        it.finalize()


# -- the device-feed stage on the CPU ------------------------------------------

def _prefetch(base, **kw):
    return DevicePrefetchIterator(base, device="cpu",
                                  converter=concat_examples, **kw)


@pytest.mark.parametrize("overlap", [True, False])
def test_prefetch_stream_matches_the_base(overlap):
    data = _data(20)
    ref = SerialIterator(data, 4, shuffle=True, seed=7)
    pref = _prefetch(SerialIterator(data, 4, shuffle=True, seed=7), size=3,
                     overlap=overlap)
    try:
        for _ in range(12):
            rb = concat_examples(ref.next())
            x, t = pref.next()
            assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
            np.testing.assert_array_equal(x.numpy(), rb[0])
            np.testing.assert_array_equal(t.numpy(), rb[1])
            assert pref.epoch == ref.epoch
            assert pref.is_new_epoch == ref.is_new_epoch
            assert pref.epoch_detail == pytest.approx(ref.epoch_detail)
        assert pref.h2d_bytes == pref.h2d_batches * (4 * 4 * 4 + 4 * 8)
    finally:
        pref.finalize()


@pytest.mark.parametrize("base", ["serial", "thread", "process", "native"])
@pytest.mark.parametrize("size", [1, 3])
def test_prefetch_resume_is_bit_exact_whatever_the_depth(base, size):
    def build():
        it = _make(base, shuffle=True, seed=3)
        if base == "native":
            return DevicePrefetchIterator(it, size=size, device="cpu")
        return _prefetch(it, size=size)

    it = build()
    for _ in range(5):
        it.next()
    s = DictionarySerializer()
    it.serialize(s)
    cont = [it.next()[1].numpy() for _ in range(6)]
    it.finalize()
    it2 = build()
    it2.serialize(NpzDeserializer(s.target))
    resumed = [it2.next()[1].numpy() for _ in range(6)]
    it2.finalize()
    for a, b in zip(cont, resumed):
        np.testing.assert_array_equal(a, b)


def test_prefetch_errors_are_sticky_and_drains_stop():
    calls = [0]

    def bad(batch):
        calls[0] += 1
        if calls[0] == 2:
            raise ValueError("converter blew up")
        return concat_examples(batch)

    it = DevicePrefetchIterator(SerialIterator(_data(16), 4, shuffle=False),
                                size=2, device="cpu", converter=bad)
    for _ in range(2):
        with pytest.raises(ValueError, match="converter blew up"):
            for _ in range(4):
                it.next()
    it.finalize()
    it.finalize()
    assert not it._thread.is_alive()

    pref = _prefetch(SerialIterator(_data(8), 4, repeat=False,
                                    shuffle=False), size=4)
    got = []
    with pytest.raises(StopIteration):
        while True:
            got.append(pref.next()[1].numpy())
    np.testing.assert_array_equal(np.sort(np.concatenate(got)), np.arange(8))


def test_prefetch_input_stall_accounting():
    import time
    it = _prefetch(SerialIterator(_data(16), 4, shuffle=False), size=2)
    it.next()
    first = it.input_stall_ms
    for _ in range(4):
        time.sleep(0.02)   # the feeder refills while the "step" runs
        it.next()
    assert it.input_stall_ms >= first
    it.finalize()


def test_prefetch_without_a_card_raises_on_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePrefetchIterator(SerialIterator(_data(), 4))


def test_converters():
    batch = concat_examples(_data(4))
    assert identity_converter(batch) is batch
    x, t = identity_converter(batch, "cpu")
    assert isinstance(x, torch.Tensor)
    np.testing.assert_array_equal(x.numpy(), batch[0])
    src = np.arange(6, dtype=np.uint8).reshape(2, 3)
    out = to_device({"a": src}, "cpu")["a"]
    src[0, 0] = 99   # a copy: the caller may reuse its array
    assert out.dtype == torch.uint8 and int(out[0, 0]) == 0


# -- the native engine ------------------------------------------------------------

def test_native_loader_gathers_and_rejects_bad_indices():
    data = np.arange(100 * 16, dtype=np.float32).reshape(100, 16)
    loader = native.NativeLoader(data, max_batch=8, n_buffers=2)
    rng = np.random.RandomState(1)
    for _ in range(20):
        idx = rng.randint(0, 100, 8).astype(np.int64)
        loader.submit(idx)
        np.testing.assert_array_equal(loader.next(), data[idx])
    with pytest.raises(ValueError):
        loader.submit(np.asarray([0, 99, 100], dtype=np.int64))
    loader.close()


def test_native_library_is_built_from_the_ports_source():
    path = native.library_path()
    native.load_library()
    assert path.exists() and path.parent.name == "chainermn_tpu_torch"
    assert path.parent.parent.name == "build"
    assert native.SOURCE.parent.name == "native"
    # the same engine as the JAX package's, below the header comment
    here = native.SOURCE.read_text()
    ref = open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chainermn_tpu", "utils", "native",
        "dataloader.cpp")).read()
    assert here[here.index("#include"):] == ref[ref.index("#include"):]


def test_native_raises_where_jax_falls_back(tmp_path, monkeypatch):
    """A broken source raises NativeBuildFailed (the JAX loader returns
    None), and the iterator does not run another loader instead."""
    bad = tmp_path / "dataloader.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(native.NativeBuildFailed, match="g\\+\\+ refused"):
        native.load_library(bad)
    assert not native.library_path(bad).exists()

    def broken():
        raise native.NativeBuildFailed("no toolchain")

    monkeypatch.setattr(native, "load_library", broken)
    with pytest.raises(native.NativeBuildFailed):
        NativeBatchIterator(np.zeros((8, 2), np.float32), 4)


def test_native_iterator_resume_and_serial_snapshot():
    x = np.arange(40, dtype=np.float32).reshape(40, 1)
    y = np.arange(40, dtype=np.int32)

    def fresh():
        return NativeBatchIterator(TupleDataset(x, y), 8, shuffle=True,
                                   seed=7, n_prefetch=3)

    for k in (2, 4, 7):
        it = fresh()
        for _ in range(k):
            it.next()
        s = DictionarySerializer()
        it.serialize(s)
        golden = [(it.next()[1].tolist(), it.epoch, it.is_new_epoch,
                   it.epoch_detail) for _ in range(6)]
        it.finalize()
        it2 = fresh()
        it2.serialize(NpzDeserializer(s.target))
        assert golden == [(it2.next()[1].tolist(), it2.epoch,
                           it2.is_new_epoch, it2.epoch_detail)
                          for _ in range(6)], k
        it2.finalize()
    serial = SerialIterator(TupleDataset(x, y), 8, shuffle=True, seed=3)
    serial.next()
    s = DictionarySerializer()
    serial.serialize(s)
    expect = [sorted(t for _, t in serial.next()) for _ in range(3)]
    it = NativeBatchIterator(TupleDataset(x, y), 8, shuffle=True, seed=99)
    it.serialize(NpzDeserializer(s.target))
    assert [sorted(it.next()[1].tolist()) for _ in range(3)] == expect
    it.reset()   # drains what is in flight
    it.finalize()


def test_native_zero_copy_hands_out_ring_views():
    x = np.arange(48, dtype=np.float32).reshape(24, 2)
    it = NativeBatchIterator(x, 4, shuffle=False, zero_copy=True)
    first = it.next()
    assert not first.flags.owndata   # a view of the engine's ring slot
    np.testing.assert_array_equal(first, x[:4])
    np.testing.assert_array_equal(it.next(), x[4:8])
    it.finalize()


# -- datasets ---------------------------------------------------------------------

def test_datasets_match_the_jax_package():
    from chainermn_tpu.dataset import datasets as JD
    for (a, b) in zip(get_cifar10(n_train=20, n_test=10),
                      JD.get_cifar10(n_train=20, n_test=10)):
        for i in (0, 7, 19 if len(a) == 20 else 9):
            np.testing.assert_array_equal(a[i][0], b[i][0])
            assert a[i][1] == b[i][1]
    xs = np.arange(10)
    for port, jax_ in ((split_dataset_random(xs, 4, seed=2),
                        JD.split_dataset_random(xs, 4, seed=2)),
                       (split_dataset(xs, 3), JD.split_dataset(xs, 3))):
        for p, j in zip(port, jax_):
            assert [int(v) for v in p[:]] == [int(v) for v in j[:]]
    cat = ConcatenatedDataset(xs[:3], xs[3:])
    assert [int(cat[i]) for i in range(len(cat))] == list(range(10))
    d = DictDataset(a=xs, b=xs * 2)
    assert d[3] == {"a": 3, "b": 6} and len(d[1:3]) == 2
    tr = TransformDataset(xs, lambda v: v + 1)
    assert tr[2] == 3 and tr[[1, 2]] == [2, 3]
