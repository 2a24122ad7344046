"""The quantized gradient wires (int8, fp8 e4m3 and e5m2) with error
feedback, against the JAX package.

The twins of ``tests/communicator_tests/test_quantization.py`` (the
quantize/dequantize pair, the residual, the scale's contracts, the byte
accounting) run the port's functions and the JAX package's on the same
numpy inputs and compare them bitwise; so do the two-level schedule and
split helpers.  The twins of ``tests/core_tests/test_quantized_parity.py
:91`` and ``:119`` run in one spawned 4-rank gloo world with a forced 2 x
2 split: a tiny ``TransformerLM`` (vocab 64, d 32, 2 heads, 2 layers, T
16, batch 8, Adam 3e-3, 40 steps) through the lossless two-level exchange
and through each quantized one, with error feedback on and off.

Tolerances: the functions bitwise (both sides are one IEEE operation per
element in the same order: the divide by the scale, the clip, the
round-half-to-even or the fp8 cast, one multiply to decode, the per-rank
rows added in rank order); the quantized runs, the JAX test's bands
(``LOSS_BAND``: the final loss within 5 % of the lossless run's;
``ABLATION_MARGIN``: error feedback off lands at least 1.1 times farther
from the lossless parameters than on); the hand-computed mean of the
4-rank int8 exchange, 1e-6 (the JAX test's); ``CHAINERMN_TPU_COMPRESS=off``
against lossless, bitwise (the same code path).
"""

import os
import warnings

import numpy as np
import pytest
import torch

from chainermn_tpu_torch.communicators import _communication_utility as cu
from chainermn_tpu_torch.communicators import _memory_utility as mu
from tests.test_torch_communicator import spawn_ranks

WIRES = ("int8", "float8_e4m3", "float8_e5m2")
#: the JAX test's per-wire relative round-trip bound
REL_BOUND = {"int8": 0.5 / 127.0, "float8_e4m3": 2.0 ** -3,
             "float8_e5m2": 2.0 ** -2}
WORLD = 4
V, B, T = 64, 8, 16
STEPS = 40
ALPHA = 3e-3
LOSS_BAND = 0.05
ABLATION_MARGIN = 1.1
GRID_WIRES = ("int8", "float8_e4m3")
GRID_EXCHANGES = ("allreduce", "reduce_scatter")


def _vec(seed=0, n=257, scale=3.0):
    rng = np.random.RandomState(seed)
    return rng.normal(0, scale, n).astype(np.float32)


def _special():
    return np.asarray([1.0, -2.0, np.inf, -np.inf, np.nan, 0.5], np.float32)


def _jmu():
    from chainermn_tpu.communicators import _memory_utility as jmu
    return jmu


def _same(port, jax_array):
    """Bitwise: the port's tensor and the JAX array hold the same values
    (fp8 compared through fp32, which holds every fp8 value exactly)."""
    a = port.float().numpy() if port.is_floating_point() else port.numpy()
    b = np.asarray(jax_array).astype(a.dtype)
    np.testing.assert_array_equal(a, b)
    assert np.array_equal(np.signbit(a), np.signbit(b))


def _quantize_both(v, wire):
    import jax.numpy as jnp
    q, s = mu.quantize_symmetric(torch.from_numpy(v), wire)
    jq, js = _jmu().quantize_symmetric(jnp.asarray(v), wire)
    return (q, s), (jq, js)


# -- the quantization functions (test_quantization.py's twins) ---------------

@pytest.mark.parametrize("wire", WIRES)
def test_round_trip_error_bound(wire):
    v = _vec()
    (q, s), (jq, js) = _quantize_both(v, wire)
    _same(q, jq)
    _same(s, js)
    err = (mu.dequantize_symmetric(q, s) - torch.from_numpy(v)).abs()
    assert err.max().item() <= np.abs(v).max() * REL_BOUND[wire] * (1 + 1e-6)
    _same(mu.dequantize_symmetric(q, s), _jmu().dequantize_symmetric(jq, js))


@pytest.mark.parametrize("wire", WIRES)
def test_wire_dtype_and_itemsize(wire):
    q, _ = mu.quantize_symmetric(torch.from_numpy(_vec()), wire)
    assert q.dtype is mu.resolve_grad_dtype(wire)
    assert q.element_size() == 1
    assert mu.is_quantized_dtype(wire)
    assert mu.is_quantized_dtype(str(mu.resolve_grad_dtype(wire)))
    assert mu.is_quantized_dtype(mu.resolve_grad_dtype(wire))


def test_fp8_alias_resolution():
    assert mu.resolve_grad_dtype("float8_e4m3") is torch.float8_e4m3fn
    assert mu.resolve_grad_dtype("float8_e4m3fn") is torch.float8_e4m3fn
    assert mu.resolve_grad_dtype("float8_e5m2") is torch.float8_e5m2
    assert mu.resolve_grad_dtype("int8") is torch.int8
    assert not mu.is_quantized_dtype("bfloat16")
    assert not mu.is_quantized_dtype(torch.bfloat16)
    assert not mu.is_quantized_dtype(None)
    assert mu.resolve_grad_dtype(None) is None
    assert mu.QUANTIZED_DTYPES == _jmu().QUANTIZED_DTYPES


@pytest.mark.parametrize("wire", WIRES)
def test_scale_deterministic_across_ranks(wire):
    v = _vec(seed=3)
    q1, s1 = mu.quantize_symmetric(torch.from_numpy(v), wire)
    q2, s2 = mu.quantize_symmetric(torch.from_numpy(v.copy()), wire)
    assert torch.equal(s1, s2) and torch.equal(q1.float(), q2.float())
    (_, _), (jq, js) = _quantize_both(v, wire)
    _same(q1, jq)
    _same(s1, js)


@pytest.mark.parametrize("wire", WIRES)
def test_zero_and_empty_buffers(wire):
    q, s = mu.quantize_symmetric(torch.zeros(64), wire)
    assert s.item() == 1.0
    assert torch.equal(mu.dequantize_symmetric(q, s), torch.zeros(64))
    assert torch.equal(mu.quantization_residual(torch.zeros(64), q, s),
                       torch.zeros(64))
    q, s = mu.quantize_symmetric(torch.zeros(0), wire)
    assert q.numel() == 0 and s.item() == 1.0


@pytest.mark.parametrize("wire", WIRES)
def test_inf_nan_handling(wire):
    v = _special()
    (q, s), (jq, js) = _quantize_both(v, wire)
    _same(q, jq)
    _same(s, js)
    qmax = mu.QUANTIZED_DTYPES[wire]
    assert s.item() == pytest.approx(2.0 / qmax)
    deq = mu.dequantize_symmetric(q, s).numpy()
    assert np.isfinite(deq).all()
    assert deq[2] == pytest.approx(2.0, rel=0.26)
    assert deq[3] == pytest.approx(-2.0, rel=0.26)
    assert deq[4] == 0.0
    r = mu.quantization_residual(torch.from_numpy(v), q, s)
    _same(r, _jmu().quantization_residual(v, jq, js))
    assert torch.isfinite(r).all() and (r[2:5] == 0).all()


@pytest.mark.parametrize("wire", WIRES)
def test_residual_telescopes_as_the_jax_one(wire):
    """20 steps of error feedback, each step's codewords, scale and
    residual bitwise the JAX function's; the applied sum plus the last
    residual is the true sum."""
    import jax.numpy as jnp
    jmu = _jmu()
    rng = np.random.RandomState(7)
    e, je = torch.zeros(128), jnp.zeros((128,), jnp.float32)
    applied = np.zeros(128, np.float64)
    true_sum = np.zeros(128, np.float64)
    for k in range(20):
        g = rng.normal(0, 1 + k % 3, 128).astype(np.float32)
        true_sum += g
        q, s, e_new = mu.quantize_with_feedback(torch.from_numpy(g), e, wire)
        jq, js, je = jmu.quantize_with_feedback(jnp.asarray(g), je, wire)
        _same(q, jq)
        _same(s, js)
        _same(e_new, je)
        applied += mu.dequantize_symmetric(q, s).double().numpy()
        e = e_new
    gap = np.abs(true_sum - applied - e.double().numpy())
    assert gap.max() <= 1e-3 * max(1.0, s.item() * 127)
    assert e.abs().max().item() <= np.abs(true_sum).max() * 0.5


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("wire", WIRES)
def test_dequantize_sum_matches_jax(wire, size):
    import jax.numpy as jnp
    rows = [mu.quantize_symmetric(torch.from_numpy(_vec(seed=s, n=97)), wire)
            for s in range(size)]
    q = torch.stack([r[0] for r in rows])
    scales = torch.stack([r[1] for r in rows])
    got = mu.dequantize_sum(q, scales)
    want = _jmu().dequantize_sum(
        jnp.asarray(q.float().numpy()).astype(
            _jmu().resolve_grad_dtype(wire)),
        jnp.asarray(scales.numpy()))
    _same(got, want)


def test_quantize_without_feedback_returns_no_residual():
    q, s, r = mu.quantize_with_feedback(torch.from_numpy(_vec()), None,
                                        "int8")
    assert r is None
    q2, s2 = mu.quantize_symmetric(torch.from_numpy(_vec()), "int8")
    assert torch.equal(q, q2) and torch.equal(s, s2)


def test_byte_accounting_matches_jax():
    jmu = _jmu()
    chunk = 1024
    for size in (1, 2, 4, 8):
        for coll in ("psum", "reduce_scatter"):
            for wire in WIRES:
                assert mu.quantized_hop_bytes(chunk, size, coll, wire) \
                    == jmu.quantized_hop_bytes(chunk, size, coll, wire)
        for coll in ("psum", "reduce_scatter", "all_gather", "all_to_all"):
            assert mu.exchanged_bytes(4096, size, coll) \
                == jmu.exchanged_bytes(4096, size, coll)
    assert mu.quantized_hop_bytes(chunk, 2, "psum", "int8") * 4 \
        == mu.exchanged_bytes(chunk * 4, 2, "psum")
    for intra, inter in ((1, 1), (2, 2), (4, 2), (8, 4)):
        for coll in ("psum", "reduce_scatter", "all_gather"):
            for dcn in (None, 1024):
                assert mu.hierarchical_exchanged_bytes(
                    8192, intra, inter, coll, dcn) \
                    == jmu.hierarchical_exchanged_bytes(
                        8192, intra, inter, coll, dcn)
        # the hops sum to the flat ring figure
        h = mu.hierarchical_exchanged_bytes(8192, intra, inter)
        assert abs(h["ici"] + h["dcn"] - mu.exchanged_bytes(
            8192, intra * inter, "psum")) <= 1
    for bad in ((mu.quantized_hop_bytes, (chunk, 2, "all_gather", "int8")),
                (mu.hierarchical_exchanged_bytes, (1023, 2, 2))):
        with pytest.raises(ValueError):
            bad[0](*bad[1])


def test_hop_schedule_and_padding_match_jax():
    import jax.numpy as jnp
    jmu = _jmu()
    for k in range(4):
        assert mu.hop_schedule(k) == jmu.hop_schedule(k)
        assert mu.hop_schedule(k, mode="striped") \
            == jmu.hop_schedule(k, mode="striped")
        assert mu.hop_schedule(k, mode="moe") \
            == jmu.hop_schedule(k, mode="moe")
    with pytest.raises(ValueError):
        mu.hop_schedule(2, mode="spiral")
    for n, m in ((10, 4), (12, 4), (1, 3)):
        v = np.arange(n, dtype=np.float32)
        got, n_true = mu.pad_to_multiple(torch.from_numpy(v), m)
        want, w_true = jmu.pad_to_multiple(jnp.asarray(v), m)
        assert n_true == w_true
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert [mu.chain_chunk_index(i, d, 2) for d in (0, 1)
            for i in (0, 1)] == [0, 2, 1, 3]


def test_resolve_hierarchy_matches_jax():
    from chainermn_tpu.communicators.mesh_communicator import \
        MeshCommunicator as JaxComm
    for world, intra, inter in ((8, None, 2), (8, 4, None), (8, 2, 4),
                                (4, 2, 2), (6, None, 4), (6, 4, None),
                                (8, 3, 3), (8, None, 0)):
        try:
            want = JaxComm._resolve_hierarchy(world, intra, inter)
        except (ValueError, ZeroDivisionError) as e:
            with pytest.raises(type(e)):
                cu.resolve_hierarchy(world, intra, inter)
            continue
        assert cu.resolve_hierarchy(world, intra, inter) == want
    assert cu.resolve_hierarchy(4, hosts=["a"] * 4) == (1, 4)
    assert cu.resolve_hierarchy(4, hosts=["a", "a", "b", "b"]) == (2, 2)
    for ragged in (["a", "a", "a", "b"], ["a", "b", "a", "b"]):
        with pytest.raises(ValueError, match="intra_size=/inter_size="):
            cu.resolve_hierarchy(4, hosts=ragged)


def test_exchange_warns_once_when_error_feedback_is_inert(monkeypatch):
    """``test_quantization.py``'s legacy-call twin: a quantized exchange
    without a residual on a communicator with error feedback on warns
    once per process; ``error_feedback=False`` does not."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.communicators import mesh_communicator as mc
    from chainermn_tpu_torch.nn import links as L
    monkeypatch.setattr(mc, "_warned_inert_ef", False)
    model = L.Linear(5, 3, seed=0, device="cpu")

    def exchange(comm):
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        return comm.multi_node_mean_grad(model)

    comm = create_communicator("jax_ici", device="cpu",
                               allreduce_grad_dtype="int8")
    try:
        assert comm.quantized and comm.error_feedback
        with pytest.warns(UserWarning, match="error feedback is inert"):
            assert exchange(comm) is None
        with warnings.catch_warnings():
            warnings.simplefilter("error", UserWarning)
            exchange(comm)
            monkeypatch.setattr(mc, "_warned_inert_ef", False)
            quiet = create_communicator("jax_ici", device="cpu",
                                        allreduce_grad_dtype="int8",
                                        error_feedback=False, group=comm.group)
            exchange(quiet)
        torch.testing.assert_close(model.W.grad, torch.ones(3, 5),
                                   rtol=0, atol=1e-6)
    finally:
        comm.finalize()
    assert not dist.is_initialized()


# -- the 4-rank runs (test_quantized_parity.py's twins) -----------------------

def _parity_data():
    rng = np.random.RandomState(0)
    x = rng.randint(0, V, (B, T)).astype(np.int64)
    return x, np.roll(x, -1, axis=1)


def _quantized_worker(rank, x, t, per_rank):
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.nn import links as L
    rows = B // WORLD
    xs = torch.from_numpy(x[rank * rows:(rank + 1) * rows])
    ts = torch.from_numpy(t[rank * rows:(rank + 1) * rows])
    split = dict(device="cpu", intra_size=2, inter_size=2)
    out = {}

    # the 4-rank int8 exchange against a hand-computed mean
    flat = create_communicator("jax_ici", device="cpu",
                               allreduce_grad_dtype="int8",
                               error_feedback=False)
    link = L.Linear(per_rank.shape[1], 1, seed=0, device="cpu")
    link.W.grad = torch.from_numpy(per_rank[rank]).reshape(1, -1)
    link.b.grad = torch.zeros(1)
    flat.multi_node_mean_grad(link)
    out["hand_mean"] = (link.W.grad.reshape(-1), dict(flat.calls))

    def run(comm, exchange="allreduce", steps=STEPS):
        model = TransformerLM(V, d_model=32, n_heads=2, n_layers=2,
                              seed=0, device="cpu")
        comm.bcast_data(model)
        opt = create_multi_node_optimizer(
            Adam(alpha=ALPHA), comm, exchange=exchange).setup(model)
        comm.calls.clear()
        losses = [opt.update(model, xs, ts).item() for _ in range(steps)]
        params = torch.cat([p.detach().reshape(-1)
                            for _, p in sorted(model.namedparams())])
        residual = opt._residual
        return {"losses": losses, "params": params,
                "residual_absmax": None if residual is None
                else residual.abs().max().item(),
                "calls": dict(comm.calls)}

    out["lossless"] = run(create_communicator("hierarchical", **split))
    for wire in GRID_WIRES:
        for ef in (True, False):
            comm = create_communicator(
                "hierarchical", allreduce_grad_dtype={"dcn": wire},
                error_feedback=ef, **split)
            for exchange in GRID_EXCHANGES:
                out[(wire, exchange, ef)] = run(comm, exchange)
    flat_q = create_communicator("pure_nccl", device="cpu",
                                 allreduce_grad_dtype="int8")
    for exchange in GRID_EXCHANGES:
        out[("flat_int8", exchange)] = run(flat_q, exchange)

    os.environ["CHAINERMN_TPU_COMPRESS"] = "off"
    try:
        off = create_communicator("hierarchical",
                                  allreduce_grad_dtype={"dcn": "int8"},
                                  **split)
    finally:
        del os.environ["CHAINERMN_TPU_COMPRESS"]
    out["compress_off"] = (off.quantized, run(off, steps=3))
    return out


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    x, t = _parity_data()
    per_rank = np.random.RandomState(11).normal(0, 2, (WORLD, 40)).astype(
        np.float32)
    ranks = spawn_ranks(tmp_path_factory.mktemp("quantized"),
                        _quantized_worker, world=WORLD, x=x, t=t,
                        per_rank=per_rank)
    return ranks, per_rank


def test_quantized_exchange_matches_hand_mean(grid):
    import jax.numpy as jnp
    ranks, per_rank = grid
    expect = np.zeros(40, np.float64)
    for r in range(WORLD):
        q, s = _jmu().quantize_symmetric(jnp.asarray(per_rank[r]), "int8")
        expect += np.asarray(_jmu().dequantize_symmetric(q, s), np.float64)
    expect /= WORLD
    for r in ranks:
        got, calls = r["hand_mean"]
        np.testing.assert_allclose(got.numpy(), expect.astype(np.float32),
                                   rtol=1e-6, atol=1e-6)
        assert calls == {"allgather_q": 1, "allgather_scale": 1}


def test_lossless_run_learns(grid):
    ranks, _ = grid
    losses = ranks[0]["lossless"]["losses"]
    assert losses[-1] < 0.25 < losses[0]


@pytest.mark.parametrize("exchange", GRID_EXCHANGES)
@pytest.mark.parametrize("wire", GRID_WIRES)
def test_quantized_parity_and_ef_ablation(grid, wire, exchange):
    """``test_quantized_parity.py:91``'s twin: error feedback on lands in
    the loss band of the lossless run and carries a live residual; off,
    it carries none and lands demonstrably farther in parameter space."""
    ranks, _ = grid
    # the residual lives on: somewhere (a rank's part can be all zeros,
    # where its chunk holds position embeddings no token reaches)
    assert max(r[(wire, exchange, True)]["residual_absmax"]
               for r in ranks) > 0
    for r in ranks:
        lossless = r["lossless"]
        ef, no = r[(wire, exchange, True)], r[(wire, exchange, False)]
        assert abs(ef["losses"][-1] - lossless["losses"][-1]) \
            <= LOSS_BAND * lossless["losses"][-1], ef["losses"][-1]
        assert np.isfinite(ef["losses"]).all()
        assert ef["residual_absmax"] is not None
        assert no["residual_absmax"] is None
        d_ef = (ef["params"] - lossless["params"]).norm().item()
        d_no = (no["params"] - lossless["params"]).norm().item()
        assert d_no > d_ef * ABLATION_MARGIN, (wire, exchange, d_ef, d_no)
        hop = "dcn_allgather_q" if exchange == "allreduce" \
            else "dcn_alltoall_q"
        assert ef["calls"][hop] == ef["calls"]["dcn_allgather_scale"] \
            == STEPS


@pytest.mark.parametrize("exchange", GRID_EXCHANGES)
def test_flat_int8_wire_within_the_band(grid, exchange):
    ranks, _ = grid
    assert max(r[("flat_int8", exchange)]["residual_absmax"]
               for r in ranks) > 0
    for r in ranks:
        got, lossless = r[("flat_int8", exchange)], r["lossless"]
        assert abs(got["losses"][-1] - lossless["losses"][-1]) \
            <= LOSS_BAND * lossless["losses"][-1]
        hop = "allgather_q" if exchange == "allreduce" else "alltoall_q"
        assert got["calls"][hop] == STEPS


def test_compress_off_escape_hatch_restores_lossless(grid):
    """``:119``'s twin: ``CHAINERMN_TPU_COMPRESS=off`` turns the int8
    wire back into the lossless one; the trajectory is the lossless
    run's, bitwise."""
    ranks, _ = grid
    for r in ranks:
        quantized, run = r["compress_off"]
        assert not quantized and run["residual_absmax"] is None
        assert run["losses"] == r["lossless"]["losses"][:3]
