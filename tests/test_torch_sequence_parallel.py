"""Sequence parallelism of the port against the JAX package's, in one
4-rank gloo world.

The port side: ``ring_self_attention`` (naive and zigzag), the
cross-attention form, ``ulysses_attention`` and ``TransformerLM(sp_comm=)``
in one spawned 4-rank world, and at 2 ranks on the two halves of it
(``comm.split``), each rank on its shard of the same numpy inputs.  The
JAX side: the same functions under ``run_spmd`` over 2 and 4 of
``tests/conftest.py``'s CPU devices, on the CPU blockwise path (as the
JAX suite runs them).  The checks are the twins of
``tests/parallel_tests/test_long_context.py``, of the SP tests of
``tests/models_tests/test_transformer.py`` and of
``tests/parallel_tests/test_hybrid.py``'s DP x SP step (whose sequence
half is the SP step here).

Tolerances: an output against the JAX package's or against attention
on the whole sequence, rtol 2e-4 / atol 2e-5 (the JAX test's own bound:
blockwise partials merged in fp32 in another order); gradients rtol 1e-3 /
atol 1e-4 (the JAX test's); the LM trajectories, losses 1e-5 and
parameters 1e-5 absolute after 3 SGD steps (two frameworks, other
summation orders; the SP model sums its gradients across the ranks in
another order than the single-device model); the one-process replay of
the ring, bitwise (the same operations on the same bits).
"""

import re

import numpy as np
import pytest
import torch

from tests.test_torch_communicator import spawn_ranks

WORLD = 4
B, H, D = 2, 4, 16
OUT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
LM_TOL = dict(rtol=0, atol=1e-5)
#: (case, schedule, causal, heads, seed, with gradients); the seeds are
#: the JAX tests'
CASES = [("ring", "naive", False, H, 1, False),
         ("ring_causal", "naive", True, H, 2, True),
         ("zigzag", "zigzag", True, H, 7, True),
         ("ulysses", "ulysses", False, 8, 4, False),
         ("ulysses_causal", "ulysses", True, 8, 5, True)]
SIZES = (2, 4)
LM = dict(n_vocab=50, d_model=32, n_heads=4, n_layers=1, max_len=32,
          seed=7)
LM_B, LM_T, LM_STEPS, LM_LR = 2, 16, 3, 0.5
MODES = ("ring", "zigzag", "ulysses")
EXAMPLE = ["--seq-len", "32", "--steps", "3", "--n-layers", "1",
           "--d-model", "32", "--n-heads", "4", "--vocab", "64"]


def _qkv(T, heads, seed, Tk=None):
    rng = np.random.RandomState(seed)
    mk = lambda t: rng.normal(0, 1, (B, heads, t, D)).astype(np.float32)
    return mk(T), mk(Tk or T), mk(Tk or T)


def _zigzag_perm(T, n):
    h = T // (2 * n)
    chunks = np.arange(T).reshape(2 * n, h)
    return np.concatenate([np.concatenate([chunks[i], chunks[2 * n - 1 - i]])
                           for i in range(n)])


def _lm_data():
    rng = np.random.RandomState(4)
    x = rng.randint(0, LM["n_vocab"], (LM_B, LM_T)).astype(np.int64)
    return x, np.roll(x, -1, axis=1)


def _full_reference(q, k, v, causal):
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        T = s.shape[-1]
        s = np.where(np.tril(np.ones((T, T), bool))[None, None], s, -np.inf)
    s = s - s.max(axis=-1, keepdims=True)
    p = np.exp(s)
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)


# -- worker (runs in the spawned ranks) ---------------------------------------

def _attention(comm, schedule, causal, q, k, v):
    from chainermn_tpu_torch.parallel import (ring_self_attention,
                                              ulysses_attention)
    if schedule == "ulysses":
        return ulysses_attention(comm, q, k, v, causal=causal)
    return ring_self_attention(comm, q, k, v, causal=causal,
                               schedule=schedule)


def _shard(x, comm, axis=2):
    n = x.shape[axis] // comm.size
    return torch.from_numpy(np.ascontiguousarray(np.take(
        x, np.arange(comm.rank * n, (comm.rank + 1) * n), axis=axis)))


def _sp_worker(rank, lm_npz):
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.core.optimizer import SGD
    from chainermn_tpu_torch.examples import train_long_context_lm as ex
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.parallel import ring_attention
    from chainermn_tpu_torch.serializers import load_npz
    world = create_communicator("jax_ici", device="cpu")
    comms = {4: world, 2: world.split(rank // 2, rank)}
    out = {}
    for n, comm in comms.items():
        for case, schedule, causal, heads, seed, grads in CASES:
            q, k, v = _qkv(8 * n, heads, seed)
            if schedule == "zigzag":
                perm = _zigzag_perm(8 * n, n)
                q, k, v = q[:, :, perm], k[:, :, perm], v[:, :, perm]
            leaves = [_shard(a, comm).requires_grad_(grads)
                      for a in (q, k, v)]
            o = _attention(comm, schedule, causal, *leaves)
            row = {"out": o.detach()}
            if grads:
                (o ** 2).sum().backward()
                row["grads"] = [a.grad for a in leaves]
            out[(n, case)] = row
        q, k, v = _qkv(4 * n, H, 9, Tk=12 * n)
        out[(n, "cross")] = {"out": ring_attention(
            comm, *(_shard(a, comm) for a in (q, k, v)))}
        # the SP LM: 3 SGD steps on the mean gradient over the ranks
        x, t = _lm_data()
        for mode in MODES:
            for remat in (False, True):
                model = TransformerLM(sp_comm=comm, sp_mode=mode,
                                      remat=remat, device="cpu", **LM)
                load_npz(lm_npz, model)
                opt = create_multi_node_optimizer(SGD(lr=LM_LR),
                                                  comm).setup(model)
                xs, ts = x, t
                if mode == "zigzag":
                    perm = _zigzag_perm(LM_T, n)
                    xs, ts = x[:, perm], t[:, perm]
                losses = [float(comm.allreduce(opt.update(
                    model, _shard(xs, comm, 1), _shard(ts, comm, 1))
                    .detach(), op="mean")) for _ in range(LM_STEPS)]
                out[(n, "lm", mode, remat)] = (losses, {
                    p: a.detach().clone() for p, a in model.namedparams()})
    # the example twin at 2 ranks
    out["example"] = ex.run(ex.parse_args(EXAMPLE + ["--device", "cpu",
                                                     "--sp-mode", "zigzag"]),
                            comms[2])
    return out


# -- the JAX references (this process) ----------------------------------------

def _jax_runs(lm_npz):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    import chainermn_tpu as ct
    from chainermn_tpu.core.link import bind_state, extract_state
    from chainermn_tpu.models import TransformerLM
    from chainermn_tpu.parallel import (ring_attention, ring_self_attention,
                                        ulysses_attention)
    from chainermn_tpu.serializers import save_npz
    spec = P(None, None, "seq", None)
    out = {}
    for n in SIZES:
        comm = ct.create_communicator("jax_ici", devices=jax.devices()[:n],
                                      axis_name="seq")
        for case, schedule, causal, heads, seed, grads in CASES:
            q, k, v = _qkv(8 * n, heads, seed)
            if schedule == "zigzag":
                perm = _zigzag_perm(8 * n, n)
                q, k, v = q[:, :, perm], k[:, :, perm], v[:, :, perm]

            def fn(q, k, v, schedule=schedule, causal=causal):
                if schedule == "ulysses":
                    return ulysses_attention(comm, q, k, v, causal=causal)
                return ring_self_attention(comm, q, k, v, causal=causal,
                                           schedule=schedule)

            if not grads:
                out[(n, case)] = {"out": np.asarray(comm.run_spmd(
                    fn, q, k, v, in_specs=(spec,) * 3, out_specs=spec))}
                continue

            def with_grads(q, k, v, fn=fn):
                o, vjp = jax.vjp(fn, q, k, v)
                return (o, *vjp(2 * o))    # the gradients of sum(o ** 2)

            o, *g = comm.run_spmd(with_grads, q, k, v, in_specs=(spec,) * 3,
                                  out_specs=(spec,) * 4)
            out[(n, case)] = {"out": np.asarray(o),
                              "grads": [np.asarray(a) for a in g]}
        q, k, v = _qkv(4 * n, H, 9, Tk=12 * n)
        out[(n, "cross")] = {"out": np.asarray(comm.run_spmd(
            lambda q, k, v: ring_attention(comm, q, k, v), q, k, v,
            in_specs=(spec,) * 3, out_specs=spec))}
    save_npz(lm_npz, TransformerLM(**LM))
    # the SP LM's trajectory at 4 ranks: the JAX example's step (SGD on
    # the gradient averaged over the sequence ranks)
    comm = ct.create_communicator("jax_ici", devices=jax.devices()[:4],
                                  axis_name="lm_seq")
    x, t = (jnp.asarray(a.astype(np.int32)) for a in _lm_data())
    for mode in MODES:
        model = TransformerLM(sp_comm=comm, sp_mode=mode, **LM)
        state = extract_state(model)

        def step(params, pstate, x, t, model=model):
            def loss_fn(p):
                with bind_state(model, {"params": p, "state": pstate}):
                    return model(x, t)
            loss, g = jax.value_and_grad(loss_fn)(params)
            g = jax.tree.map(lambda a: jax.lax.pmean(a, "lm_seq"), g)
            return (jax.tree.map(lambda p, a: p - LM_LR * a, params, g),
                    jax.lax.pmean(loss, "lm_seq"))

        compiled = jax.jit(jax.shard_map(
            step, mesh=comm.mesh,
            in_specs=(P(), P(), P(None, "lm_seq"), P(None, "lm_seq")),
            out_specs=(P(), P()), check_vma=False))
        xs, ts = x, t
        if mode == "zigzag":
            perm = _zigzag_perm(LM_T, 4)
            xs, ts = x[:, perm], t[:, perm]
        params, losses = state["params"], []
        for _ in range(LM_STEPS):
            params, loss = compiled(params, state["state"], xs, ts)
            losses.append(float(loss))
        out[("lm", mode)] = (losses, {p: np.asarray(a)
                                      for p, a in params.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sequence_parallel")
    npz = str(tmp / "jax_lm.npz")
    jax_out = _jax_runs(npz)
    ranks = spawn_ranks(tmp, _sp_worker, world=WORLD, lm_npz=npz)
    return ranks, jax_out


def _gathered(ranks, n, key, field="out", index=None):
    """The ranks' blocks of one case, concatenated along T; the 2-rank
    runs from world ranks 0 and 1 (ranks 2 and 3 ran the same)."""
    def block(r):
        x = ranks[r][key][field]
        return (x if index is None else x[index]).numpy()
    return np.concatenate([block(r) for r in range(n)], axis=2)


def _unzigzag(x, n):
    perm = _zigzag_perm(x.shape[2], n)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return x[:, :, inv]


# -- tests ------------------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_output_matches_jax_and_full_attention(runs, case, n):
    """``test_ring_attention_matches_full`` / ``_causal_`` / ``_zigzag_``
    and ``test_ulysses_matches_full`` / ``_causal_``'s twins: the port's
    sharded output equals the JAX package's and attention over the whole
    sequence."""
    ranks, jax_out = runs
    _, schedule, causal, heads, seed, _ = next(c for c in CASES
                                               if c[0] == case)
    raw = _gathered(ranks, n, (n, case))
    np.testing.assert_allclose(raw, jax_out[(n, case)]["out"], **OUT_TOL)
    got = _unzigzag(raw, n) if schedule == "zigzag" else raw
    ref = _full_reference(*_qkv(8 * n, heads, seed), causal)
    np.testing.assert_allclose(got, ref, **OUT_TOL)
    if n == 2:   # the other half of the world ran the same
        np.testing.assert_array_equal(np.concatenate(
            [ranks[r][(n, case)]["out"].numpy() for r in (2, 3)], axis=2),
            raw)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", [c[0] for c in CASES if c[5]])
def test_gradients_match_jax_and_full_attention(runs, case, n):
    """``test_ring_attention_gradients_match_full`` and
    ``test_ring_attention_zigzag_gradients_match_full``'s twins (and
    Ulysses'): dq, dk, dv of ``sum(out ** 2)`` on each rank's shard equal
    the JAX package's and ``torch.autograd`` on the whole sequence; every
    one finite (the naive schedule's ``skip`` and zigzag's ``future``
    branches merge ``-inf`` partials)."""
    from chainermn_tpu_torch.ops.flash_attention import xla_attention
    ranks, jax_out = runs
    _, schedule, causal, heads, seed, _ = next(c for c in CASES
                                               if c[0] == case)
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in _qkv(8 * n, heads, seed)]
    (xla_attention(*leaves, causal=causal) ** 2).sum().backward()
    for i in range(3):
        got = _gathered(ranks, n, (n, case), "grads", i)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, jax_out[(n, case)]["grads"][i],
                                   **GRAD_TOL)
        if schedule == "zigzag":
            got = _unzigzag(got, n)
        np.testing.assert_allclose(got, leaves[i].grad.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("n", SIZES)
def test_cross_attention_unequal_lengths(runs, n):
    """``test_ring_cross_attention_unequal_lengths``'s twin: Tq != Tk per
    rank, non-causal, against the JAX package and the whole sequence."""
    ranks, jax_out = runs
    got = _gathered(ranks, n, (n, "cross"))
    np.testing.assert_allclose(got, jax_out[(n, "cross")]["out"], **OUT_TOL)
    np.testing.assert_allclose(
        got, _full_reference(*_qkv(4 * n, H, 9, Tk=12 * n), False),
        **OUT_TOL)


class _Comm:
    """Size and rank only: the checks below raise before any transfer."""

    def __init__(self, size, rank=0):
        self.size, self.rank = size, rank


def test_causal_unequal_lengths_rejected():
    """``test_ring_causal_unequal_lengths_rejected``'s twin."""
    from chainermn_tpu_torch.parallel import ring_self_attention
    q, k = torch.zeros(1, 2, 4, 16), torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="equal local q/KV"):
        ring_self_attention(_Comm(4), q, k, k, causal=True)
    with pytest.raises(ValueError, match="unknown ring schedule"):
        ring_self_attention(_Comm(4), q, q, q, schedule="spiral")


def test_ulysses_head_count_validation():
    """``test_ulysses_head_count_validation``'s twin: 3 heads over 4
    ranks raise before the exchange."""
    from chainermn_tpu_torch.parallel import seq_to_head_shard
    with pytest.raises(ValueError, match="not divisible"):
        seq_to_head_shard(_Comm(4), torch.zeros(1, 3, 8, 4))


def test_zigzag_schedule_is_balanced():
    """``test_zigzag_schedule_is_balanced``'s twin over the port's
    ``_causal_branch``: zigzag gives every rank the same work at every
    step, the naive schedule a spread of about n."""
    from chainermn_tpu_torch.parallel.ring_attention import _causal_branch
    n = WORLD * 2
    weights = {"naive": {0: 4.0, 1: 2.0, 2: 0.0},
               "zigzag": {0: 2.0, 1: 2.0, 2: 2.0}}
    tables = {s: np.array([[w[_causal_branch(s, (r - st) % n, r)]
                            for st in range(n)] for r in range(n)])
              for s, w in weights.items()}
    assert np.all(tables["zigzag"] == 2.0)
    assert tables["zigzag"].sum() == tables["naive"].sum()
    totals = tables["naive"].sum(axis=1)
    assert totals.max() / totals.min() >= n - 1


@pytest.mark.parametrize("size", [1, 2, 4])
def test_zigzag_shard_roundtrip(size):
    """``test_zigzag_shard_roundtrip``'s twin, and the permutation equal
    to the JAX package's ``_zigzag_perm``."""
    from chainermn_tpu.parallel.ring_attention import _zigzag_perm
    from chainermn_tpu_torch.parallel import zigzag_shard, zigzag_unshard
    from chainermn_tpu_torch.parallel.ring_attention import \
        _zigzag_perm as port_perm
    x = torch.arange(2 * 3 * 4 * size * 5.0).reshape(2, 3, 4 * size, 5)
    assert torch.equal(zigzag_unshard(zigzag_shard(x, size), size), x)
    np.testing.assert_array_equal(port_perm(4 * size, size),
                                  _zigzag_perm(4 * size, size))
    with pytest.raises(ValueError, match="divisible"):
        zigzag_shard(torch.zeros(1, 1, 6, 1), 4)


def test_merge_of_empty_partials_has_finite_gradients():
    """Two partials with no live key merge to out 0, lse ``-inf``, and
    every gradient is finite (``torch.logaddexp(-inf, -inf)``'s is NaN);
    a live partial merged with an empty one is itself."""
    from chainermn_tpu_torch.parallel.ring_attention import _merge_blocks
    out = torch.randn(1, 1, 3, 4, requires_grad=True)
    lse = torch.tensor([[[0.5, float("-inf"), 1.0]]], requires_grad=True)
    out_b = torch.randn(1, 1, 3, 4, requires_grad=True)
    lse_b = torch.tensor([[[float("-inf")] * 3]], requires_grad=True)
    o, s = _merge_blocks(out, lse, out_b, lse_b)
    assert torch.equal(s.detach(), lse.detach())
    assert torch.equal(o[0, 0, 0], out[0, 0, 0])
    assert torch.equal(o[0, 0, 1].detach(), torch.zeros(4))
    (o.sum() + torch.where(torch.isfinite(s), s, 0.0).sum()).backward()
    for x in (out, lse, out_b, lse_b):
        assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", [c[0] for c in CASES
                                  if c[1] != "ulysses"])
def test_one_process_replay_is_the_ring_bitwise(runs, case, n):
    """``_ring_step``'s one-process replay of the n-rank schedule (what
    ``chip_smoke.py`` runs on one card) gives the gloo ring's output
    bitwise."""
    from chainermn_tpu_torch.parallel.ring_attention import _ring_replay
    ranks, _ = runs
    _, schedule, causal, heads, seed, _ = next(c for c in CASES
                                               if c[0] == case)
    q, k, v = _qkv(8 * n, heads, seed)
    if schedule == "zigzag":
        perm = _zigzag_perm(8 * n, n)
        q, k, v = q[:, :, perm], k[:, :, perm], v[:, :, perm]
    got = _ring_replay(*(torch.from_numpy(np.ascontiguousarray(a))
                         for a in (q, k, v)), n, schedule, causal)
    np.testing.assert_array_equal(got.numpy(),
                                  _gathered(ranks, n, (n, case)))


def _single_device_trajectory(npz):
    from chainermn_tpu_torch.core.optimizer import SGD
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serializers import load_npz
    model = TransformerLM(device="cpu", **LM)
    load_npz(npz, model)
    opt = SGD(lr=LM_LR).setup(model)
    x, t = (torch.from_numpy(a) for a in _lm_data())
    losses = [opt.update(model, x, t).item() for _ in range(LM_STEPS)]
    return losses, {p: a.detach() for p, a in model.namedparams()}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mode", MODES)
def test_sp_lm_trajectory_matches_jax(runs, mode, n, remat):
    """The SP ``TransformerLM`` (``test_sequence_parallel_gradients_match``,
    ``_zigzag_matches_single_device`` and ``_remat_policy_matches``'
    twins, and the sequence half of ``test_dp_sp_hybrid_transformer_
    step``): from one JAX npz, 3 SGD steps on the gradient averaged over
    the ranks give the JAX SP model's losses and parameters (its 4-rank
    run: the mean gradient is the whole sequence's at any n), with and
    without remat, on every rank; and the port's single-device model's."""
    ranks, jax_out = runs
    want_losses, want_params = jax_out[("lm", mode)]
    for r in range(WORLD):
        losses, params = ranks[r][(n, "lm", mode, remat)]
        np.testing.assert_allclose(losses, want_losses, **LM_TOL)
        for p, a in want_params.items():
            np.testing.assert_allclose(params[p].numpy(), a, err_msg=p,
                                       **LM_TOL)
    assert want_losses[-1] < want_losses[0]


def test_single_device_lm_matches_the_sp_trajectory(runs, tmp_path):
    """The port's plain ``TransformerLM`` on the whole sequence follows
    the same trajectory as the SP runs (the golden rule)."""
    ranks, jax_out = runs
    from chainermn_tpu.models import TransformerLM
    from chainermn_tpu.serializers import save_npz
    npz = str(tmp_path / "lm.npz")
    save_npz(npz, TransformerLM(**LM))
    losses, params = _single_device_trajectory(npz)
    for mode in MODES:
        np.testing.assert_allclose(losses, jax_out[("lm", mode)][0],
                                   **LM_TOL)
        got = ranks[0][(4, "lm", mode, False)][1]
        for p, a in params.items():
            np.testing.assert_allclose(got[p].numpy(), a.numpy(), err_msg=p,
                                       **LM_TOL)


def test_example_twin_at_two_ranks(runs):
    """The twin of ``examples/train_long_context_lm.py`` (zigzag, 2
    ranks) prints the JAX script's line, with a finite final loss that
    both ranks agree on."""
    ranks, _ = runs
    line, loss = ranks[0]["example"]
    assert re.fullmatch(r"mode=zigzag seq=32 final_loss=[\d.]+ "
                        r"tokens/sec=[\d,]+", line)
    assert np.isfinite(loss) and ranks[1]["example"][1] == loss
