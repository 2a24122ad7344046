"""The mixture of experts of the port against the JAX package's, in one
4-rank gloo world.

The port side: ``switch_moe``, ``moe_dispatch_combine(_topk)``, the
exchange (flat, and two-stage at a forced 2 x 2 split, lossless and with
the bf16, int8 and e4m3 inter-node wires) and ``MoETransformerLM`` in one
spawned 4-rank world, and at 2 ranks on its halves (``comm.split``), each
rank on its slice of the same numpy tokens.  The JAX side: the same
functions under ``run_spmd`` over 2 and 4 of ``tests/conftest.py``'s CPU
devices (a ``hierarchical`` communicator with ``inter_size=2`` for the
2 x 2), the JAX MoE LM through its multi-node optimizer, and its dense
route on one device.  The checks are the twins of
``tests/parallel_tests/test_moe.py`` and of the MoE tests of
``tests/models_tests/test_transformer.py``; they test outputs, not the
MoE census of ``tools/comm_budgets.json``.

Tolerances: layer outputs, rtol 2e-4 / atol 2e-5 against a dense
reference (the JAX test's) and 1e-5 absolute against the JAX package (two
frameworks, other summation orders); the exchange and the two-stage path
against the flat one, bitwise (the same bits move); the int8 and e4m3
crossings against the compiled JAX ones, to one fp32 ulp (see
``_equal_to_compiled_jax``); the switch layer's gradients as its
outputs, against ``jax.grad`` and a float64 dense reference; the LM's
gradient from one SGD step at lr 1, rtol 1e-4 / atol 1e-6 (the
gradient read back as ``p - (p - g)`` in fp32 keeps about 1e-7 of each
parameter, and exact zeros such as the key biases' come out as rounding
noise); LM trajectories over 3
Adam steps, losses and parameters 1e-5 absolute in fp32, but the key
part of the qkv biases, whose exact gradient is 0, 2 alpha a step (Adam's
first steps move a weight by about alpha whatever its gradient, so
rounding noise picks the direction, as the DCGAN tests band the pre-BN
biases); the bf16 LM 5e-2 relative on its losses (the JAX test's bf16
band: the JAX layer's bf16 residual stream turns fp32 after the first
MoE block, the port's stays bf16).
"""

import os
import warnings

import numpy as np
import pytest
import torch

from tests.test_torch_communicator import spawn_ranks

WORLD = 4
SIZES = (2, 4)
D_TOK, H_EXP = 8, 16
OUT_TOL = dict(rtol=2e-4, atol=2e-5)
JAX_TOL = dict(rtol=0, atol=1e-5)
MOE_LM = dict(n_vocab=64, d_model=32, n_heads=2, n_layers=2, max_len=16,
              seed=0)
LM_ROWS, LM_T, LM_STEPS, LM_ALPHA = 8, 16, 3, 3e-3
#: the switch layer's gradient test: L = sum(cot * out) + AUX_W * the
#: ranks' aux losses; the LM's one SGD step at lr 1 (the gradient itself)
AUX_W, SGD_LR = 0.5, 1.0
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
DENSE_LM = dict(n_vocab=50, d_model=16, n_heads=2, n_layers=2, seed=12)
WIRES = {"int8": "int8", "e4m3": "float8_e4m3", "bf16": "bfloat16"}


def _weights(E, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 0.5, (D_TOK, E)).astype(np.float32),
            rng.normal(0, 0.3, (E, D_TOK, H_EXP)).astype(np.float32),
            np.zeros((E, H_EXP), np.float32),
            rng.normal(0, 0.3, (E, H_EXP, D_TOK)).astype(np.float32),
            np.zeros((E, D_TOK), np.float32))


def _tokens(n_rows, seed, d=D_TOK):
    return np.random.RandomState(seed).normal(0, 1, (n_rows, d)) \
        .astype(np.float32)


def _sentinel(E, C=4, D=3, seed=3):
    """The ``[E * E, C, D]`` stacked buffer of the JAX exchange tests
    (rank ``r``'s ``[E, C, D]`` at rows ``r E .. r E + E``)."""
    return np.random.RandomState(seed).normal(0, 1, (E * E, C, D)) \
        .astype(np.float32)


def _cotangent(n_rows):
    return _tokens(n_rows, 21)


def _switch_grads_reference(n):
    """``d L / d (x, router, w_in, b_in, w_out, b_out)`` of the switch
    layer at a generous capacity, in one process in float64 (each token
    times its argmax expert's gate; each rank's aux loss over its own
    tokens, ``E sum(frac mean_prob)`` with ``frac`` a constant)."""
    ts = [torch.from_numpy(a).double().requires_grad_()
          for a in (_tokens(n * 4, 1), *_weights(n))]
    x, router, w_in, b_in, w_out, b_out = ts
    p = torch.softmax(x @ router, -1)
    top = p.argmax(-1)
    h = torch.nn.functional.gelu(
        torch.einsum("td,tdh->th", x, w_in[top]) + b_in[top],
        approximate="tanh")
    out = p.gather(1, top[:, None]) * (
        torch.einsum("th,thd->td", h, w_out[top]) + b_out[top])
    loss = (out * torch.from_numpy(_cotangent(n * 4)).double()).sum()
    for r in range(n):
        rows = slice(4 * r, 4 * r + 4)
        frac = torch.nn.functional.one_hot(top[rows], n).double().mean(0)
        loss = loss + AUX_W * n * (frac * p[rows].mean(0)).sum()
    loss.backward()
    return [a.grad.numpy() for a in ts]


def _lm_tokens():
    rng = np.random.RandomState(0)
    x = rng.randint(0, MOE_LM["n_vocab"], (LM_ROWS, LM_T)).astype(np.int64)
    return x, np.roll(x, -1, axis=1)


def _dense_tokens():
    rng = np.random.RandomState(9)
    x = rng.randint(0, DENSE_LM["n_vocab"], (2, 16)).astype(np.int64)
    return x, np.roll(x, -1, axis=1)


def _gelu(x):
    return 0.5 * x * (1 + np.tanh(np.sqrt(2 / np.pi) * (x + 0.044715 * x ** 3)))


def _dense_reference(x, router, w_in, b_in, w_out, b_out, k=1):
    """Every token through its top-k experts, the gates renormalized for
    k > 1 (the JAX tests' references)."""
    logits = x @ router
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    out = np.zeros_like(x)
    for t in range(x.shape[0]):
        top = np.argsort(-p[t])[:k]
        g = p[t, top] / (p[t, top].sum() if k > 1 else 1.0)
        for j, e in enumerate(top):
            out[t] += g[j] * (_gelu(x[t] @ w_in[e] + b_in[e]) @ w_out[e]
                              + b_out[e])
    return out


# -- worker (runs in the spawned ranks) ---------------------------------------

def _params_of(model):
    return {p: a.detach().clone() for p, a in model.namedparams()}


def _rows(x, comm):
    n = x.shape[0] // comm.size
    return torch.from_numpy(x[comm.rank * n:(comm.rank + 1) * n])


def _moe_worker(rank, lm_npz):
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.core.optimizer import SGD, Adam
    from chainermn_tpu_torch.models import MoETransformerLM
    from chainermn_tpu_torch.parallel import (moe_dispatch_combine,
                                              moe_dispatch_combine_topk,
                                              switch_moe)
    from chainermn_tpu_torch.parallel import moe as moe_mod
    from chainermn_tpu_torch.serializers import load_npz
    world = create_communicator("jax_ici", device="cpu")
    split = dict(device="cpu", intra_size=2, inter_size=2)
    comms = {4: world, 2: world.split(rank // 2, rank)}
    hier = create_communicator("hierarchical", **split)
    wired = {w: create_communicator("hierarchical",
                                    allreduce_grad_dtype={"dcn": dt},
                                    **split) for w, dt in WIRES.items()}
    out = {"calls": {}, "axis_in_scope": [c.axis_in_scope() for c in (
        world, comms[2], hier, *wired.values())]}

    for n, comm in comms.items():
        E = comm.size
        router, w_in, b_in, w_out, b_out = (torch.from_numpy(a)
                                            for a in _weights(E))
        me = comm.rank
        expert = (w_in[me], b_in[me], w_out[me], b_out[me])
        x = _rows(_tokens(E * 4, 1), comm)
        o, aux = switch_moe(comm, x, router, *expert,
                            capacity_factor=float(E))
        out[(n, "switch")] = (o, aux["aux_loss"])
        # the gradients through the exchange's backward: every rank's
        # part of L, the router's summed over the ranks afterwards
        leaves = [a.clone().requires_grad_() for a in (x, router, *expert)]
        o, aux = switch_moe(comm, *leaves, capacity_factor=float(E))
        ((o * _rows(_cotangent(E * 4), comm)).sum()
         + AUX_W * aux["aux_loss"]).backward()
        out[(n, "switch_grads")] = [a.grad for a in leaves]
        x = _rows(_tokens(E * 4, 5), comm)

        def expert_fn(h, e=expert):
            return torch.nn.functional.gelu(h @ e[0] + e[1],
                                            approximate="tanh") @ e[2] + e[3]

        out[(n, "topk")] = moe_dispatch_combine_topk(
            comm, x, x @ router, expert_fn, k=2,
            capacity_factor=float(E))[0]
        # capacity overflow
        x = _rows(_tokens(E * 16, 5), comm)
        r = torch.from_numpy(np.random.RandomState(5).normal(
            0, 0.5, (D_TOK, E)).astype(np.float32))
        o, aux = moe_dispatch_combine(comm, x, x @ r, lambda h: h,
                                      capacity_factor=0.5)
        out[(n, "overflow")] = (o, {k: aux[k] for k in (
            "dropped_frac", "frac", "mean_prob", "aux_loss", "capacity")})

    # the exchange at the 2 x 2 split
    base = _sentinel(WORLD)
    mine = torch.from_numpy(base[rank * WORLD:(rank + 1) * WORLD])
    flat = moe_mod._exchange(hier, mine, False)
    two = moe_mod._exchange(hier, mine, True)
    back = moe_mod._exchange(hier, two, True, combine=True)
    out["exchange"] = (flat, two, back)
    out["wires"] = {w: moe_mod._exchange(c, mine, True)
                    for w, c in wired.items()}
    out["calls"]["hier"] = dict(hier.calls)
    # the quantized crossing's backward: the same compressed crossing
    leaf = mine.clone().requires_grad_()
    moe_mod._exchange(wired["int8"], leaf, True).backward(mine)
    out["int8_backward"] = leaf.grad
    x = _rows(_tokens(WORLD * 8, 11), world)
    r = torch.from_numpy(np.random.RandomState(11).normal(
        0, 0.5, (D_TOK, WORLD)).astype(np.float32))
    out["topk_two_stage"] = [moe_dispatch_combine_topk(
        hier, x, x @ r, lambda h: h * 2.0 + 1.0, k=2, capacity_factor=2.0,
        two_stage=ts)[0] for ts in (False, True)]

    # the flat hatch: a requested hierarchy flattened by the environment
    os.environ["CHAINERMN_TPU_HIERARCHY"] = "flat"
    try:
        hatch = create_communicator("hierarchical", **split)
    finally:
        del os.environ["CHAINERMN_TPU_HIERARCHY"]
    x = _rows(_tokens(WORLD * 4, 13, d=8), world)
    r = torch.from_numpy(np.random.RandomState(13).normal(
        0, 0.5, (8, WORLD)).astype(np.float32))

    def run(comm, two_stage):
        return moe_dispatch_combine(comm, x, x @ r, lambda h: h * 2.0,
                                    capacity_factor=2.0,
                                    two_stage=two_stage)[0]

    with warnings.catch_warnings(record=True) as first:
        warnings.simplefilter("always")
        dropped = run(hatch, True)
    with warnings.catch_warnings(record=True) as second:
        warnings.simplefilter("always")
        again = run(hatch, True)
    try:
        run(world, True)
        loud = None
    except ValueError as e:
        loud = str(e)
    out["hatch"] = (hatch.hierarchy, [str(w.message) for w in first],
                    [str(w.message) for w in second], loud, dropped, again,
                    run(hatch, False))

    # the MoE LM through the multi-node optimizer
    x, t = _lm_tokens()
    runs = [(n, "flat", comms[n], False) for n in SIZES] + [
        (4, "two_stage", hier, False), (4, "remat", comms[4], True),
        (4, "int8", wired["int8"], False), (4, "bf16", wired["bf16"], False)]
    for n, label, ep, remat in runs:
        model = MoETransformerLM(ep_comm=ep, remat=remat, device="cpu",
                                 **MOE_LM)
        load_npz(lm_npz[n], model)
        comm = comms[n]
        opt = create_multi_node_optimizer(Adam(alpha=LM_ALPHA),
                                          comm).setup(model)
        ep.calls.clear()
        losses = [float(comm.allreduce(opt.update(
            model, _rows(x, comm), _rows(t, comm)).detach(), op="mean"))
            for _ in range(LM_STEPS)]
        out[(n, "lm", label)] = (losses, _params_of(model),
                                 dict(ep.calls))
    # one SGD step of the dispatch LM: the gradient itself, which Adam's
    # m / sqrt(v) would hide behind a constant factor on a whole leaf
    for n in SIZES:
        model = MoETransformerLM(ep_comm=comms[n], device="cpu", **MOE_LM)
        load_npz(lm_npz[n], model)
        before = _params_of(model)
        opt = create_multi_node_optimizer(SGD(lr=SGD_LR),
                                          comms[n]).setup(model)
        opt.update(model, _rows(x, comms[n]), _rows(t, comms[n]))
        out[(n, "lm_grads")] = {p: (before[p] - a.detach()) / SGD_LR
                                for p, a in model.namedparams()}
    # dense against dispatch at a generous capacity, every rank routing the
    # whole batch (test_moe_transformer_dense_vs_expert_parallel)
    xd, td = (torch.from_numpy(a) for a in _dense_tokens())
    ep = MoETransformerLM(DENSE_LM["n_vocab"], world, d_model=16, n_heads=2,
                          n_layers=1, seed=11, capacity_factor=float(WORLD),
                          device="cpu")
    dense = MoETransformerLM(DENSE_LM["n_vocab"], WORLD, d_model=16,
                             n_heads=2, n_layers=1, seed=11, device="cpu")
    out["dense_vs_ep"] = (float(ep(xd, td)), float(dense(xd, td)))
    # a bf16 dispatch run learns
    model = MoETransformerLM(ep_comm=world, compute_dtype=torch.bfloat16,
                             remat=True, device="cpu", **MOE_LM)
    opt = create_multi_node_optimizer(Adam(alpha=LM_ALPHA),
                                      world).setup(model)
    out["bf16_dispatch"] = [float(opt.update(model, _rows(x, world),
                                             _rows(t, world)))
                            for _ in range(8)]
    return out


# -- the JAX references (this process) ----------------------------------------

def _jax_runs(lm_npz, dense_npz):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    import chainermn_tpu as ct
    from chainermn_tpu.core.optimizer import SGD, Adam
    from chainermn_tpu.models import MoETransformerLM
    from chainermn_tpu.parallel import (moe_dispatch_combine,
                                        moe_dispatch_combine_topk,
                                        switch_moe)
    from chainermn_tpu.parallel import moe as moe_mod
    from chainermn_tpu.serializers import save_npz
    out = {}
    for n in SIZES:
        comm = ct.create_communicator("jax_ici", devices=jax.devices()[:n],
                                      axis_name="ep")
        E = n
        router, w_in, b_in, w_out, b_out = map(jnp.asarray, _weights(E))
        specs = (P("ep"), P(), P("ep"), P("ep"), P("ep"), P("ep"))

        def body(x, router, w_in, b_in, w_out, b_out):
            o, aux = switch_moe(comm, x, router, w_in[0], b_in[0],
                                w_out[0], b_out[0], capacity_factor=float(E))
            return o, aux["aux_loss"].reshape(1)

        o, aux = comm.run_spmd(body, _tokens(E * 4, 1), router, w_in, b_in,
                               w_out, b_out, in_specs=specs,
                               out_specs=(P("ep"), P("ep")))
        out[(n, "switch")] = (np.asarray(o), np.asarray(aux))
        cot = jnp.asarray(_cotangent(E * 4))

        def loss(*args):
            o, aux = comm.run_spmd(body, *args, in_specs=specs,
                                   out_specs=(P("ep"), P("ep")))
            return (o * cot).sum() + AUX_W * aux.sum()

        out[(n, "switch_grads")] = [np.asarray(a) for a in jax.grad(
            loss, argnums=tuple(range(6)))(
                jnp.asarray(_tokens(E * 4, 1)), router, w_in, b_in, w_out,
                b_out)]

        def body_k(x, router, w_in, b_in, w_out, b_out):
            def expert(h):
                return jax.nn.gelu(h @ w_in[0] + b_in[0]) @ w_out[0] \
                    + b_out[0]
            return moe_dispatch_combine_topk(comm, x, x @ router, expert,
                                             k=2, capacity_factor=float(E))[0]

        out[(n, "topk")] = np.asarray(comm.run_spmd(
            body_k, _tokens(E * 4, 5), router, w_in, b_in, w_out, b_out,
            in_specs=specs, out_specs=P("ep")))
        r = np.random.RandomState(5).normal(0, 0.5, (D_TOK, E)) \
            .astype(np.float32)

        def body_o(x, r):
            o, aux = moe_dispatch_combine(comm, x, x @ r, lambda h: h,
                                          capacity_factor=0.5)
            return (o, aux["dropped_frac"].reshape(1), aux["frac"],
                    aux["mean_prob"], aux["aux_loss"].reshape(1))

        out[(n, "overflow")] = [np.asarray(a) for a in comm.run_spmd(
            body_o, _tokens(E * 16, 5), r, in_specs=(P("ep"), P()),
            out_specs=(P("ep"),) * 5)]

    # the exchange at the 2 x 2 split: lossless and each wire
    devices = jax.devices()[:WORLD]
    hier = ct.create_communicator("hierarchical", devices=devices,
                                  inter_size=2)
    base = _sentinel(WORLD)

    def exchange(comm):
        axes = comm.axis_name
        return np.asarray(comm.run_spmd(
            lambda b: moe_mod._exchange(comm, b, True), jnp.asarray(base),
            in_specs=(P(axes),), out_specs=P(axes)))

    out["exchange"] = exchange(hier)
    wired = {w: ct.create_communicator(
        "hierarchical", devices=devices, inter_size=2,
        allreduce_grad_dtype={"dcn": dt}) for w, dt in WIRES.items()}
    out["wires"] = {w: exchange(c) for w, c in wired.items()}
    q = wired["int8"]
    out["int8_backward"] = np.asarray(q.run_spmd(
        lambda b: jax.vjp(lambda a: moe_mod._exchange(q, a, True), b)[1](b)[0],
        jnp.asarray(base), in_specs=(P(q.axis_name),),
        out_specs=P(q.axis_name)))

    # the MoE LM's trajectories: the dispatch through the multi-node
    # optimizer at 2 and 4 devices, the dense route on one
    x, t = (jnp.asarray(a.astype(np.int32)) for a in _lm_tokens())
    for n in SIZES:
        comm = ct.create_communicator("jax_ici", devices=jax.devices()[:n],
                                      axis_name=f"moe_lm{n}")
        model = MoETransformerLM(ep_comm=comm, **MOE_LM)
        save_npz(lm_npz[n], model)
        opt = ct.create_multi_node_optimizer(Adam(alpha=LM_ALPHA),
                                             comm).setup(model)
        losses = [float(opt.update(model, x, t)) for _ in range(LM_STEPS)]
        out[(n, "lm")] = (losses, {p: np.asarray(a.array)
                                   for p, a in model.namedparams()})
        comm = ct.create_communicator("jax_ici", devices=jax.devices()[:n],
                                      axis_name=f"moe_sgd{n}")
        model = MoETransformerLM(ep_comm=comm, **MOE_LM)
        before = {p: np.asarray(a.array) for p, a in model.namedparams()}
        ct.create_multi_node_optimizer(SGD(lr=SGD_LR), comm).setup(
            model).update(model, x, t)
        out[(n, "lm_grads")] = {p: (before[p] - np.asarray(a.array)) / SGD_LR
                                for p, a in model.namedparams()}
    xd, td = (jnp.asarray(a.astype(np.int32)) for a in _dense_tokens())
    ep = ct.create_communicator("jax_ici", devices=jax.devices()[:WORLD],
                                axis_name="moe_dense")
    for label, kw in (("fp32", {}),
                      ("bf16", dict(compute_dtype=jnp.bfloat16))):
        model = MoETransformerLM(DENSE_LM["n_vocab"], ep, d_model=16,
                                 n_heads=2, n_layers=2, seed=12, **kw)
        if label == "fp32":
            save_npz(dense_npz, model)
        opt = Adam(alpha=LM_ALPHA).setup(model)
        losses = [float(opt.update(model, xd, td)) for _ in range(LM_STEPS)]
        out[("dense", label)] = (losses, {p: np.asarray(a.array)
                                          for p, a in model.namedparams()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    lm_npz = {n: str(tmp / f"jax_moe_lm{n}.npz") for n in SIZES}
    dense_npz = str(tmp / "jax_moe_dense.npz")
    jax_out = _jax_runs(lm_npz, dense_npz)
    jax_out["dense_npz"] = dense_npz
    ranks = spawn_ranks(tmp, _moe_worker, world=WORLD, lm_npz=lm_npz)
    return ranks, jax_out


def _gathered(ranks, n, key, index=None):
    """The ranks' rows of one output, concatenated (the 2-rank runs from
    world ranks 0 and 1)."""
    rows = [ranks[r][key] if index is None else ranks[r][key][index]
            for r in range(n)]
    return np.concatenate([np.asarray(a) for a in rows], axis=0)


def _close_params(got, want, tol):
    """Every parameter within ``tol``, except the key part of each
    attention's qkv bias: a shift of every key adds one constant to a
    row's scores, so its exact gradient is 0 and Adam steps it by about
    alpha in the direction of the rounding noise, on either side; it
    gets 2 alpha a step."""
    assert sorted(got) == sorted(want)
    for p, a in want.items():
        g = got[p].numpy()
        if p.endswith("/attn/qkv/b"):
            d = a.shape[0] // 3
            key = slice(d, 2 * d)
            np.testing.assert_allclose(g[key], a[key], err_msg=p, rtol=0,
                                       atol=2 * LM_ALPHA * LM_STEPS)
            g, a = np.delete(g, np.s_[key]), np.delete(a, np.s_[key])
        np.testing.assert_allclose(g, a, err_msg=p, **tol)


# -- tests ------------------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
def test_switch_matches_dense_routing_and_jax(runs, n):
    """``test_moe_forward_matches_dense_routing``'s twin: at a generous
    capacity ``switch_moe`` is each token through its argmax expert times
    its gate, as the JAX package computes it, with the same aux loss."""
    ranks, jax_out = runs
    got = _gathered(ranks, n, (n, "switch"), 0)
    want, want_aux = jax_out[(n, "switch")]
    np.testing.assert_allclose(got, want, **JAX_TOL)
    np.testing.assert_allclose(
        got, _dense_reference(_tokens(n * 4, 1), *_weights(n)), **OUT_TOL)
    np.testing.assert_allclose([float(ranks[r][(n, "switch")][1])
                                for r in range(n)], want_aux, rtol=1e-6)


@pytest.mark.parametrize("n", SIZES)
def test_switch_gradients_match_jax_grad_and_dense(runs, n):
    """The switch layer's gradients, through the exchange's backward, at
    2 and 4 ranks: each rank's part of ``L = sum(cot out) + 0.5 aux``
    backward gives its expert's and its tokens' gradients, and the router's
    summed over the ranks, as ``jax.grad`` of ``L`` over ``run_spmd`` and
    a float64 dense reference give them (no factor of the rank count)."""
    ranks, jax_out = runs
    per_rank = [[np.asarray(a) for a in ranks[r][(n, "switch_grads")]]
                for r in range(n)]
    got = [np.concatenate([g[0] for g in per_rank]),
           sum(g[1] for g in per_rank)] + [
        np.stack([g[i] for g in per_rank]) for i in range(2, 6)]
    names = ("x", "router", "w_in", "b_in", "w_out", "b_out")
    for name, g, want, dense in zip(names, got, jax_out[(n, "switch_grads")],
                                    _switch_grads_reference(n)):
        assert np.abs(dense).max() > 0, name
        np.testing.assert_allclose(g, want, err_msg=name, **JAX_TOL)
        np.testing.assert_allclose(g, dense, err_msg=name, **OUT_TOL)


@pytest.mark.parametrize("n", SIZES)
def test_moe_lm_sgd_step_gradient_matches_jax(runs, n):
    """One SGD step at lr 1 through the multi-node optimizer: every
    parameter's gradient, the router and the expert bank (sliced per rank
    through ``psum_gradient``) among them, is the JAX run's on as many
    devices, with no constant factor that Adam would hide."""
    ranks, jax_out = runs
    want = jax_out[(n, "lm_grads")]
    for r in range(n):
        got = ranks[r][(n, "lm_grads")]
        assert sorted(got) == sorted(want)
        for p, a in want.items():
            np.testing.assert_allclose(got[p].numpy(), a, err_msg=p,
                                       **GRAD_TOL)
    bank = [p for p in want if "/moe/" in p]
    assert len(bank) == 5 * MOE_LM["n_layers"]
    assert all(np.abs(want[p]).max() > 0 for p in bank)


@pytest.mark.parametrize("n", SIZES)
def test_topk_matches_dense_topk_and_jax(runs, n):
    """``test_topk_moe_matches_dense_topk``'s twin (k = 2)."""
    ranks, jax_out = runs
    got = _gathered(ranks, n, (n, "topk"))
    np.testing.assert_allclose(got, jax_out[(n, "topk")], **JAX_TOL)
    np.testing.assert_allclose(
        got, _dense_reference(_tokens(n * 4, 5), *_weights(n), k=2),
        rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("n", SIZES)
def test_dropped_frac_reports_capacity_overflow(runs, n):
    """``test_dropped_frac_reports_capacity_overflow``'s twin: at capacity
    factor 0.5 ``dropped_frac`` counts the tokens past each expert's
    queue, ``aux_loss`` is ``E sum(frac mean_prob)``, and every value is
    the JAX package's."""
    ranks, jax_out = runs
    E, T = n, 16
    capacity = max(1, int(0.5 * T / E))
    x = _tokens(E * T, 5)
    r = np.random.RandomState(5).normal(0, 0.5, (D_TOK, E)) \
        .astype(np.float32)
    idx = (x @ r).argmax(-1).reshape(E, T)
    j_out, j_dropped, j_frac, j_prob, j_aux = jax_out[(n, "overflow")]
    np.testing.assert_allclose(_gathered(ranks, n, (n, "overflow"), 0),
                               j_out, **JAX_TOL)
    for rank in range(E):
        aux = ranks[rank][(n, "overflow")][1]
        counts, kept = np.zeros(E, int), 0
        for e in idx[rank]:
            kept += counts[e] < capacity
            counts[e] += 1
        assert aux["capacity"] == capacity
        assert float(aux["dropped_frac"]) == pytest.approx(1 - kept / T,
                                                           abs=1e-6)
        assert float(aux["dropped_frac"]) == pytest.approx(
            j_dropped[rank], abs=1e-6)
        np.testing.assert_allclose(aux["frac"].numpy(),
                                   j_frac.reshape(E, E)[rank], rtol=1e-6)
        np.testing.assert_allclose(aux["mean_prob"].numpy(),
                                   j_prob.reshape(E, E)[rank], rtol=1e-5)
        np.testing.assert_allclose(
            float(aux["aux_loss"]),
            E * float((aux["frac"] * aux["mean_prob"]).sum()), rtol=1e-6)
    assert any(float(ranks[r][(n, "overflow")][1]["dropped_frac"]) > 0
               for r in range(E)), "capacity 0.5 dropped nothing"


def test_two_stage_exchange_every_token_exactly_once(runs):
    """``test_two_stage_exchange_every_token_exactly_once``'s twin at a
    2 x 2 split: the two-stage exchange is the flat all-to-all bitwise
    (every sentinel lands once, where the flat one puts it), equal to the
    JAX package's, and the combine is its exact inverse; the hops ran in
    ``hop_schedule("moe")``'s order, once each."""
    ranks, jax_out = runs
    base = _sentinel(WORLD)
    two_all = np.concatenate([ranks[r]["exchange"][1].numpy()
                              for r in range(WORLD)])
    np.testing.assert_array_equal(two_all, jax_out["exchange"])
    for rank, r in enumerate(ranks):
        flat, two, back = (a.numpy() for a in r["exchange"])
        np.testing.assert_array_equal(two, flat)
        np.testing.assert_array_equal(
            back, base[rank * WORLD:(rank + 1) * WORLD])
        # rank me's slot from rank src is src's block me
        for src in range(WORLD):
            np.testing.assert_array_equal(two[src], base[src * WORLD + rank])
        calls = r["calls"]["hier"]
        assert calls == {"moe_alltoall": 1, "moe_ici_dispatch": 1,
                         "moe_dcn_dispatch": 1, "moe_dcn_combine": 1,
                         "moe_ici_combine": 1}


def _equal_to_compiled_jax(got, want, quantized):
    """Bitwise; a quantized crossing to one fp32 ulp: compiled, XLA turns
    the JAX quantizer's division by ``qmax`` into a multiplication by its
    reciprocal, which can move the scale's last bit (the port is bitwise
    the JAX function run eagerly: ``test_pure_functions_equal_jax``)."""
    if quantized:
        np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wire", sorted(WIRES))
def test_on_host_tokens_never_cross_the_slow_wire(runs, wire):
    """``test_on_host_tokens_never_cross_dcn``'s twin, and the compressed
    crossing against the JAX package's: blocks from the receiving rank's
    own node are the lossless exchange's bits, off-node blocks changed,
    and every block is the JAX package's, bitwise."""
    ranks, jax_out = runs
    intra = 2
    changed = 0
    got_all = []
    for rank, r in enumerate(ranks):
        lossless = r["exchange"][1].numpy()
        got = r["wires"][wire].numpy()
        got_all.append(got)
        for src in range(WORLD):
            if src // intra == rank // intra:
                np.testing.assert_array_equal(got[src], lossless[src])
            else:
                changed += bool((got[src] != lossless[src]).any())
    assert changed > 0, f"the {wire} crossing changed no off-node block"
    _equal_to_compiled_jax(np.concatenate(got_all), jax_out["wires"][wire],
                           quantized=wire != "bf16")


def test_quantized_backward_is_the_compressed_crossing(runs):
    """The int8 crossing's backward is the same compressed crossing of
    the cotangents, straight-through (the JAX ``custom_vjp``): with the
    buffer itself as the dispatch's cotangent, the gradient is the JAX
    package's bitwise, and the own node's blocks, which never met the
    codebook, are the lossless exchange's."""
    ranks, jax_out = runs
    got = []
    for rank, r in enumerate(ranks):
        grad = r["int8_backward"].numpy()
        own = slice((rank // 2) * 2, (rank // 2) * 2 + 2)
        np.testing.assert_array_equal(grad[own],
                                      r["exchange"][1].numpy()[own])
        got.append(grad)
    _equal_to_compiled_jax(np.concatenate(got), jax_out["int8_backward"],
                           quantized=True)


def test_topk_two_stage_matches_flat_bitwise(runs):
    """``test_topk_two_stage_matches_flat_bitwise``'s twin."""
    ranks, _ = runs
    for r in ranks:
        flat, two = r["topk_two_stage"]
        assert torch.equal(two, flat)


def test_two_stage_guard_rail_and_hatch(runs):
    """``test_two_stage_on_flat_comm_is_loud`` and
    ``test_hierarchy_flat_hatch_drops_two_stage_with_warning``'s twins:
    ``two_stage=True`` on a communicator that was never hierarchical
    raises; on one the ``CHAINERMN_TPU_HIERARCHY=flat`` hatch flattened,
    it warns once and runs the flat dispatch, bitwise."""
    ranks, _ = runs
    for r in ranks:
        hierarchy, first, second, loud, dropped, again, flat = r["hatch"]
        # a rank is always inside its world: the port never routes densely
        # on a communicator
        assert all(r["axis_in_scope"])
        assert hierarchy is None
        assert len(first) == 1 and "two-stage MoE routing" in first[0]
        assert second == []
        assert loud is not None and "two_stage" in loud
        assert torch.equal(dropped, flat) and torch.equal(again, flat)


class _Comm:
    def __init__(self, hierarchy=None, hatch=False):
        self.hierarchy = hierarchy
        if hatch:
            self._hierarchy_flattened_by_env = True


def test_resolve_two_stage(monkeypatch):
    """The knob's table: None follows the topology, False is the explicit
    flat choice, True needs a hierarchy (or the hatch's mark)."""
    import chainermn_tpu_torch.communicators as comms
    from chainermn_tpu_torch.parallel.moe import _resolve_two_stage
    monkeypatch.setattr(comms, "_WARNED_FLAT_TWO_STAGE", set())
    hier = _Comm(("dcn", "ici"))
    assert _resolve_two_stage(hier, None) is True
    assert _resolve_two_stage(hier, False) is False
    assert _resolve_two_stage(_Comm(), None) is False
    with pytest.raises(ValueError, match="two_stage"):
        _resolve_two_stage(_Comm(), True)
    with pytest.warns(UserWarning, match="two-stage MoE routing"):
        assert _resolve_two_stage(_Comm(hatch=True), True) is False


def test_pure_functions_equal_jax():
    """``quantize_symmetric_segments`` (bitwise, every wire, an all-zero
    segment and non-finite values), ``hop_schedule("moe")`` and
    ``moe_dispatch_exchanged_bytes`` equal the JAX functions."""
    import jax.numpy as jnp
    from chainermn_tpu.communicators import _memory_utility as jmu
    from chainermn_tpu_torch.communicators import _memory_utility as mu
    v = np.random.RandomState(0).normal(0, 3, (3, 4, 5)).astype(np.float32)
    v[1] = 0
    v[2, 0, 0], v[2, 1, 1], v[2, 2, 2] = np.inf, -np.inf, np.nan
    for wire in ("int8", "float8_e4m3", "float8_e5m2"):
        q, s = mu.quantize_symmetric_segments(torch.from_numpy(v), wire)
        jq, js = jmu.quantize_symmetric_segments(jnp.asarray(v), wire)
        np.testing.assert_array_equal(q.float().numpy(),
                                      np.asarray(jq.astype(jnp.float32)))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for b in (0, 1, 3):
        assert mu.hop_schedule(b, mode="moe") == jmu.hop_schedule(b,
                                                                  mode="moe")
    for args in [(1 << 20, 2, 2), (12345, 4, 8), (4096, 1, 4)]:
        for two_stage in (True, False):
            for dcn in (None, 1 << 18):
                kw = dict(two_stage=two_stage, dcn_n_bytes=dcn)
                assert mu.moe_dispatch_exchanged_bytes(*args, **kw) \
                    == jmu.moe_dispatch_exchanged_bytes(*args, **kw)
    from chainermn_tpu.parallel.moe import moe_capacity
    from chainermn_tpu_torch.parallel.moe import moe_capacity as port
    for args in [(4096, 1, 1.25), (64, 4, 0.5), (3, 8, 1.0, 2)]:
        assert port(*args) == moe_capacity(*args)


@pytest.mark.parametrize("label,n", [("flat", 2), ("flat", 4),
                                     ("two_stage", 4), ("remat", 4)])
def test_moe_lm_dispatch_trajectory_matches_jax(runs, label, n):
    """The MoE LM from the JAX npz through the multi-node optimizer
    (Adam), 3 steps of the dispatch route on every rank against the JAX
    run on as many devices (``test_moe_vertical_convergence_parity``'s
    lossless legs, and remat's): the same losses and parameters; the
    lossless two-stage run is the flat one bitwise."""
    ranks, jax_out = runs
    want_losses, want_params = jax_out[(n, "lm")]
    for r in range(WORLD if n == 4 else 2):
        losses, params, calls = ranks[r][(n, "lm", label)]
        np.testing.assert_allclose(losses, want_losses, **JAX_TOL)
        _close_params(params, want_params, JAX_TOL)
        assert (calls.get("moe_ici_dispatch", 0) > 0) \
            == (label == "two_stage")
        if label == "two_stage":
            flat = ranks[r][(4, "lm", "flat")]
            assert losses == flat[0]
            assert all(torch.equal(params[p], flat[1][p]) for p in params)
    assert want_losses[-1] < want_losses[0]


@pytest.mark.parametrize("wire", ["int8", "bf16"])
def test_moe_lm_compressed_dispatch_within_band(runs, wire):
    """``test_moe_vertical_convergence_parity``'s compressed legs: the
    int8 and bf16 inter-node crossings train within 5 % of the lossless
    run's last loss."""
    ranks, _ = runs
    for r in ranks:
        quant = r[(4, "lm", wire)][0]
        lossless = r[(4, "lm", "flat")][0]
        assert np.isfinite(quant).all()
        assert abs(quant[-1] - lossless[-1]) <= 0.05 * lossless[-1]
        assert r[(4, "lm", wire)][2]["moe_ici_dispatch"] > 0


def _dense_run(npz, **kw):
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.models import MoETransformerLM
    from chainermn_tpu_torch.serializers import load_npz
    model = MoETransformerLM(DENSE_LM["n_vocab"], WORLD, d_model=16,
                             n_heads=2, n_layers=2, seed=12, device="cpu",
                             **kw)
    load_npz(npz, model)
    opt = Adam(alpha=LM_ALPHA).setup(model)
    x, t = (torch.from_numpy(a) for a in _dense_tokens())
    losses = [opt.update(model, x, t).item() for _ in range(LM_STEPS)]
    return losses, _params_of(model)


@pytest.mark.parametrize("remat", [False, True, "dots"])
def test_moe_lm_dense_route_trajectory_matches_jax(runs, remat):
    """The dense route (``ep_comm`` an expert count: the JAX package's
    single-device MoE training, ``test_moe_transformer_trains`` and
    ``test_moe_transformer_remat_and_bf16``'s twins): 3 Adam steps from
    the JAX npz give the JAX losses and parameters, with remat and
    without."""
    _, jax_out = runs
    want_losses, want_params = jax_out[("dense", "fp32")]
    losses, params = _dense_run(jax_out["dense_npz"], remat=remat)
    np.testing.assert_allclose(losses, want_losses, **JAX_TOL)
    _close_params(params, want_params, JAX_TOL)
    assert want_losses[-1] < want_losses[0]


def test_moe_lm_bf16_tracks_jax(runs):
    """bf16 compute with remat: parameters stay fp32, the losses track
    the JAX bf16 run's in the bf16 band, and the dispatch run in bf16
    learns."""
    ranks, jax_out = runs
    want = jax_out[("dense", "bf16")][0]
    losses, params = _dense_run(jax_out["dense_npz"],
                                compute_dtype=torch.bfloat16,
                                remat=True)
    np.testing.assert_allclose(losses, want, rtol=5e-2)
    assert all(a.dtype == torch.float32 for a in params.values())
    for r in ranks:
        lb = r["bf16_dispatch"]
        assert np.isfinite(lb).all() and lb[-1] < lb[0]


def test_dense_route_equals_dispatch_at_generous_capacity(runs):
    """``test_moe_transformer_dense_vs_expert_parallel``'s twin: with
    every rank routing the whole batch at capacity factor E, the dispatch
    LM's loss is the dense route's."""
    ranks, _ = runs
    for r in ranks:
        ep_loss, dense_loss = r["dense_vs_ep"]
        assert ep_loss == pytest.approx(dense_loss, rel=1e-5)


def test_moe_npz_paths_are_the_jax_ones(runs):
    """The raw parameters' npz keys (``blocks/<i>/moe/w_in``, ...) are the
    JAX model's: its snapshot loads key for key, shapes and all."""
    from chainermn_tpu_torch import Parameter
    from chainermn_tpu_torch.models import MoETransformerLM
    keys = set(np.load(runs[1]["dense_npz"]).files)
    model = MoETransformerLM(DENSE_LM["n_vocab"], WORLD, d_model=16,
                             n_heads=2, n_layers=2, seed=12, device="cpu")
    ours = {p.lstrip("/") for p, _ in model.namedparams()}
    assert {k for k in keys if "/moe/" in k} == \
        {k for k in ours if "/moe/" in k}
    assert {"blocks/0/moe/router", "blocks/1/moe/w_out"} <= keys
    assert isinstance(model.blocks[0].moe.w_in, Parameter)
