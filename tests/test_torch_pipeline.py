"""The port's pipelines, channel-parallel convolution and mesh helpers
against the JAX package, in a 2-rank and a 4-rank gloo world.

Twins of ``tests/parallel_tests/test_pipeline.py`` (GPipe: the sequential
stack's outputs and gradients, remat, split/merge, the mesh),
``tests/parallel_tests/test_one_f_one_b.py`` (1F1B: the sequential
stack's mean loss and stage gradients, one microbatch, a training step
that converges, heterogeneous stages, stages singular at zero, for both
schedules) and ``tests/links_tests/test_parallel_convolution.py``, run at
S = 2 and S = 4 stage ranks: each rank feeds its own stage's slice of the
stacked ``[S, ...]`` parameters, as the JAX test's ``P("pipe")`` shards
them.  The references are the JAX tests' own (``jax.grad`` of the
sequential stack), computed in this process; the workers import no JAX.
A hybrid data x model step (after ``tests/parallel_tests/test_hybrid.py``,
whose layers are A9's): a 1 x 2 mesh of 2 ranks and a 2 x 2 mesh of 4, a
two-stage ``MultiNodeChainList`` over each ``model`` line and the
multi-node Adam over each ``data`` line, against one process on the
whole batch.

Tolerances: the JAX tests' own (rtol 1e-4 / atol 1e-5 on gradients, rtol
1e-5 on losses and outputs, 1e-4 on the convolution), across the two
frameworks; remat against no remat, rtol 1e-5 / atol 1e-6 (the same
operations recomputed); the hybrid step against one process, 1e-5
absolute (a two-rank mean of the half-batch gradients instead of one
full-batch sum, then Adam).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_communicator import spawn_ranks

WORLDS = (2, 4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-5
HYBRID_TOL = dict(rtol=0, atol=1e-5)
ACTS = ["relu", "gelu", "tanh", "identity"]


def _params(S, seed):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 0.5, (S, 8, 8)).astype(np.float32),
            rng.normal(0, 0.1, (S, 8)).astype(np.float32))


def _normal(seed, *shapes, scale=(1.0, 1.0)):
    rng = np.random.RandomState(seed)
    return [rng.normal(0, s, shape).astype(np.float32)
            for shape, s in zip(shapes, scale)]


# -- worker (runs in the spawned ranks) ------------------------------------------

def _stage_fn(params, h):
    W, b = params
    return torch.tanh(h @ W + b)


def _singular_stage_fn(params, h):
    W, b = params
    return torch.tanh(torch.sqrt(h * h) @ W + b)


def _loss_fn(out, y):
    return torch.mean((out - y) ** 2)


def _act(name):
    from chainermn_tpu_torch import F
    return {"relu": F.relu, "gelu": F.gelu, "tanh": torch.tanh,
            "identity": lambda h: h}[name]


def _mine(rank, W, b, grad=False):
    Wl = torch.from_numpy(W[rank].copy()).requires_grad_(grad)
    bl = torch.from_numpy(b[rank].copy()).requires_grad_(grad)
    return Wl, bl


def _pipelines(comm, rank):
    from chainermn_tpu_torch.core.optimizer import SGD
    from chainermn_tpu_torch.parallel import (gpipe_apply,
                                              heterogeneous_stage_fn,
                                              make_pipeline_train_step,
                                              one_f_one_b,
                                              split_microbatches)
    S = comm.size
    out = {}
    t = torch.from_numpy

    W, b = _params(S, 0)
    (x,) = _normal(1, (16, 8))
    out["gpipe_forward"] = gpipe_apply(comm, _stage_fn, _mine(rank, W, b),
                                       split_microbatches(t(x), 4))

    for remat in (False, True):
        W, b = _params(S, 2)
        (x,) = _normal(3, (8, 8))
        Wl, bl = _mine(rank, W, b, grad=True)
        y = gpipe_apply(comm, _stage_fn, (Wl, bl),
                        split_microbatches(t(x), 2), remat=remat)
        (y ** 2).sum().backward()
        out[f"gpipe_grad_remat{remat}"] = (Wl.grad, bl.grad)

    W, b = _params(S, 0)
    xs, ys = _normal(1, (24, 8), (24, 8))
    loss, grads = one_f_one_b(comm, _stage_fn, _loss_fn, _mine(rank, W, b),
                              split_microbatches(t(xs), 6),
                              split_microbatches(t(ys), 6))
    out["1f1b"] = (loss, grads)

    W, b = _params(S, 2)
    xs, ys = _normal(3, (1, 4, 8), (1, 4, 8))
    out["1f1b_single"] = one_f_one_b(comm, _stage_fn, _loss_fn,
                                     _mine(rank, W, b), t(xs), t(ys))[0]

    W, b = _params(S, 5)
    xs, ys = _normal(7, (16, 8), (16, 8), scale=(1.0, 0.3))
    Wl, bl = _mine(rank, W, b)
    step = make_pipeline_train_step(comm, _stage_fn, _loss_fn, SGD(lr=0.2),
                                    n_microbatches=4)
    out["train_step"] = [float(step((Wl, bl), t(xs), t(ys)))
                         for _ in range(20)]

    fns = [(lambda act: lambda p, h: act(h @ p[0] + p[1]))(
        _act(ACTS[s % len(ACTS)])) for s in range(S)]
    W, b = _params(S, 7)
    xs, ys = _normal(8, (16, 8), (16, 8))
    out["1f1b_heterogeneous"] = one_f_one_b(
        comm, heterogeneous_stage_fn(fns, comm), _loss_fn,
        _mine(rank, W, b), split_microbatches(t(xs), 4),
        split_microbatches(t(ys), 4))

    W, b = _params(S, 4)
    xs, ys = _normal(5, (20, 8), (20, 8))
    out["1f1b_singular"] = one_f_one_b(
        comm, _singular_stage_fn, _loss_fn, _mine(rank, W, b),
        split_microbatches(t(xs), 5), split_microbatches(t(ys), 5))

    W, b = _params(S, 6)
    xs, ys = _normal(7, (16, 8), (16, 8))
    Wl, bl = _mine(rank, W, b, grad=True)
    y = gpipe_apply(comm, _singular_stage_fn, (Wl, bl),
                    split_microbatches(t(xs), 4))
    loss = torch.mean((y - split_microbatches(t(ys), 4)) ** 2)
    loss.backward()
    out["gpipe_singular"] = (loss.detach(), [Wl.grad, bl.grad])
    return out


def _parallel_conv(comm, rank):
    from chainermn_tpu_torch import F
    from chainermn_tpu_torch.core.link import Chain
    from chainermn_tpu_torch.core.optimizer import SGD
    from chainermn_tpu_torch.links import ParallelConvolution2D
    out = {}
    (x,) = _normal(0, (2, 3, 8, 8))
    conv = ParallelConvolution2D(comm, 3, 16, 3, pad=1, seed=0,
                                 device="cpu")
    out["conv_forward"] = (conv(torch.from_numpy(x)).detach(),
                           conv.W.detach().clone(), conv.b.detach().clone())
    (x,) = _normal(1, (2, 3, 8, 8))
    conv = ParallelConvolution2D(comm, 3, 16, 3, pad=1, seed=1,
                                 device="cpu")
    (conv(torch.from_numpy(x)) ** 2).sum().backward()
    out["conv_grad"] = (conv.W.grad, conv.b.grad)

    class Net(Chain):
        def __init__(self):
            super().__init__()
            self.conv = ParallelConvolution2D(comm, 3, 8, 3, pad=1, seed=2,
                                              device="cpu")

        def forward(self, x, t):
            return F.softmax_cross_entropy(self.conv(x).mean(dim=(2, 3)), t)

    net = Net()
    opt = SGD(lr=0.1).setup(net)
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.normal(0, 1, (8, 3, 8, 8)).astype(np.float32))
    t = torch.from_numpy(rng.randint(0, 8, 8).astype(np.int64))
    out["conv_trains"] = [opt.update(net, x, t).item() for _ in range(10)]
    try:
        ParallelConvolution2D(comm, 3, 10 * comm.size + 1, 3, device="cpu")
    except ValueError as e:
        out["conv_divisible"] = str(e)
    return out


def _hybrid_stages():
    from chainermn_tpu_torch import F, L
    from chainermn_tpu_torch.core.link import Chain

    class Front(Chain):
        def __init__(self):
            super().__init__()
            self.l1 = L.Linear(6, 8, seed=40, device="cpu")

        def forward(self, x, t):
            return F.relu(self.l1(x))

    class Back(Chain):
        def __init__(self):
            super().__init__()
            self.l2 = L.Linear(8, 3, seed=41, device="cpu")

        def forward(self, h, x, t):
            return F.softmax_cross_entropy(self.l2(h), t)

    return Front, Back


def _hybrid_model(model_comm):
    from chainermn_tpu_torch.links import MultiNodeChainList
    Front, Back = _hybrid_stages()
    m = MultiNodeChainList(model_comm)
    m.add_link(Front(), rank_in=None, rank_out=1, rank=0)
    m.add_link(Back(), rank_in=0, rank_out=None, rank=1, pass_inputs=True)
    return m


def _hybrid_data():
    rng = np.random.RandomState(42)
    return (rng.normal(0, 1, (8, 6)).astype(np.float32),
            rng.randint(0, 3, 8).astype(np.int64))


def _hybrid(comm, rank):
    """A (size / 2) x 2 mesh: ``model`` lines run the two stages,
    ``data`` lines exchange the gradients of the stage they own."""
    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.parallel import (axis_communicators, make_mesh,
                                              replicate, shard_batch)
    mesh = make_mesh({"data": comm.size // 2, "model": -1}, comm)
    comms = axis_communicators(mesh)
    out = {"mesh": (mesh.ranks.tolist(), mesh.coords(),
                    {k: (c.size, c.rank) for k, c in comms.items()})}
    model = _hybrid_model(comms["model"])
    opt = create_multi_node_optimizer(Adam(), comms["data"]).setup(model)
    x, t = _hybrid_data()
    x = shard_batch(torch.from_numpy(x), mesh, "data")
    t = replicate(shard_batch(torch.from_numpy(t), mesh, "data"), mesh)
    out["losses"] = [opt.update(model, x, t).item() for _ in range(3)]
    out["params"] = {p: v.detach().clone() for p, v in model.namedparams()}
    out["leaves"] = [tuple(s) for s in
                     comms["data"].grad_leaf_specs(model)[0]]
    for c in comms.values():     # waits for the sends still in flight
        c.finalize()
    return out


def _worker(rank):
    from chainermn_tpu_torch import create_communicator
    comm = create_communicator("jax_ici", device="cpu")
    out = {"pipelines": _pipelines(comm, rank),
           "conv": _parallel_conv(comm, rank)}
    out["hybrid"] = _hybrid(comm, rank)
    comm.finalize()
    return out


# -- the references (this process) ----------------------------------------------

@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"S{w}")
def world(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"pipeline{request.param}")
    return request.param, spawn_ranks(tmp, _worker, world=request.param)


def _jax_stage(params, h):
    import jax.numpy as jnp
    W, b = params
    return jnp.tanh(h @ W + b)


def _jax_singular(params, h):
    import jax.numpy as jnp
    W, b = params
    return jnp.tanh(jnp.sqrt(h * h) @ W + b)


def _jax_sequential_loss(stage_fns, W, b, xm, ym):
    """The JAX tests' reference: the mean over microbatches of the
    per-microbatch loss of the sequential stack, and its gradient."""
    import jax
    import jax.numpy as jnp

    def ref_loss(params):
        W, b = params
        total = 0.0
        for i in range(xm.shape[0]):
            h = xm[i]
            for s, fn in enumerate(stage_fns):
                h = fn((W[s], b[s]), h)
            total = total + jnp.mean((h - ym[i]) ** 2)
        return total / xm.shape[0]
    return jax.value_and_grad(ref_loss)((jnp.asarray(W), jnp.asarray(b)))


def _check_stage_grads(ranks, got_key, gW_ref, gb_ref, tol=GRAD_TOL):
    for s, r in enumerate(ranks):
        gW, gb = r["pipelines"][got_key] if not isinstance(
            r["pipelines"][got_key][1], list) else r["pipelines"][got_key][1]
        np.testing.assert_allclose(np.asarray(gW), np.asarray(gW_ref[s]),
                                   **tol)
        np.testing.assert_allclose(np.asarray(gb), np.asarray(gb_ref[s]),
                                   **tol)


def test_gpipe_matches_sequential_stack(world):
    import jax.numpy as jnp
    S, ranks = world
    W, b = _params(S, 0)
    (x,) = _normal(1, (16, 8))
    h = jnp.asarray(x)
    for s in range(S):
        h = _jax_stage((jnp.asarray(W[s]), jnp.asarray(b[s])), h)
    for r in ranks:
        got = r["pipelines"]["gpipe_forward"].reshape(16, 8)
        np.testing.assert_allclose(got.numpy(), np.asarray(h), **OUT_TOL)


def test_gpipe_differentiable(world):
    import jax
    import jax.numpy as jnp
    S, ranks = world
    W, b = _params(S, 2)
    (x,) = _normal(3, (8, 8))

    def ref_loss(args):
        W, b = args
        h = jnp.asarray(x)
        for s in range(S):
            h = _jax_stage((W[s], b[s]), h)
        return jnp.sum(h ** 2)

    rW, rb = jax.grad(ref_loss)((jnp.asarray(W), jnp.asarray(b)))
    _check_stage_grads(ranks, "gpipe_grad_rematFalse", rW, rb)


def test_gpipe_remat_matches_no_remat(world):
    _, ranks = world
    for r in ranks:
        for a, b in zip(r["pipelines"]["gpipe_grad_rematFalse"],
                        r["pipelines"]["gpipe_grad_rematTrue"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **OUT_TOL)


def test_split_merge_roundtrip():
    from chainermn_tpu_torch.parallel import (merge_microbatches,
                                              split_microbatches)
    x = torch.arange(24.0).reshape(12, 2)
    m = split_microbatches(x, 3)
    assert m.shape == (3, 4, 2)
    assert torch.equal(merge_microbatches(m), x)
    with pytest.raises(ValueError, match="divisible"):
        split_microbatches(x, 5)


def test_1f1b_matches_sequential_gradients(world):
    S, ranks = world
    W, b = _params(S, 0)
    xs, ys = _normal(1, (24, 8), (24, 8))
    l_ref, (gW, gb) = _jax_sequential_loss(
        [_jax_stage] * S, W, b, xs.reshape(6, 4, 8), ys.reshape(6, 4, 8))
    for r in ranks:
        np.testing.assert_allclose(float(r["pipelines"]["1f1b"][0]),
                                   float(l_ref), rtol=LOSS_RTOL)
    _check_stage_grads(ranks, "1f1b", gW, gb)


def test_1f1b_single_microbatch(world):
    import jax.numpy as jnp
    S, ranks = world
    W, b = _params(S, 2)
    xs, ys = _normal(3, (1, 4, 8), (1, 4, 8))
    h = jnp.asarray(xs[0])
    for s in range(S):
        h = _jax_stage((jnp.asarray(W[s]), jnp.asarray(b[s])), h)
    want = float(jnp.mean((h - ys[0]) ** 2))
    for r in ranks:
        np.testing.assert_allclose(float(r["pipelines"]["1f1b_single"]),
                                   want, rtol=LOSS_RTOL)


def test_pipeline_train_step_converges(world):
    _, ranks = world
    for r in ranks:
        losses = r["pipelines"]["train_step"]
        assert losses[-1] < losses[0] * 0.7
    assert all(r["pipelines"]["train_step"]
               == ranks[0]["pipelines"]["train_step"] for r in ranks)


def test_1f1b_heterogeneous_stages_match_sequential(world):
    import jax
    import jax.numpy as jnp
    S, ranks = world
    acts = {"relu": jax.nn.relu, "gelu": jax.nn.gelu, "tanh": jnp.tanh,
            "identity": lambda h: h}
    fns = [(lambda act: lambda p, h: act(h @ p[0] + p[1]))(
        acts[ACTS[s % len(ACTS)]]) for s in range(S)]
    W, b = _params(S, 7)
    xs, ys = _normal(8, (16, 8), (16, 8))
    l_ref, (gW, gb) = _jax_sequential_loss(
        fns, W, b, xs.reshape(4, 4, 8), ys.reshape(4, 4, 8))
    for r in ranks:
        np.testing.assert_allclose(
            float(r["pipelines"]["1f1b_heterogeneous"][0]), float(l_ref),
            rtol=LOSS_RTOL)
    _check_stage_grads(ranks, "1f1b_heterogeneous", gW, gb)


def test_1f1b_zero_singular_stage_grads_finite_and_match(world):
    S, ranks = world
    W, b = _params(S, 4)
    xs, ys = _normal(5, (20, 8), (20, 8))
    l_ref, (gW, gb) = _jax_sequential_loss(
        [_jax_singular] * S, W, b, xs.reshape(5, 4, 8), ys.reshape(5, 4, 8))
    for r in ranks:
        loss, grads = r["pipelines"]["1f1b_singular"]
        assert np.isfinite(float(loss))
        assert all(torch.isfinite(g).all() for g in grads)
        np.testing.assert_allclose(float(loss), float(l_ref), rtol=LOSS_RTOL)
    _check_stage_grads(ranks, "1f1b_singular", gW, gb)


def test_gpipe_zero_singular_stage_grads_finite(world):
    S, ranks = world
    W, b = _params(S, 6)
    xs, ys = _normal(7, (16, 8), (16, 8))
    l_ref, (gW, gb) = _jax_sequential_loss(
        [_jax_singular] * S, W, b, xs.reshape(4, 4, 8), ys.reshape(4, 4, 8))
    for r in ranks:
        loss, grads = r["pipelines"]["gpipe_singular"]
        assert all(torch.isfinite(g).all() for g in grads)
        np.testing.assert_allclose(float(loss), float(l_ref), rtol=LOSS_RTOL)
    _check_stage_grads(ranks, "gpipe_singular", gW, gb)


# -- channel-parallel convolution ------------------------------------------------

def test_parallel_conv_forward_matches_dense(world):
    import jax.numpy as jnp
    from chainermn_tpu import F as JF
    _, ranks = world
    (x,) = _normal(0, (2, 3, 8, 8))
    for r in ranks:
        y, W, b = r["conv"]["conv_forward"]
        want = JF.convolution_2d(jnp.asarray(x), jnp.asarray(W.numpy()),
                                 jnp.asarray(b.numpy()), 1, 1)
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    # the bank is the JAX link's, from the same seed
    from chainermn_tpu.links.parallel_convolution import \
        ParallelConvolution2D as JConv
    import chainermn_tpu as jct
    jconv = JConv(jct.create_communicator("jax_ici", axis_name="tp"), 3, 16,
                  3, pad=1, seed=0)
    np.testing.assert_array_equal(ranks[0]["conv"]["conv_forward"][1],
                                  np.asarray(jconv.W.array))


def test_parallel_conv_gradients_match_dense(world):
    import jax
    import jax.numpy as jnp
    from chainermn_tpu import F as JF
    from chainermn_tpu_torch.nn import initializers as I
    _, ranks = world
    (x,) = _normal(1, (2, 3, 8, 8))
    # the bank of ParallelConvolution2D(..., seed=1): He normal, zero bias
    W0 = jnp.asarray(I.HeNormal()((16, 3, 3, 3), np.float32,
                                  np.random.RandomState(1)))
    b0 = jnp.zeros((16,), jnp.float32)
    rW, rb = jax.grad(lambda a: jnp.sum(JF.convolution_2d(
        jnp.asarray(x), a[0], a[1], 1, 1) ** 2))((W0, b0))
    for r in ranks:
        gW, gb = r["conv"]["conv_grad"]
        np.testing.assert_allclose(gW.numpy(), np.asarray(rW), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=1e-4,
                                   atol=1e-4)


def test_parallel_conv_trains_under_optimizer(world):
    _, ranks = world
    for r in ranks:
        losses = r["conv"]["conv_trains"]
        assert losses[-1] < losses[0]
    assert ranks[0]["conv"]["conv_trains"] == ranks[-1]["conv"]["conv_trains"]


def test_parallel_conv_divisibility_check(world):
    _, ranks = world
    for r in ranks:
        assert "divisible" in r["conv"]["conv_divisible"]


# -- the mesh and the hybrid step -------------------------------------------------

def _hybrid_ranks(world):
    S, ranks = world
    if S != 4:
        pytest.skip("the 2 x 2 mesh needs the 4-rank world")
    return ranks


def test_make_mesh_and_axis_communicators(world):
    """``make_mesh({"data": S / 2, "model": -1})``: rank ``r`` at
    ``divmod(r, 2)``; the ``data`` line of a rank is its column, the
    ``model`` line its row (a 1 x 2 mesh on 2 ranks, 2 x 2 on 4)."""
    S, ranks = world
    for rank, r in enumerate(ranks):
        layout, coords, comms = r["hybrid"]["mesh"]
        assert layout == np.arange(S).reshape(S // 2, 2).tolist()
        assert coords == {"data": rank // 2, "model": rank % 2}
        assert comms == {"data": (S // 2, rank // 2),
                         "model": (2, rank % 2)}


def test_hybrid_data_model_step_matches_single_process(world):
    """Two stages on each ``model`` line, the batch split over ``data``
    (one line on 2 ranks, two on 4): 3 Adam steps equal one process's on
    the whole batch (losses on every rank, each stage's parameters on its
    owners), and the data exchange carries only the owned stage's
    leaves."""
    S, ranks = world
    from chainermn_tpu_torch.core.link import Chain
    from chainermn_tpu_torch.core.optimizer import Adam
    Front, Back = _hybrid_stages()

    class Whole(Chain):
        def __init__(self):
            super().__init__()
            self.front, self.back = Front(), Back()

        def forward(self, x, t):
            return self.back(self.front(x, t), x, t)

    model = Whole()
    opt = Adam().setup(model)
    x, t = _hybrid_data()
    losses = [opt.update(model, torch.from_numpy(x),
                         torch.from_numpy(t)).item() for _ in range(3)]
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["hybrid"]["losses"], losses,
                                   **HYBRID_TOL)
        stage = rank % 2
        path, ref = (("/mn_component_0/l1/W", model.front.l1.W)
                     if stage == 0 else
                     ("/mn_component_1/l2/W", model.back.l2.W))
        np.testing.assert_allclose(r["hybrid"]["params"][path],
                                   ref.detach(), **HYBRID_TOL)
        # sorted paths: W before b
        assert r["hybrid"]["leaves"] == ([(8, 6), (8,)] if stage == 0
                                         else [(3, 8), (3,)])
