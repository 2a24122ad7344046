"""Model parallelism in the port against the JAX package, in one 2-rank
gloo world: the differentiable point-to-point functions, the
``MultiNodeChainList`` topology zoo, the model-parallel MNIST MLP and
seq2seq (BASELINE config #4).

The port's transfers are MPMD (each rank runs its own graph, the
reference's ``Send``/``Recv`` with delegates); the JAX package's are one
SPMD program.  The twins of ``tests/functions_tests/
test_point_to_point_communication.py`` and ``tests/links_tests/
test_multi_node_chain_list.py`` therefore place the JAX tests' stages on
two ranks (a stage list ``[0, 1, 0]`` makes an edge back to rank 0, and
edges from a rank to itself are local hand-offs), and hold outputs and
gradients against a single-process stack of the same links.  The
model-parallel seq2seq (encoder on rank 0, decoder on rank 1) runs 3
Adam steps from the JAX ``Seq2seq``'s npz snapshot and is held against
the JAX single-process ``Seq2seq``'s 3 steps (its own JAX twin, the mesh
version, is slow-marked), each component's parameters on its owner.

The workers import no JAX (spawned ranks import this module); the JAX
references run in the test process.

Tolerances: single-process port stacks against the chain list, rtol
1e-5 / atol 1e-6 (the same fp32 operations; a broadcast and a mean of
two identical gradients, exact, in between); the port against JAX, 2e-5
absolute on losses and parameters after 3 Adam steps (two frameworks'
fp32 GEMM and recurrence orders, through Adam's normalization); greedy
tokens exactly.
"""


import numpy as np
import pytest
import torch

from tests.test_torch_communicator import spawn_ranks

WORLD = 2
CHAIN_TOL = dict(rtol=1e-5, atol=1e-6)
JAX_TOL = dict(rtol=0, atol=2e-5)
STEPS = 3
#: the tiny seq2seq: vocabularies of 40 (the synthetic data's), 16 units,
#: 2 layers, 8 sentences of up to 12 tokens
S2S = dict(n_source_vocab=40, n_target_vocab=40, n_units=16, n_layers=2,
           seed=0)
N_SENT = 8


def _blocks():
    from chainermn_tpu_torch import F, L
    from chainermn_tpu_torch.core.link import Chain

    class Block(Chain):
        def __init__(self, n_in, n_out, seed):
            super().__init__()
            self.l = L.Linear(n_in, n_out, seed=seed, device="cpu")

        def forward(self, x):
            return F.relu(self.l(x))

    class Merge(Chain):
        def __init__(self, n_in, n_out, seed):
            super().__init__()
            self.l = L.Linear(n_in, n_out, seed=seed, device="cpu")

        def forward(self, *xs):
            return self.l(torch.cat(xs, dim=1))

    return Block, Merge


def _x(seed, shape):
    return torch.from_numpy(np.random.RandomState(seed).normal(
        0, 1, shape).astype(np.float32))


def _grads(link):
    return {p: None if v.grad is None else v.grad.clone()
            for p, v in link.namedparams()}


def _params(link):
    return {p: v.detach().clone() for p, v in link.namedparams()}


# -- worker (runs in the spawned ranks) ------------------------------------------

def _p2p(comm, rank):
    from chainermn_tpu_torch import functions as mnfn
    out = {}
    x = torch.arange(2 * WORLD, dtype=torch.float32).reshape(WORLD, 2)[rank]
    out["p2p_forward"] = mnfn.point_to_point(x, comm, src=1, dst=0)
    xg = x.clone().requires_grad_()
    (mnfn.point_to_point(xg, comm, src=1, dst=0) * 3.0).sum().backward()
    out["p2p_grad"] = xg.grad
    xs = xg.detach().clone().requires_grad_()
    (mnfn.point_to_point(xs, comm, src=rank, dst=rank) * 2.0).sum().backward()
    out["p2p_self"] = xs.grad

    # send/recv with a delegate: rank 0 sends 2x, rank 1's loss is sum y^2
    x0 = torch.tensor([1.5, -2.0], requires_grad=True)
    if rank == 0:
        d = mnfn.send(x0 * 2.0, comm, 1)
        assert d.dim() == 0 and float(d.detach()) == 0.0
        d.backward()
        out["sendrecv_grad"] = x0.grad
    else:
        y = mnfn.recv(comm, 0)
        out["sendrecv_value"] = y.detach()
        (y * y).sum().backward()

    # pseudo_connect: rank 1 does not use y; the edge stays on the backward
    xp = x.clone().requires_grad_()
    if rank == 0:
        d = mnfn.send(xp, comm, 1)
        fused = mnfn.pseudo_connect(d, xp.sum())
        fused.backward()
    else:
        y = mnfn.recv(comm, 0)
        (xp.sum() + y.sum() * 0.0).backward()
    out["pseudo_connect_grad"] = xp.grad

    # a self-edge recv with no send before it
    try:
        mnfn.recv(comm, rank)
        out["recv_without_send"] = None
    except RuntimeError as e:
        out["recv_without_send"] = str(e)

    # two transfers on one pair, received in the order sent by tag
    if rank == 0:
        mnfn.send(torch.tensor([1.0]), comm, 1, tag=0)
        mnfn.send(torch.tensor([2.0, 3.0]), comm, 1, tag=1)
    else:
        out["tags"] = (mnfn.recv(comm, 0, tag=0), mnfn.recv(comm, 0, tag=1))
    return out


def _chain_lists(comm, rank):
    from chainermn_tpu_torch import F, L
    from chainermn_tpu_torch.core.link import Chain
    from chainermn_tpu_torch.core.optimizer import SGD
    from chainermn_tpu_torch.links import MultiNodeChainList
    Block, Merge = _blocks()
    out = {}

    def pipeline():
        m = MultiNodeChainList(comm)
        m.add_link(Block(4, 8, 1), rank_in=None, rank_out=1, rank=0)
        m.add_link(Block(8, 6, 2), rank_in=0, rank_out=0, rank=1)
        m.add_link(Block(6, 2, 3), rank_in=1, rank_out=None, rank=0)
        return m

    m = pipeline()
    x = _x(1, (5, 4))
    y = m(x)
    (y ** 2).sum().backward()
    out["straight"] = (y.detach(), _grads(m))

    # rank 0 fans out to rank 1 and to itself; rank 1 merges both
    m = MultiNodeChainList(comm)
    m.add_link(Block(4, 6, 10), rank_in=None, rank_out=[1, 0], rank=0)
    m.add_link(Block(6, 5, 11), rank_in=0, rank_out=1, rank=1)
    m.add_link(Block(6, 5, 12), rank_in=0, rank_out=1, rank=0)
    m.add_link(Merge(10, 2, 13), rank_in=[1, 0], rank_out=None, rank=1)
    y = m(_x(2, (3, 4)))
    y.sum().backward()
    out["branching"] = (y.detach(), _grads(m))

    class PipelineRegressor(Chain):
        def __init__(self):
            super().__init__()
            self.pipe = pipeline()

        def forward(self, x, t):
            return ((self.pipe(x) - t) ** 2).mean()

    model = PipelineRegressor()
    opt = SGD(lr=0.05).setup(model)
    xt, tt = _x(3, (8, 4)), _x(4, (8, 2))
    out["trains"] = [opt.update(model, xt, tt).item() for _ in range(20)]
    out["trains_params"] = _params(model)

    class BNStage(Chain):
        def __init__(self):
            super().__init__()
            self.bn = L.BatchNormalization(6, device="cpu")
            self.l = L.Linear(6, 2, seed=21, device="cpu")

        def forward(self, x):
            return self.l(self.bn(x))

    m = MultiNodeChainList(comm)
    m.add_link(Block(4, 6, 20), rank_in=None, rank_out=1, rank=0)
    m.add_link(BNStage(), rank_in=0, rank_out=None, rank=1)
    xb = _x(5, (16, 4)) + 3.0
    m(xb)
    out["bn"] = m.mn_component_1.bn.avg_mean.clone()

    errors = []
    m = MultiNodeChainList(comm)
    m.add_link(Block(4, 4, 1), rank_in=None, rank_out=1, rank=0)
    m2 = MultiNodeChainList(comm)
    m2.add_link(Block(4, 4, 1), rank_in=None, rank_out=None, rank=0)
    m2.add_link(Block(4, 4, 2), rank_in=None, rank_out=None, rank=1)
    for model in (m, m2):
        try:
            model(torch.ones(2, 4))
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors

    # two edges 0 -> 1 with a self-edge 1 -> 1 between them
    m = MultiNodeChainList(comm)
    m.add_link(Block(4, 4, 11), rank_in=None, rank_out=1, rank=0)
    m.add_link(Block(4, 4, 13), rank_in=None, rank_out=1, rank=1)
    m.add_link(Block(4, 4, 12), rank_in=None, rank_out=1, rank=0)
    m.add_link(Merge(12, 3, 14), rank_in=[0, 1, 0], rank_out=None, rank=1)
    y = m(_x(7, (5, 4)))
    y.sum().backward()
    out["interleaved"] = (y.detach(), _grads(m))

    m = MultiNodeChainList(comm)
    m.add_link(Block(4, 4, 21), rank_in=None, rank_out=1, rank=0)
    m.add_link(Block(4, 4, 22), rank_in=None, rank_out=1, rank=0)
    m.add_link(Merge(8, 2, 23), rank_in=[0, 0], rank_out=None, rank=1)
    out["parallel_pipelines"] = m(_x(8, (3, 4))).detach()
    return out


def _split_mlp(comm, rank):
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.examples.train_mnist_model_parallel import \
        SplitMLP
    model = SplitMLP(comm, 10, 10, seed=0, device="cpu")
    opt = Adam().setup(model)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.normal(0, 1, (16, 784)).astype(np.float32))
    t = torch.from_numpy(rng.randint(0, 10, 16).astype(np.int64))
    losses = [opt.update(model, x, t).item() for _ in range(STEPS)]
    return {"losses": losses, "params": _params(model),
            "owned": sorted(p for p, v in model.namedparams()
                            if not getattr(v, "_mn_not_owned", False))}


def _seq2seq(comm, rank, jax_npz, batch):
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.models import ModelParallelSeq2seq
    from chainermn_tpu_torch.serializers import load_params
    xs, ys_in, ys_out = (torch.from_numpy(a) for a in batch)
    out = {}
    for label, ranks in (("split", (0, 1)), ("self_edge", (0, 0))):
        model = ModelParallelSeq2seq(comm, rank_encoder=ranks[0],
                                     rank_decoder=ranks[1], device="cpu",
                                     **S2S)
        with np.load(jax_npz) as npz:
            load_params(model, {_mp_path(k): npz[k] for k in npz.files})
        opt = Adam().setup(model)
        losses = [opt.update(model, xs, ys_in, ys_out).item()
                  for _ in range(STEPS)]
        out[label] = {"losses": losses, "params": _params(model),
                      "calls": dict(comm.calls)}
    return out


def _mp_path(jax_path):
    """A ``Seq2seq`` parameter path (or npz key) as
    ``ModelParallelSeq2seq``'s."""
    path = "/" + jax_path.lstrip("/")
    if path.startswith("/encoder/"):
        return "/mn_component_0" + path
    return "/mn_component_1" + path


def _worker(rank, jax_npz, batch):
    from chainermn_tpu_torch import create_communicator
    comm = create_communicator("jax_ici", device="cpu")
    out = {"p2p": _p2p(comm, rank), "chain": _chain_lists(comm, rank),
           "split_mlp": _split_mlp(comm, rank),
           "seq2seq": _seq2seq(comm, rank, jax_npz, batch)}
    comm.finalize()              # every send was received
    return out


# -- the references (this process) ----------------------------------------------

def _batch():
    from chainermn_tpu_torch.models import make_synthetic_translation_data
    xs, ys_in, ys_out = make_synthetic_translation_data()
    return xs[:N_SENT], ys_in[:N_SENT], ys_out[:N_SENT]


def _jax_seq2seq(batch, npz_path):
    import jax.numpy as jnp
    from chainermn_tpu.core.optimizer import Adam
    from chainermn_tpu.models import Seq2seq
    from chainermn_tpu.serializers import save_npz
    model = Seq2seq(**S2S)
    save_npz(npz_path, model)
    opt = Adam().setup(model)
    args = [jnp.asarray(a) for a in batch]
    losses = [float(opt.update(model, *args)) for _ in range(STEPS)]
    return model, losses, {p: np.asarray(v.array)
                           for p, v in model.namedparams()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_parallel")
    batch = _batch()
    npz_path = str(tmp / "seq2seq_init.npz")
    jmodel, jlosses, jparams = _jax_seq2seq(batch, npz_path)
    ranks = spawn_ranks(tmp, _worker, world=WORLD, jax_npz=npz_path,
                        batch=batch)
    return ranks, {"model": jmodel, "losses": jlosses, "params": jparams,
                   "batch": batch}


def _owned(grads, owned_prefixes):
    return {p: g for p, g in grads.items()
            if any(p.startswith(o) for o in owned_prefixes)}


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


# -- point to point --------------------------------------------------------------

def test_point_to_point_forward(runs):
    ranks, _ = runs
    np.testing.assert_array_equal(ranks[0]["p2p"]["p2p_forward"], [2., 3.])
    np.testing.assert_array_equal(ranks[1]["p2p"]["p2p_forward"], [0., 0.])


def test_point_to_point_gradient_reverses_edge(runs):
    """Rank 0's cotangent (3) flows back along the reversed edge 0 -> 1;
    a self-edge is the identity, gradient and all."""
    ranks, _ = runs
    np.testing.assert_array_equal(ranks[1]["p2p"]["p2p_grad"], [3., 3.])
    np.testing.assert_array_equal(ranks[0]["p2p"]["p2p_grad"], [0., 0.])
    for r in ranks:
        np.testing.assert_array_equal(r["p2p"]["p2p_self"], [2., 2.])


def test_send_recv_pair_and_delegate(runs):
    """Rank 1 receives 2 x; its cotangent 2 y = 4 x crosses back to rank
    0's delegate, then x 2 for h = 2 x."""
    ranks, _ = runs
    x0 = np.array([1.5, -2.0], np.float32)
    np.testing.assert_allclose(ranks[1]["p2p"]["sendrecv_value"], 2 * x0)
    np.testing.assert_allclose(ranks[0]["p2p"]["sendrecv_grad"], 8 * x0)


def test_recv_without_send_raises(runs):
    ranks, _ = runs
    for r in ranks:
        assert "no matching send" in r["p2p"]["recv_without_send"]


def test_pseudo_connect_keeps_edge_alive_and_tags(runs):
    """The local head's gradient everywhere; the unused received value
    still ran its backward (else rank 0's delegate would wait forever);
    two transfers on one pair arrive by tag."""
    ranks, _ = runs
    for r in ranks:
        np.testing.assert_array_equal(r["p2p"]["pseudo_connect_grad"],
                                      [1., 1.])
    a, b = ranks[1]["p2p"]["tags"]
    np.testing.assert_array_equal(a, [1.0])
    np.testing.assert_array_equal(b, [2.0, 3.0])


# -- MultiNodeChainList ----------------------------------------------------------

def _reference_pipeline(x):
    Block, _ = _blocks()
    blocks = [Block(4, 8, 1), Block(8, 6, 2), Block(6, 2, 3)]
    h = x
    for b in blocks:
        h = b(h)
    (h ** 2).sum().backward()
    return h.detach(), blocks


def test_straight_pipeline_forward_matches_reference(runs):
    ranks, _ = runs
    y_ref, _ = _reference_pipeline(_x(1, (5, 4)))
    for r in ranks:
        _close(r["chain"]["straight"][0], y_ref, CHAIN_TOL)


def test_straight_pipeline_gradients_match_reference(runs):
    """Each component's gradient on its owner equals the single-process
    stack's; the other rank's copy gets none."""
    ranks, _ = runs
    _, blocks = _reference_pipeline(_x(1, (5, 4)))
    owners = [0, 1, 0]
    for i, (block, owner) in enumerate(zip(blocks, owners)):
        for name in ("W", "b"):
            path = f"/mn_component_{i}/l/{name}"
            _close(ranks[owner]["chain"]["straight"][1][path],
                   getattr(block.l, name).grad, CHAIN_TOL)
            assert ranks[1 - owner]["chain"]["straight"][1][path] is None


def test_branching_and_merging_topology(runs):
    ranks, _ = runs
    Block, Merge = _blocks()
    b0, b1, b2 = Block(4, 6, 10), Block(6, 5, 11), Block(6, 5, 12)
    mg = Merge(10, 2, 13)
    h = b0(_x(2, (3, 4)))
    y_ref = mg(b1(h), b2(h))
    y_ref.sum().backward()
    for r in ranks:
        _close(r["chain"]["branching"][0], y_ref.detach(), CHAIN_TOL)
    grads0, grads1 = (r["chain"]["branching"][1] for r in ranks)
    _close(grads0["/mn_component_0/l/W"], b0.l.W.grad, CHAIN_TOL)
    _close(grads1["/mn_component_1/l/W"], b1.l.W.grad, CHAIN_TOL)
    _close(grads0["/mn_component_2/l/W"], b2.l.W.grad, CHAIN_TOL)
    _close(grads1["/mn_component_3/l/W"], mg.l.W.grad, CHAIN_TOL)


def test_pipeline_trains_with_optimizer(runs):
    """Plain ``SGD`` on the chain list: the loss falls, every rank reports
    the same losses, and a rank's copy of a component it does not own
    keeps its initial weights (no gradient, no update)."""
    ranks, _ = runs
    for r in ranks:
        losses = r["chain"]["trains"]
        assert losses[-1] < losses[0]
    assert ranks[0]["chain"]["trains"] == ranks[1]["chain"]["trains"]
    Block, _ = _blocks()
    init = Block(8, 6, 2)
    np.testing.assert_array_equal(
        ranks[0]["chain"]["trains_params"]["/pipe/mn_component_1/l/W"],
        init.l.W.detach())
    assert not torch.equal(
        ranks[1]["chain"]["trains_params"]["/pipe/mn_component_1/l/W"],
        init.l.W.detach())


def test_pipeline_bn_stats_come_from_owner_rank(runs):
    ranks, _ = runs
    from chainermn_tpu_torch import L
    Block, _ = _blocks()
    bn = L.BatchNormalization(6, device="cpu")
    bn(Block(4, 6, 20)(_x(5, (16, 4)) + 3.0))
    for r in ranks:
        _close(r["chain"]["bn"], bn.avg_mean.detach(),
               dict(rtol=1e-4, atol=1e-5))
        assert float(r["chain"]["bn"].abs().sum()) > 1e-3


def test_chain_list_topology_errors(runs):
    ranks, _ = runs
    for r in ranks:
        first, second = r["chain"]["errors"]
        assert "no terminal" in first and "multiple terminal" in second


def test_interleaved_multi_edge_same_rank_pair(runs):
    """Two edges 0 -> 1 with a self-edge of rank 1 between them: the
    per-pair tags keep each channel apart, and rank 1's ``rank_in [0, 1,
    0]`` binds (A, D, B)."""
    ranks, _ = runs
    Block, Merge = _blocks()
    a, d, b, merge = (Block(4, 4, 11), Block(4, 4, 13), Block(4, 4, 12),
                      Merge(12, 3, 14))
    x = _x(7, (5, 4))
    y_ref = merge(a(x), d(x), b(x))
    y_ref.sum().backward()
    for r in ranks:
        _close(r["chain"]["interleaved"][0], y_ref.detach(), CHAIN_TOL)
    _close(ranks[0]["chain"]["interleaved"][1]["/mn_component_2/l/W"],
           b.l.W.grad, CHAIN_TOL)
    _close(ranks[1]["chain"]["interleaved"][1]["/mn_component_1/l/W"],
           d.l.W.grad, CHAIN_TOL)


def test_two_parallel_pipelines_same_rank_pair(runs):
    ranks, _ = runs
    Block, Merge = _blocks()
    p1, p2, mg = Block(4, 4, 21), Block(4, 4, 22), Merge(8, 2, 23)
    x = _x(8, (3, 4))
    y_ref = mg(p1(x), p2(x)).detach()
    for r in ranks:
        _close(r["chain"]["parallel_pipelines"], y_ref, CHAIN_TOL)


# -- the models -----------------------------------------------------------------

def test_split_mlp_equals_single_process_mlp(runs):
    """The model-parallel MNIST example's ``SplitMLP`` (l1, l2 on rank 0,
    l3 on rank 1) against one process running the three layers, 3 Adam
    steps: losses on every rank, each layer's parameters on its
    owner."""
    ranks, _ = runs
    from chainermn_tpu_torch import F, L
    from chainermn_tpu_torch.core.link import Chain
    from chainermn_tpu_torch.core.optimizer import Adam

    class MLP(Chain):
        def __init__(self):
            super().__init__()
            self.l1 = L.Linear(784, 10, seed=0, device="cpu")
            self.l2 = L.Linear(10, 10, seed=1, device="cpu")
            self.l3 = L.Linear(10, 10, seed=2, device="cpu")

        def forward(self, x, t):
            h = F.relu(self.l2(F.relu(self.l1(x))))
            return F.softmax_cross_entropy(self.l3(h), t)

    model = MLP()
    opt = Adam().setup(model)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.normal(0, 1, (16, 784)).astype(np.float32))
    t = torch.from_numpy(rng.randint(0, 10, 16).astype(np.int64))
    losses = [opt.update(model, x, t).item() for _ in range(STEPS)]
    for r in ranks:
        _close(r["split_mlp"]["losses"], losses, CHAIN_TOL)
    p0, p1 = (r["split_mlp"]["params"] for r in ranks)
    _close(p0["/mn_component_0/l1/W"], model.l1.W.detach(), CHAIN_TOL)
    _close(p0["/mn_component_0/l2/b"], model.l2.b.detach(), CHAIN_TOL)
    _close(p1["/mn_component_1/l3/W"], model.l3.W.detach(), CHAIN_TOL)
    assert ranks[0]["split_mlp"]["owned"] == [
        "/mn_component_0/l1/W", "/mn_component_0/l1/b",
        "/mn_component_0/l2/W", "/mn_component_0/l2/b"]


@pytest.mark.parametrize("label", ["split", "self_edge"])
def test_model_parallel_seq2seq_matches_jax_seq2seq(runs, label):
    """``ModelParallelSeq2seq`` (encoder on rank 0, decoder on rank 1; or
    both on rank 0, the edge a self-edge: the one-card layout) from the
    JAX ``Seq2seq``'s npz snapshot, 3 Adam steps, against the JAX
    single-process ``Seq2seq``: the losses on every rank, the encoder's
    parameters on rank 0 and the decoder's on its owner."""
    ranks, ref = runs
    owner = {"split": 1, "self_edge": 0}[label]
    for r in ranks:
        _close(r["seq2seq"][label]["losses"], ref["losses"], JAX_TOL)
    enc = ranks[0]["seq2seq"][label]["params"]
    dec = ranks[owner]["seq2seq"][label]["params"]
    for path, want in ref["params"].items():
        got = (enc if path.startswith("/encoder/") else dec)[_mp_path(path)]
        _close(got, want, JAX_TOL)
    if label == "split":
        # the state crossed once a step forward, its gradient once back
        # (a header and the tensor each)
        assert ranks[0]["seq2seq"][label]["calls"]["send"] >= 2 * STEPS
        assert ranks[1]["seq2seq"][label]["calls"]["send"] >= STEPS


def test_seq2seq_translate_equals_jax_greedy_tokens(runs):
    """Greedy decoding of the trained JAX weights in both packages: the
    same tokens, step for step."""
    _, ref = runs
    import jax.numpy as jnp
    from chainermn_tpu_torch.models import Seq2seq
    from chainermn_tpu_torch.serializers import load_params
    model = Seq2seq(device="cpu", **S2S)
    load_params(model, ref["params"])
    xs = ref["batch"][0]
    got = model.translate(torch.from_numpy(xs), 0, 1, max_length=10)
    want = ref["model"].translate(jnp.asarray(xs), 0, 1, max_length=10)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
