"""The port's recurrent functions and links against the JAX package's, on
the CPU: ``F.sigmoid``, ``F.tanh``, ``F.embed_id(ignore_label=)``,
``F.softmax_cross_entropy`` with PAD rows, ``L.EmbedID``,
``L.StatelessLSTM``, ``L.LSTM``, ``L.NStepLSTM`` with PAD masks, and the
GRUs.

Both sides are built with the same seeds, and the weights are asserted
bit-identical before anything runs (the two packages share the numpy
initializers), so the parameter paths and the npz keys line up.  Inputs
come from numpy seeds.  Outputs and the gradients of a fixed readout
(``jax.grad`` of the JAX link on the same weights) are compared in fp32.

Tolerances: elementwise functions 1e-6 absolute (the two frameworks'
``exp``/``tanh`` differ in the last ulp); the cells and the sequences
2e-5 absolute (fp32 products summed in another order, carried through
up to 7 steps of recurrence and two layers).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chainermn_tpu.core.link import apply_state, extract_state
from chainermn_tpu.nn import functions as JF
from chainermn_tpu.nn import links as JL
from chainermn_tpu_torch.core.config import using_config
from chainermn_tpu_torch.nn import functions as F
from chainermn_tpu_torch.nn import links as L

ELEM_TOL = dict(rtol=0, atol=1e-6)
SEQ_TOL = dict(rtol=0, atol=2e-5)
PAD = -1


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **tol)


def _grads_close(g, jg, tol):
    """Every JAX gradient against the port's; a parameter the port's
    backward did not reach (``None``) against zeros."""
    assert sorted(g) == sorted(jg)
    for p in jg:
        _close(torch.zeros(np.shape(jg[p])) if g[p] is None else g[p],
               jg[p], tol)


def _same_weights(link, jlink):
    mine = {p: v.detach().numpy() for p, v in link.namedparams()}
    theirs = {p: np.asarray(v.array) for p, v in jlink.namedparams()}
    assert sorted(mine) == sorted(theirs)
    for p in theirs:
        assert np.array_equal(mine[p], theirs[p]), p


def _jax_grads(jlink, readout, *args):
    """``readout(jlink(*args))`` and its gradient by parameter path."""
    state = extract_state(jlink)

    def f(params):
        out, _ = apply_state(jlink, {"params": params,
                                     "state": state["state"]}, *args)
        return readout(out)
    return jax.value_and_grad(f)(state["params"])


def _port_grads(link, readout, *args):
    link.cleargrads()
    value = readout(link(*args))
    value.backward()
    return value, {p: v.grad for p, v in link.namedparams()}


def _weights(n, seed):
    return np.random.RandomState(seed).normal(0, 1, n).astype(np.float32)


# -- functions ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sigmoid", "tanh"])
def test_activation_matches_jax(name):
    x = np.random.RandomState(0).normal(0, 3, (7, 5)).astype(np.float32)
    w = _weights((7, 5), 1)
    xt = torch.from_numpy(x).requires_grad_()
    got = getattr(F, name)(xt)
    (got * torch.from_numpy(w)).sum().backward()
    jf = getattr(JF, name)
    want = jf(jnp.asarray(x))
    gx = jax.grad(lambda v: jnp.sum(jf(v) * w))(jnp.asarray(x))
    _close(got, want, ELEM_TOL)
    _close(xt.grad, gx, ELEM_TOL)


@pytest.mark.parametrize("ignore_label", [None, PAD])
def test_embed_id_matches_jax(ignore_label):
    """A PAD id gathers row 0 and is zeroed: nothing of it in the output
    or in row 0's gradient."""
    rng = np.random.RandomState(2)
    W = rng.normal(0, 1, (9, 4)).astype(np.float32)
    x = rng.randint(0, 9, (3, 5)).astype(np.int32)
    if ignore_label is not None:
        x[0, 3:] = ignore_label
        x[2, 1] = ignore_label
    w = _weights((3, 5, 4), 3)
    Wt = torch.from_numpy(W).requires_grad_()
    got = F.embed_id(torch.from_numpy(x), Wt, ignore_label=ignore_label)
    (got * torch.from_numpy(w)).sum().backward()
    want = JF.embed_id(jnp.asarray(x), jnp.asarray(W), ignore_label)
    gW = jax.grad(lambda v: jnp.sum(JF.embed_id(
        jnp.asarray(x), v, ignore_label) * w))(jnp.asarray(W))
    _close(got, want, ELEM_TOL)
    _close(Wt.grad, gW, ELEM_TOL)
    if ignore_label is not None:
        assert not got[0, 3:].any() and not got[2, 1].any()


def test_softmax_cross_entropy_with_pad_rows_matches_jax():
    """The decoder's loss: PAD targets add nothing and leave the
    normalizer; a batch of PAD rows only gives 0, not NaN."""
    rng = np.random.RandomState(4)
    logits = rng.normal(0, 2, (12, 7)).astype(np.float32)
    t = rng.randint(0, 7, 12).astype(np.int32)
    t[[1, 5, 6, 11]] = PAD
    lt = torch.from_numpy(logits).requires_grad_()
    got = F.softmax_cross_entropy(lt, torch.from_numpy(t), ignore_label=PAD)
    got.backward()
    want, g = jax.value_and_grad(lambda v: JF.softmax_cross_entropy(
        v, jnp.asarray(t), ignore_label=PAD))(jnp.asarray(logits))
    _close(got, want, ELEM_TOL)
    _close(lt.grad, g, ELEM_TOL)
    assert not lt.grad[[1, 5, 6, 11]].any()
    all_pad = F.softmax_cross_entropy(lt, torch.full((12,), PAD),
                                      ignore_label=PAD)
    assert float(all_pad.detach()) == 0.0


def test_embed_id_link_matches_jax():
    link = L.EmbedID(11, 6, ignore_label=PAD, seed=5, device="cpu")
    jlink = JL.EmbedID(11, 6, ignore_label=PAD, seed=5)
    _same_weights(link, jlink)
    x = np.random.RandomState(6).randint(-1, 11, (4, 3)).astype(np.int32)
    w = _weights((4, 3, 6), 7)
    got, g = _port_grads(link, lambda y: (y * torch.from_numpy(w)).sum(),
                         torch.from_numpy(x))
    want, jg = _jax_grads(jlink, lambda y: jnp.sum(y * w), jnp.asarray(x))
    _close(got, want, ELEM_TOL)
    _close(g["/W"], jg["/W"], ELEM_TOL)


# -- the LSTM cell -----------------------------------------------------------------

@pytest.mark.parametrize("state", ["both", "no_h", "none"])
def test_stateless_lstm_matches_jax(state):
    """Gates packed ``[i, f, g, o]`` along axis 1, +1 on the forget gate;
    ``h`` None skips ``lateral``, ``c`` None starts from zeros."""
    B, D, H = 3, 5, 4
    link = L.StatelessLSTM(D, H, seed=8, device="cpu")
    jlink = JL.StatelessLSTM(D, H, seed=8)
    _same_weights(link, jlink)
    rng = np.random.RandomState(9)
    x = rng.normal(0, 1, (B, D)).astype(np.float32)
    c = rng.normal(0, 1, (B, H)).astype(np.float32)
    h = rng.normal(0, 1, (B, H)).astype(np.float32)
    c_in = None if state == "none" else c
    h_in = h if state == "both" else None
    wc, wh = _weights((B, H), 10), _weights((B, H), 11)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    def j(a):
        return None if a is None else jnp.asarray(a)

    got, g = _port_grads(
        link, lambda ch: (ch[0] * torch.from_numpy(wc)).sum()
        + (ch[1] * torch.from_numpy(wh)).sum(), t(c_in), t(h_in), t(x))
    want, jg = _jax_grads(
        jlink, lambda ch: jnp.sum(ch[0] * wc) + jnp.sum(ch[1] * wh),
        j(c_in), j(h_in), j(x))
    _close(got, want, SEQ_TOL)
    _grads_close(g, jg, SEQ_TOL)
    if state != "both":
        assert g["/lateral/W"] is None       # lateral skipped


def test_lstm_holds_state_like_jax():
    link = L.LSTM(4, 3, seed=12, device="cpu")
    jlink = JL.LSTM(4, 3, seed=12)
    _same_weights(link, jlink)
    xs = np.random.RandomState(13).normal(0, 1, (3, 2, 4)).astype(np.float32)
    for x in xs:
        _close(link(torch.from_numpy(x)), jlink(jnp.asarray(x)), SEQ_TOL)
    _close(link.c, jlink.c, SEQ_TOL)
    link.reset_state()
    jlink.reset_state()
    assert link.c is None and link.h is None
    _close(link(torch.from_numpy(xs[0])), jlink(jnp.asarray(xs[0])),
           SEQ_TOL)


# -- sequences ---------------------------------------------------------------------

def _mask_and_lengths(B, T, seed):
    lengths = np.random.RandomState(seed).randint(1, T + 1, B)
    lengths[0] = T
    return np.arange(T)[None, :] < lengths[:, None]


@pytest.mark.parametrize("with_state", [False, True])
def test_nstep_lstm_with_pad_mask_matches_jax(with_state):
    """``(hx, cx, xs[B, T, D], mask[B, T]) -> (hy, cy, ys)``: the mask
    freezes ``c`` and ``h`` at PAD positions, so ``hy``/``cy`` are each
    sequence's state at its last true step."""
    Lyr, B, T, D, H = 2, 4, 7, 5, 6
    link = L.NStepLSTM(Lyr, D, H, seed=14, device="cpu")
    jlink = JL.NStepLSTM(Lyr, D, H, seed=14)
    _same_weights(link, jlink)
    rng = np.random.RandomState(15)
    xs = rng.normal(0, 1, (B, T, D)).astype(np.float32)
    mask = _mask_and_lengths(B, T, 16)
    hx = rng.normal(0, 1, (Lyr, B, H)).astype(np.float32) \
        if with_state else None
    cx = rng.normal(0, 1, (Lyr, B, H)).astype(np.float32) \
        if with_state else None
    w = [_weights((Lyr, B, H), 17), _weights((Lyr, B, H), 18),
         _weights((B, T, H), 19)]

    def t(a):
        return None if a is None else torch.from_numpy(a)

    def j(a):
        return None if a is None else jnp.asarray(a)

    got, g = _port_grads(
        link, lambda out: sum((o * torch.from_numpy(wi)).sum()
                              for o, wi in zip(out, w)),
        t(hx), t(cx), t(xs), torch.from_numpy(mask))
    want, jg = _jax_grads(
        jlink, lambda out: sum(jnp.sum(o * wi) for o, wi in zip(out, w)),
        j(hx), j(cx), j(xs), jnp.asarray(mask))
    _close(got, want, SEQ_TOL)
    _grads_close(g, jg, SEQ_TOL)
    outs = link(t(hx), t(cx), t(xs), torch.from_numpy(mask))
    jouts = jlink(j(hx), j(cx), j(xs), jnp.asarray(mask))
    for o, jo in zip(outs, jouts):
        _close(o, jo, SEQ_TOL)
    # past its length a sequence's output repeats its last true h
    n = int(mask[1].sum())
    if n < T:
        assert torch.equal(outs[2][1, n], outs[2][1, n - 1])


def test_nstep_lstm_dropout_only_between_layers_in_training():
    link = L.NStepLSTM(2, 3, 4, dropout=0.5, seed=20, device="cpu")
    xs = torch.from_numpy(np.random.RandomState(21).normal(
        0, 1, (2, 3, 3)).astype(np.float32))
    with using_config("train", False):
        a = link(None, None, xs)[2]
        b = link(None, None, xs)[2]
    plain = L.NStepLSTM(2, 3, 4, seed=20, device="cpu")
    assert torch.equal(a, b) and torch.equal(a, plain(None, None, xs)[2])
    with using_config("train", True):
        torch.manual_seed(0)
        c = link(None, None, xs)[2]
    assert not torch.equal(a, c)
    # one layer: no inter-layer dropout even in training
    one = L.NStepLSTM(1, 3, 4, dropout=0.5, seed=20, device="cpu")
    with using_config("train", True):
        assert torch.equal(one(None, None, xs)[2],
                           L.NStepLSTM(1, 3, 4, seed=20,
                                       device="cpu")(None, None, xs)[2])


@pytest.mark.parametrize("with_h", [False, True])
def test_stateless_gru_matches_jax(with_h):
    B, D, H = 3, 4, 5
    link = L.StatelessGRU(D, H, seed=22, device="cpu")
    jlink = JL.StatelessGRU(D, H, seed=22)
    _same_weights(link, jlink)
    rng = np.random.RandomState(23)
    x = rng.normal(0, 1, (B, D)).astype(np.float32)
    h = rng.normal(0, 1, (B, H)).astype(np.float32) if with_h else None
    w = _weights((B, H), 24)
    got, g = _port_grads(link, lambda y: (y * torch.from_numpy(w)).sum(),
                         None if h is None else torch.from_numpy(h),
                         torch.from_numpy(x))
    want, jg = _jax_grads(jlink, lambda y: jnp.sum(y * w),
                          None if h is None else jnp.asarray(h),
                          jnp.asarray(x))
    _close(got, want, SEQ_TOL)
    _grads_close(g, jg, SEQ_TOL)


def test_gru_holds_state_like_jax():
    link = L.GRU(4, 3, seed=25, device="cpu")
    jlink = JL.GRU(4, 3, seed=25)
    xs = np.random.RandomState(26).normal(0, 1, (3, 2, 4)).astype(np.float32)
    for x in xs:
        _close(link(torch.from_numpy(x)), jlink(jnp.asarray(x)), SEQ_TOL)
    link.reset_state()
    assert link.h is None


def test_nstep_gru_with_pad_mask_matches_jax():
    Lyr, B, T, D, H = 2, 3, 6, 4, 5
    link = L.NStepGRU(Lyr, D, H, seed=27, device="cpu")
    jlink = JL.NStepGRU(Lyr, D, H, seed=27)
    _same_weights(link, jlink)
    rng = np.random.RandomState(28)
    xs = rng.normal(0, 1, (B, T, D)).astype(np.float32)
    mask = _mask_and_lengths(B, T, 29)
    w = [_weights((Lyr, B, H), 30), _weights((B, T, H), 31)]
    got, g = _port_grads(
        link, lambda out: sum((o * torch.from_numpy(wi)).sum()
                              for o, wi in zip(out, w)),
        None, torch.from_numpy(xs), torch.from_numpy(mask))
    want, jg = _jax_grads(
        jlink, lambda out: sum(jnp.sum(o * wi) for o, wi in zip(out, w)),
        None, jnp.asarray(xs), jnp.asarray(mask))
    _close(got, want, SEQ_TOL)
    _grads_close(g, jg, SEQ_TOL)
