"""The port's training attention against the JAX package's, on the CPU.

The plain versions of the lse forward (``_flash_fwd_lse_plain``) and of
the fused backward (``_flash_bwd_plain``) are what a CPU tensor runs in
place of the CUDA kernels; here they are held against the Pallas kernels
``_flash_kernel_lse`` and ``_flash_bwd_fused_kernel`` in interpret mode,
and the autograd Functions built on them against ``jax.grad`` through the
JAX custom VJPs.  Inputs come from numpy seeds.

Tolerances, fp32: 2e-5 absolute for values of order 1 -- the two sides
sum the same products in another order (the Pallas kernel tile by tile
with an online softmax, the plain version in one pass), a few fp32 ulps
of sums over up to 128 terms.  bf16 inputs take the same casts on both
sides, so one bf16 ulp (2 ** -8 relative) of the largest value bounds
them.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

jfa = importlib.import_module("chainermn_tpu.ops.flash_attention")
fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")

ATOL = 2e-5


def _arrays(shapes, seed):
    rng = np.random.RandomState(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(np.asarray(x, np.float32)).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, atol=ATOL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _bf16_tol(want):
    return 2.0 ** -8 * max(float(np.abs(_np(want)).max()), 1.0)


# (Tq, Tk, D, causal)
SHAPES = [(64, 64, 16, True), (128, 128, 32, True), (64, 64, 32, False),
          (64, 128, 16, False)]


@pytest.mark.parametrize("Tq,Tk,D,causal", SHAPES)
def test_lse_forward_plain_matches_pallas(Tq, Tk, D, causal):
    q, k, v = _arrays([(2, 2, Tq, D), (2, 2, Tk, D), (2, 2, Tk, D)], Tq + D)
    out, lse = fa.flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal)
    ref_out, ref_lse = jfa.flash_attention_fwd(
        _j(q), _j(k), _j(v), causal=causal, interpret=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, 2, Tq)
    _close(out, ref_out, what="out")
    _close(lse, ref_lse, what="lse")


def test_lse_forward_plain_matches_pallas_bf16():
    q, k, v = _arrays([(1, 2, 64, 32)] * 3, 7)
    out, lse = fa.flash_attention_fwd(_t(q, torch.bfloat16),
                                      _t(k, torch.bfloat16),
                                      _t(v, torch.bfloat16), causal=True)
    ref_out, ref_lse = jfa.flash_attention_fwd(
        _j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16),
        causal=True, interpret=True)
    assert out.dtype == torch.bfloat16
    _close(out, ref_out, atol=_bf16_tol(ref_out), what="out")
    _close(lse, ref_lse, what="lse")   # fp32 on both sides


def test_masked_row_has_finite_lse_in_the_plain_forward(monkeypatch):
    """The kernel's rule: a row with no live key has out 0 and the finite
    lse ``log(1e-30)``, never -inf or NaN.  The causal mask leaves every
    row key 0, so the test masks all of row 0's keys itself."""
    def mask_row0(Tq, Tk, device):
        m = torch.zeros((Tq, Tk), dtype=torch.bool, device=device)
        m[0] = True
        return m

    monkeypatch.setattr(fa, "_causal_mask", mask_row0)
    q, k, v = (_t(a) for a in _arrays([(1, 1, 4, 16)] * 3, 3))
    out, lse = fa._flash_fwd_lse_plain(q, k, v, causal=True)
    assert torch.equal(out[0, 0, 0], torch.zeros(16))
    assert lse[0, 0, 0].item() == pytest.approx(np.log(1e-30), rel=1e-6)
    assert torch.isfinite(lse).all() and torch.isfinite(out).all()


@pytest.mark.parametrize("with_g_lse", [False, True])
@pytest.mark.parametrize("Tq,Tk,D,causal", SHAPES)
def test_fused_backward_plain_matches_pallas(monkeypatch, Tq, Tk, D, causal,
                                             with_g_lse):
    monkeypatch.setattr(jfa, "_FLASH_BWD", "fused")
    q, k, v, g, g_lse = _arrays([(2, 2, Tq, D), (2, 2, Tk, D), (2, 2, Tk, D),
                                 (2, 2, Tq, D), (2, 2, Tq)], Tk + D + 1)
    out, lse = jfa.flash_attention_fwd(_j(q), _j(k), _j(v), causal=causal,
                                       interpret=True)
    ref = jfa.flash_attention_bwd(
        _j(q), _j(k), _j(v), out, lse, _j(g), causal=causal, interpret=True,
        g_lse=_j(g_lse) if with_g_lse else None)
    got = fa.flash_attention_bwd(
        _t(q), _t(k), _t(v), _t(out), _t(lse), _t(g), causal=causal,
        g_lse=_t(g_lse) if with_g_lse else None)
    for a, b, name in zip(got, ref, ("dq", "dk", "dv")):
        _close(a, b, what=name)


def test_fused_backward_plain_matches_pallas_bf16(monkeypatch):
    monkeypatch.setattr(jfa, "_FLASH_BWD", "fused")
    q, k, v, g = _arrays([(1, 2, 64, 32)] * 4, 11)
    bq, bk, bv, bg = (_j(x, jnp.bfloat16) for x in (q, k, v, g))
    out, lse = jfa.flash_attention_fwd(bq, bk, bv, causal=True,
                                       interpret=True)
    ref = jfa.flash_attention_bwd(bq, bk, bv, out, lse, bg, causal=True,
                                  interpret=True)
    tq, tk, tv, tg = (_t(x, torch.bfloat16) for x in (q, k, v, g))
    got = fa.flash_attention_bwd(tq, tk, tv, _t(out, torch.bfloat16),
                                 _t(lse), tg, causal=True)
    for a, b, name in zip(got, ref, ("dq", "dk", "dv")):
        assert a.dtype == torch.bfloat16
        _close(a, b, atol=_bf16_tol(b), what=name)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_diff_function_matches_jax_grad(monkeypatch, causal):
    """``_FlashDiff`` (run on the plain versions) against ``jax.grad``
    through ``_flash_diff`` (the Pallas kernels, interpreted)."""
    monkeypatch.setenv("CHAINERMN_TPU_FLASH_INTERPRET", "1")
    monkeypatch.setattr(jfa, "_FLASH_BWD", "fused")
    q, k, v, w = _arrays([(1, 2, 64, 16)] * 4, 21)

    def jloss(q, k, v):
        return jnp.sum(jfa.attention(q, k, v, causal=causal) * _j(w))

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        _j(q), _j(k), _j(v))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = fa._FlashDiff.apply(*leaves, causal, None)
    loss = torch.sum(out * _t(w))
    loss.backward()
    _close(loss, jval, atol=1e-4, what="loss")   # a sum of 2048 terms
    for leaf, ref, name in zip(leaves, jgrads, ("dq", "dk", "dv")):
        _close(leaf.grad, ref, what=name)


@pytest.mark.parametrize("use", ["both", "lse_only", "out_only"])
def test_flash_lse_diff_function_matches_jax_grad(monkeypatch, use):
    """``_FlashLseDiff`` against ``jax.grad`` through ``_flash_lse_diff``:
    lse's cotangent enters as ``g_lse``; an unused output's cotangent is
    zero (``None`` on the torch side)."""
    monkeypatch.setenv("CHAINERMN_TPU_FLASH_INTERPRET", "1")
    monkeypatch.setattr(jfa, "_FLASH_BWD", "fused")
    q, k, v, w, u = _arrays([(1, 2, 64, 16)] * 4 + [(1, 2, 64)], 23)
    wo = 0.0 if use == "lse_only" else 1.0
    wl = 0.0 if use == "out_only" else 1.0

    def jloss(q, k, v):
        out, lse = jfa.attention_with_lse(q, k, v, causal=True)
        return wo * jnp.sum(out * _j(w)) + wl * jnp.sum(lse * _j(u))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out, lse = fa._FlashLseDiff.apply(*leaves, True, 0.25)
    terms = []
    if use != "lse_only":
        terms.append(torch.sum(out * _t(w)))
    if use != "out_only":
        terms.append(torch.sum(lse * _t(u)))
    sum(terms).backward()
    for leaf, ref, name in zip(leaves, jgrads, ("dq", "dk", "dv")):
        _close(leaf.grad, ref, what=name)


@pytest.mark.parametrize("Tq,Tk,causal", [(64, 100, False), (64, 64, True),
                                          (40, 72, False)])
def test_blockwise_lse_matches_jnp_with_ragged_keys(Tq, Tk, causal):
    """``_blockwise_attention_lse_torch`` against
    ``_blockwise_attention_lse_jnp`` at block_k 32: Tk 100 and 72 pad the
    last block and mask the padded keys.  Values and gradients."""
    q, k, v, w, u = _arrays([(1, 2, Tq, 16), (1, 2, Tk, 16), (1, 2, Tk, 16),
                             (1, 2, Tq, 16), (1, 2, Tq)], Tq + Tk)

    def jloss(q, k, v):
        out, lse = jfa._blockwise_attention_lse_jnp(q, k, v, causal, 0.25,
                                                    block_k=32)
        return jnp.sum(out * _j(w)) + jnp.sum(lse * _j(u)), (out, lse)

    (_, (jout, jlse)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(_j(q), _j(k), _j(v))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out, lse = fa._blockwise_attention_lse_torch(*leaves, causal, 0.25,
                                                 block_k=32)
    _close(out, jout, what="out")
    _close(lse, jlse, what="lse")
    (torch.sum(out * _t(w)) + torch.sum(lse * _t(u))).backward()
    for leaf, ref, name in zip(leaves, jgrads, ("dq", "dk", "dv")):
        _close(leaf.grad, ref, what=name)


def test_attention_with_lse_on_cpu_is_the_blockwise_version():
    q, k, v = (_t(a) for a in _arrays([(1, 2, 64, 16)] * 3, 5))
    out, lse = fa.attention_with_lse(q, k, v, causal=True)
    ref_out, ref_lse = fa._blockwise_attention_lse_torch(q, k, v, True,
                                                         0.25)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert torch.equal(fa.blockwise_attention(q, k, v, causal=True), out)


def test_attention_on_cpu_matches_jax_attention_and_its_grad():
    """Off the card ``attention`` is ``xla_attention`` under torch
    autograd, as the JAX ``attention`` is its XLA reference off-TPU."""
    q, k, v, w = _arrays([(2, 2, 32, 16)] * 4, 9)
    jgrads = jax.grad(
        lambda q, k, v: jnp.sum(jfa.attention(q, k, v, causal=True)
                                * _j(w)), argnums=(0, 1, 2))(
        _j(q), _j(k), _j(v))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    torch.sum(fa.attention(*leaves, causal=True) * _t(w)).backward()
    for leaf, ref, name in zip(leaves, jgrads, ("dq", "dk", "dv")):
        _close(leaf.grad, ref, what=name)


def test_plain_versions_count_no_launch():
    q, k, v, g = (_t(a) for a in _arrays([(1, 2, 64, 16)] * 4, 1))
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd.launches) == before


def test_split_backward_mode_raises_instead_of_running_fused(monkeypatch):
    """``split`` runs the dq and dk/dv passes, never the fused backward;
    an unknown mode raises instead of running either."""
    q, k, v, g = (_t(a) for a in _arrays([(1, 2, 64, 16)] * 4, 2))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    fused = []
    monkeypatch.setattr(fa, "_flash_bwd_plain",
                        lambda *a, **kw: fused.append(1))
    monkeypatch.setattr(fa, "_FLASH_BWD", "split")
    grads = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    assert not fused and [x.shape for x in grads] == [q.shape] * 3
    monkeypatch.setattr(fa, "_FLASH_BWD", "fast")
    with pytest.raises(ValueError, match="invalid"):
        fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)


def test_mixed_devices_are_refused():
    q = torch.zeros((1, 1, 4, 64))
    meta = torch.zeros((1, 1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="plain versions"):
        fa.flash_attention_fwd(q, meta, q)


def test_backward_work_counts():
    """The bound's inputs at the training shape: five dots per live pair
    and q, k, v, g, lse, delta in, dq, dk, dv out."""
    pairs = 1024 * 1025 // 2
    assert fa.attention_bwd_flops(8, 12, 1024, 1024, 64, True) \
        == 10 * 8 * 12 * 64 * pairs
    assert fa.attention_flops(8, 12, 1024, 1024, 64, True) \
        == 4 * 8 * 12 * 64 * pairs
    assert fa.attention_bwd_bytes(8, 12, 1024, 1024, 64, 2) \
        == 8 * 12 * (7 * 1024 * 64 * 2 + 2 * 1024 * 4)


def _jax_wrapper_delta(monkeypatch, out, g, g_lse):
    """The delta the JAX ``flash_attention_bwd`` hands its Pallas kernels:
    the wrapper runs with ``pl.pallas_call`` replaced by a stand-in that
    records the kernel's inputs (q, k, v, g, lse, delta) and returns
    zeros of the declared outputs."""
    import types
    seen = []

    def pallas_call(kernel, *, out_shape, **kw):
        def call(*args):
            seen.append(args)
            return [jnp.zeros(s.shape, s.dtype) for s in out_shape]
        return call

    names = {n: getattr(jfa.pl, n) for n in dir(jfa.pl)
             if not n.startswith("__")}
    names["pallas_call"] = pallas_call
    monkeypatch.setattr(jfa, "pl", types.SimpleNamespace(**names))
    monkeypatch.setattr(jfa, "_FLASH_BWD", "fused")
    B, H, T, D = g.shape
    x = _j(np.zeros((B, H, T, D), np.float32))
    jfa.flash_attention_bwd(x, x, x, _j(out), _j(np.zeros((B, H, T))),
                            _j(g), causal=True,
                            g_lse=None if g_lse is None else _j(g_lse))
    (args,) = seen
    return np.asarray(args[5]).reshape(B, H, T)


@pytest.mark.parametrize("with_g_lse", [False, True])
@pytest.mark.parametrize("D", [64, 128])
def test_plain_delta_matches_the_jax_wrapper(monkeypatch, D, with_g_lse):
    """``_bwd_delta_plain`` (what the delta pass computes, and what a CPU
    tensor takes) against the delta the JAX wrapper computes: fp32 sums of
    D products of order 1, 2e-5."""
    out, g, g_lse = _arrays([(2, 3, 40, D), (2, 3, 40, D), (2, 3, 40)],
                            D + with_g_lse)
    g_lse = g_lse if with_g_lse else None
    want = _jax_wrapper_delta(monkeypatch, out, g, g_lse)
    got = fa._bwd_delta_plain(_t(g), _t(out),
                              None if g_lse is None else _t(g_lse))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 40)
    _close(got, want, what="delta")
    # the counted entry point takes the plain version on CPU tensors
    before = fa.flash_attention_bwd_delta.launches
    assert torch.equal(fa.flash_attention_bwd_delta(
        _t(g), _t(out), None if g_lse is None else _t(g_lse)), got)
    assert fa.flash_attention_bwd_delta.launches == before


def test_plain_delta_matches_the_jax_wrapper_bf16(monkeypatch):
    """bf16 g and out: both sides upcast exactly and sum in fp32."""
    out, g = _arrays([(1, 2, 64, 64)] * 2, 31)
    bo, bg = (np.asarray(_t(x, torch.bfloat16).float()) for x in (out, g))
    want = _jax_wrapper_delta(monkeypatch, bo, bg, None)
    got = fa._bwd_delta_plain(_t(g, torch.bfloat16),
                              _t(out, torch.bfloat16))
    _close(got, want, what="delta")


def test_cpu_backward_never_loads_the_library(monkeypatch):
    """The delta pass and both lowerings take their plain versions on CPU
    tensors without building or loading the kernels."""
    from chainermn_tpu_torch import _build
    monkeypatch.setattr(_build, "load_library", lambda: pytest.fail(
        "the library was loaded for CPU tensors"))
    q, k, v, g = (_t(a) for a in _arrays([(1, 2, 64, 64)] * 4, 33))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    fa.flash_attention_bwd_delta(g, out)
    for mode in ("fused", "split"):
        monkeypatch.setattr(fa, "_FLASH_BWD", mode)
        fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)


def test_fused_launcher_takes_the_dq_accumulator_and_dq():
    """The fused launcher's outputs: the fp32 dq accumulator its epilogue
    reads, then dq, dk, dv; the delta pass's five pointers."""
    import ctypes
    from chainermn_tpu_torch import _build
    p = ctypes.c_void_p
    assert _build.ARGTYPES["flash_attention_bwd"][:11] == [p] * 10 + [
        ctypes.c_int]
    assert _build.ARGTYPES["flash_attention_bwd_delta"][:6] == [p] * 5 + [
        ctypes.c_int]
