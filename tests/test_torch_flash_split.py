"""The port's split flash backward against the JAX package's, on the CPU.

``CHAINERMN_TPU_FLASH_BWD=split`` runs the backward as two passes, the dq
pass (``_flash_bwd_dq_kernel``) and the dk/dv pass
(``_flash_bwd_dkv_kernel``).  A CPU tensor takes their plain versions,
``_flash_bwd_dq_plain`` and ``_flash_bwd_dkv_plain``; here they are held
against the Pallas kernels in interpret mode (the JAX module's
``_FLASH_BWD`` switched to ``split``, explicit 32-row tiles that divide
T), and the whole split path against the fused one.  Inputs come from
numpy seeds.

Tolerances, as in ``test_torch_flash_backward.py``: fp32 2e-5 absolute
(the same products summed in another order: the Pallas kernels tile by
tile, the plain versions in one pass); bf16 one bf16 ulp (2 ** -8
relative) of the largest value, since both sides round p and ds to bf16
at the same points.
"""

import importlib

import numpy as np
import pytest
import torch

from tests.test_torch_flash_backward import (ATOL, SHAPES, _arrays, _bf16_tol,
                                             _close, _j, _t)

fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")

TILE = 32


def _jfa():
    return importlib.import_module("chainermn_tpu.ops.flash_attention")


def _jax_split(monkeypatch, q, k, v, g, causal, g_lse=None, dtype=None,
               scale=None):
    """The JAX split backward, interpreted: ``(out, lse, (dq, dk, dv))``."""
    import jax.numpy as jnp
    jfa = _jfa()
    dtype = dtype or jnp.float32
    jq, jk, jv, jg = (_j(x, dtype) for x in (q, k, v, g))
    out, lse = jfa.flash_attention_fwd(jq, jk, jv, causal=causal,
                                       scale=scale, block_q=TILE,
                                       block_k=TILE, interpret=True)
    monkeypatch.setattr(jfa, "_FLASH_BWD", "split")
    grads = jfa.flash_attention_bwd(
        jq, jk, jv, out, lse, jg, causal=causal, scale=scale, block_q=TILE,
        block_k=TILE, interpret=True,
        g_lse=None if g_lse is None else _j(g_lse))
    return out, lse, grads


@pytest.mark.parametrize("with_g_lse", [False, True])
@pytest.mark.parametrize("Tq,Tk,D,causal,scale", [
    pytest.param(*shape, None, id="-".join(map(str, shape)))
    for shape in SHAPES] + [
    # a scale of 0 (uniform attention over the live keys) and a negative
    # one; D 128 with Tq != Tk both ways
    (64, 64, 32, True, 0.0), (64, 128, 16, False, 0.0),
    (64, 64, 32, True, -0.125), (64, 128, 16, False, -0.125),
    (96, 64, 128, True, None), (64, 96, 128, False, None)])
def test_split_plain_versions_match_pallas(monkeypatch, Tq, Tk, D, causal,
                                           scale, with_g_lse):
    q, k, v, g, g_lse = _arrays([(2, 2, Tq, D), (2, 2, Tk, D), (2, 2, Tk, D),
                                 (2, 2, Tq, D), (2, 2, Tq)], Tq + Tk + D)
    out, lse, ref = _jax_split(monkeypatch, q, k, v, g, causal,
                               g_lse if with_g_lse else None, scale=scale)
    delta = (_t(g) * _t(out)).sum(-1)
    if with_g_lse:
        delta = delta - _t(g_lse)
    args = (_t(q), _t(k), _t(v), _t(g), _t(lse), delta)
    kw = {"causal": causal, "scale": scale}
    dq = fa._flash_bwd_dq_plain(*args, **kw)
    dk, dv = fa._flash_bwd_dkv_plain(*args, **kw)
    for a, b, name in zip((dq, dk, dv), ref, ("dq", "dk", "dv")):
        _close(a, b, what=name)
    # the counted entry points take the plain versions on CPU tensors
    assert torch.equal(fa.flash_attention_bwd_dq(*args, **kw), dq)
    got_k, got_v = fa.flash_attention_bwd_dkv(*args, **kw)
    assert torch.equal(got_k, dk) and torch.equal(got_v, dv)


@pytest.mark.parametrize("causal", [True, False])
def test_split_mode_backward_matches_pallas_bf16(monkeypatch, causal):
    import jax.numpy as jnp
    q, k, v, g = _arrays([(1, 2, 64, 32)] * 4, 13)
    out, lse, ref = _jax_split(monkeypatch, q, k, v, g, causal,
                               dtype=jnp.bfloat16)
    monkeypatch.setattr(fa, "_FLASH_BWD", "split")
    bf = torch.bfloat16
    got = fa.flash_attention_bwd(_t(q, bf), _t(k, bf), _t(v, bf),
                                 _t(out, bf), _t(lse), _t(g, bf),
                                 causal=causal)
    for a, b, name in zip(got, ref, ("dq", "dk", "dv")):
        assert a.dtype == bf
        _close(a, b, atol=_bf16_tol(b), what=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_split_and_fused_agree_in_the_port(monkeypatch, causal, dtype):
    """The two lowerings are the same math; on the CPU their plain
    versions do the same operations, so they agree bitwise."""
    q, k, v, g, g_lse = (_t(a, dtype) for a in _arrays(
        [(2, 3, 48, 64), (2, 3, 80, 64), (2, 3, 80, 64), (2, 3, 48, 64),
         (2, 3, 48)], 17))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    results = {}
    for mode in ("fused", "split"):
        monkeypatch.setattr(fa, "_FLASH_BWD", mode)
        results[mode] = fa.flash_attention_bwd(q, k, v, out, lse, g,
                                               causal=causal,
                                               g_lse=g_lse.float())
    for a, b in zip(results["fused"], results["split"]):
        assert a.dtype == b.dtype == dtype and torch.equal(a, b)


def test_split_autograd_matches_jax_grad(monkeypatch):
    """``_FlashDiff`` with the split backward (its plain versions) against
    ``jax.grad`` through the JAX custom VJP in split mode (the Pallas
    kernels, interpreted)."""
    import jax
    import jax.numpy as jnp
    jfa = _jfa()
    monkeypatch.setenv("CHAINERMN_TPU_FLASH_INTERPRET", "1")
    monkeypatch.setattr(jfa, "_FLASH_BWD", "split")
    monkeypatch.setattr(fa, "_FLASH_BWD", "split")
    q, k, v, w = _arrays([(1, 2, 64, 16)] * 4, 29)
    jgrads = jax.grad(lambda q, k, v: jnp.sum(
        jfa.attention(q, k, v, causal=True) * _j(w)), argnums=(0, 1, 2))(
        _j(q), _j(k), _j(v))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    torch.sum(fa._FlashDiff.apply(*leaves, True, None) * _t(w)).backward()
    for leaf, ref, name in zip(leaves, jgrads, ("dq", "dk", "dv")):
        _close(leaf.grad, ref, atol=ATOL, what=name)


def test_plain_split_counts_no_launch_and_nonsense_raises(monkeypatch):
    q, k, v, g = (_t(a) for a in _arrays([(1, 2, 64, 16)] * 4, 3))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    counters = (fa.flash_attention_bwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    before = [fn.launches for fn in counters]
    monkeypatch.setattr(fa, "_FLASH_BWD", "split")
    fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    assert [fn.launches for fn in counters] == before
    monkeypatch.setattr(fa, "_FLASH_BWD", "nonsense")
    with pytest.raises(ValueError, match="CHAINERMN_TPU_FLASH_BWD"):
        fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)


def test_split_work_counts():
    """The bounds' inputs at the training shape: 3 dots per live pair for
    the dq pass, 4 for the dk/dv pass; bytes each moves once."""
    pairs = 1024 * 1025 // 2
    B, H, T, D = 8, 12, 1024, 64
    assert fa.attention_bwd_flops(B, H, T, T, D, True, part="dq") \
        == 6 * B * H * D * pairs
    assert fa.attention_bwd_flops(B, H, T, T, D, True, part="dkv") \
        == 8 * B * H * D * pairs
    assert fa.attention_bwd_bytes(B, H, T, T, D, 2, part="dq") \
        == B * H * (5 * T * D * 2 + 2 * T * 4)
    assert fa.attention_bwd_bytes(B, H, T, T, D, 2, part="dkv") \
        == B * H * (6 * T * D * 2 + 2 * T * 4)
