"""The port's flash attention against the JAX package's.

On the CPU the port's ``attention`` takes its plain version, which must
match the JAX ``xla_attention`` and the JAX Pallas kernel run in
interpret mode (fp32, atol 1e-5: only the summation order differs).  The
CUDA kernel itself is held to the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from chainermn_tpu.ops import flash_attention as jax_flash_attention
from chainermn_tpu.ops import xla_attention as jax_xla_attention
from chainermn_tpu_torch.ops import attention, flash_attention, xla_attention
from chainermn_tpu_torch.ops.flash_attention import (attention_bytes,
                                                     attention_flops)

ATOL = 1e-5   # fp32, summation order only


def _qkv(B=1, H=2, T=64, D=16, seed=0, Tk=None):
    rng = np.random.RandomState(seed)
    Tk = T if Tk is None else Tk
    return (rng.normal(0, 1, (B, H, T, D)).astype(np.float32),
            rng.normal(0, 1, (B, H, Tk, D)).astype(np.float32),
            rng.normal(0, 1, (B, H, Tk, D)).astype(np.float32))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("T", [64, 37])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_jax_xla_attention(T, causal):
    q, k, v = _qkv(T=T, seed=T + causal)
    ref = np.asarray(jax_xla_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal))
    out = xla_attention(*_torch(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("T", [64, 37])
@pytest.mark.parametrize("causal", [False, True])
def test_dispatch_matches_jax_pallas_kernel_interpreted(T, causal):
    """The CPU dispatch against the Pallas ``_flash_kernel`` itself (the
    kernel the CUDA code replaces), run as the JAX suite runs it (a ragged
    T takes the JAX wrapper's own XLA fallback)."""
    q, k, v = _qkv(T=T, seed=3 + causal)
    ref = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=32, block_k=32, interpret=True))
    out = attention(*_torch(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_non_causal_cross_lengths_match_jax():
    q, k, v = _qkv(T=24, Tk=40, seed=5)
    ref = np.asarray(jax_xla_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), scale=0.3))
    out = attention(*_torch(q, k, v), scale=0.3).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_bf16_plain_matches_jax_bf16():
    """bf16 storage: the dots see the same bf16 values and accumulate in
    fp32 on both sides; the two differ in where the output rounds, so the
    band is one bf16 ulp at |out| < 4 (2 ** -6)."""
    q, k, v = _qkv(T=48, D=64, seed=7)
    jq, jk, jv = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    ref = np.asarray(jax_xla_attention(jq, jk, jv, causal=True)
                     .astype(jnp.float32))
    tq, tk, tv = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    out = attention(tq, tk, tv, causal=True).float().numpy()
    np.testing.assert_allclose(out, ref, atol=2 ** -6, rtol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = [t.to(torch.bfloat16) for t in _torch(*_qkv(D=64))]
    before = flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before   # nothing was launched


@pytest.mark.parametrize("dtype,D,exc", [
    (torch.float16, 64, TypeError),
    (torch.float64, 64, TypeError),
    (torch.bfloat16, 48, ValueError),
])
def test_kernel_wrapper_refuses_unsupported_inputs(dtype, D, exc):
    q, k, v = [t.to(dtype) for t in _torch(*_qkv(D=D))]
    with pytest.raises(exc):
        flash_attention(q, k, v)


def test_plain_path_is_differentiable_on_cpu():
    q, k, v = [t.requires_grad_() for t in _torch(*_qkv(T=16, D=16))]
    attention(q, k, v, causal=True).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


def test_work_counts_for_the_bound():
    # one full-width serving prefill layer: B1 H12 T1024 D64, causal
    assert attention_flops(1, 12, 1024, 1024, 64, True) \
        == 4 * 12 * 64 * 1024 * 1025 // 2
    assert attention_flops(1, 2, 8, 8, 4, False) == 4 * 2 * 4 * 64
    assert attention_bytes(1, 12, 1024, 1024, 64, 2) == 4 * 12 * 1024 * 64 * 2
