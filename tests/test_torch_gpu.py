"""The port's CUDA kernels against their plain versions, on the card:
the no-grad forward (``_flash_kernel``), the lse forward
(``_flash_kernel_lse``), the fused backward (``_flash_bwd_fused_kernel``)
and the split backward's dq and dk/dv passes (``_flash_bwd_dq_kernel``,
``_flash_bwd_dkv_kernel``); the gradient exchange over NCCL in a world of
one process, the double-buffered exchange's asynchrony and the sharded
exchanges against the plain one there, the two-level exchange (a 1 x 1
split on NCCL subgroups) and the quantized wires against the flat
exchange, and the quantization functions on the card against the CPU; the ResNet path's cuDNN layout,
its fp32 step against the CPU's and its remat step against the plain
one; and the ImageNet example's input pipeline and dropout on the card:
the device-feed stage's batches and copy stream, masks per step and per
seed, and the native loader's build; the DCGAN's transposed convolution
(cuDNN) and one DCGAN iteration on the card against the CPU; the host
channel's store adapter over a TCPStore, and an elastic rebuild of a
world of one onto a fresh NCCL world; the speculative verify step's span
writer and attention on the card against the CPU, an engine run with
speculation and chunked prefill against the same run on the CPU, and
engine runs with disaggregated prefill and with tensor parallelism over a
communicator of one against the same runs on the CPU; a serving fleet
killed and joined on the card against the same fleet on the CPU, each
fleet's joiner on the other device; and some of the last ``F`` and ``L``
surface (padding, clipping, unpooling, resizing, the five links in and
out of a ``Sequential``) and the numpy bridge on the card against the
CPU; the fused batch-norm kernels (``ops/batch_norm.py``) against their
plain version, and a ResNet-50 bf16 step through them.

Imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Without a card every test skips (the kernels have no CPU mode).
"""

import importlib
import json
import os
import statistics

import numpy as np
import pytest
import torch

from chainermn_tpu_torch.ops import attention, flash_attention, xla_attention

fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")

# bf16: the kernel and the plain version round p and the output to bf16 at
# different points; 2e-2 is a few bf16 ulps of |out| <= 4.  fp32: the
# kernel sums in another order and uses expf on CUDA cores.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# backward against its plain version.  bf16: each of dq, dk, dv relative
# to its own largest |ref| (_bwd_err); p and ds round to bf16 before the
# dots on both sides, but an fp32 difference in the last bit can flip a
# rounding, and the kernel's dq tiles add in another order.  fp32:
# absolute, sums in another order and expf on CUDA cores.
BWD_TOL = {torch.bfloat16: 5e-3, torch.float32: 2e-4}
# backward against torch autograd through xla_attention, same measure:
# autograd keeps ds in fp32 where the kernel casts it to bf16 before the
# dk and dq dots
AUTOGRAD_TOL = 2e-2

# the shapes chip_smoke.py's kernel_check_train covers, then the tile
# edges of the backward kernels (64-row q tiles and 64-key tiles: ragged
# ends on both sides, Tq != Tk both ways, causal and not, D 128):
# (B, H, Tq, Tk, D, causal, dtype)
TRAIN_CASES = [
    (2, 12, 1, 1, 64, True, torch.bfloat16),
    (2, 12, 16, 16, 64, True, torch.bfloat16),
    (2, 12, 200, 200, 64, True, torch.bfloat16),
    (2, 12, 1024, 1024, 64, True, torch.bfloat16),
    (2, 12, 128, 200, 64, False, torch.bfloat16),
    (2, 12, 200, 200, 128, True, torch.bfloat16),
    (2, 12, 200, 200, 64, True, torch.float32),
] + [(2, 3, T, T, 64, True, torch.bfloat16) for T in (63, 64, 65, 127, 129)
     ] + [
    (2, 3, 100, 300, 64, True, torch.bfloat16),
    (2, 3, 300, 100, 64, True, torch.bfloat16),
    (2, 3, 130, 70, 64, False, torch.bfloat16),
    (2, 3, 1, 65, 64, False, torch.bfloat16),
    (2, 3, 65, 1, 64, True, torch.bfloat16),
    (2, 3, 130, 70, 128, False, torch.bfloat16),
    (2, 3, 1024, 1024, 128, True, torch.bfloat16),
]

# the forward's cases: the training cases and the Hopper kernel's tile
# edges (ragged ends on both sides), Tq != Tk with and without causal, and
# every key tile _fwd_block_k picks: B * H small (B 1, H 12: 128 keys at D
# 64) and large (B 8, H 12: 64 keys; D 128 always 64)
FWD_CASES = TRAIN_CASES + [
    (1, 12, T, T, 64, True, torch.bfloat16)
    for T in (1, 63, 64, 65, 127, 128, 129, 255, 1024)] + [
    (2, 3, 128, 200, 64, False, torch.bfloat16),
    (2, 3, 200, 130, 64, False, torch.bfloat16),
    (2, 3, 100, 300, 64, True, torch.bfloat16),
    (2, 3, 300, 100, 64, True, torch.bfloat16),
    (1, 12, 1024, 1024, 128, True, torch.bfloat16),
    (8, 12, 1024, 1024, 64, True, torch.bfloat16),
    (8, 12, 1000, 1000, 64, True, torch.bfloat16),
    (8, 12, 1000, 700, 64, False, torch.bfloat16),
    (8, 12, 1024, 1024, 128, True, torch.bfloat16),
    (8, 12, 1000, 1000, 128, True, torch.bfloat16),
    (2, 12, 2048, 2048, 64, True, torch.bfloat16),
    (2, 3, 130, 130, 128, False, torch.float32),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _train_inputs(B, H, Tq, Tk, D, dtype, device, seed):
    """q, k, v and an output cotangent g, from numpy."""
    rng = np.random.RandomState(seed)
    shapes = [(B, H, Tq, D), (B, H, Tk, D), (B, H, Tk, D), (B, H, Tq, D)]
    return [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
            .to(device, dtype) for s in shapes]


def _bwd_err(got, ref, dtype):
    """Worst error over (dq, dk, dv), in the measure BWD_TOL states: for
    bf16 each relative to its own largest |ref|, floored at 2 ** -8 of the
    largest |ref| of the three (at T 1, dq and dk are rounding noise
    around 0 and have no scale of their own)."""
    errs = [(a.float() - b.float()).abs().max().item()
            for a, b in zip(got, ref)]
    if dtype == torch.float32:
        return max(errs)
    scales = [b.float().abs().max().item() for b in ref]
    floor = 2.0 ** -8 * max(scales)
    return max(e / max(s, floor) for e, s in zip(errs, scales))


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Tq,Tk,D,causal,dtype", FWD_CASES)
def test_flash_kernel_matches_plain(cuda_device, B, H, Tq, Tk, D, causal,
                                    dtype):
    q, k, v, _ = _train_inputs(B, H, Tq, Tk, D, dtype, cuda_device,
                               Tq + Tk + D)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = xla_attention(q, k, v, causal=causal)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() < TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
def test_forward_kernels_are_deterministic(cuda_device, D):
    """Two launches on the same inputs agree bitwise: the forward has no
    atomics and a fixed order of sums (every key tile of the bf16
    kernel)."""
    for B, T in ((1, 1000), (8, 1000)):
        q, k, v, _ = _train_inputs(B, 12, T, T, D, torch.bfloat16,
                                   cuda_device, B + D)
        a = fa.flash_attention_fwd(q, k, v, causal=True)
        b = fa.flash_attention_fwd(q, k, v, causal=True)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert torch.equal(flash_attention(q, k, v, causal=True),
                           flash_attention(q, k, v, causal=True))
        assert torch.equal(flash_attention(q, k, v, causal=True), a[0])


@pytest.mark.gpu
# the positive scale is below the default 1 / sqrt(D): a sharper softmax
# copies single values of v (|v| > 4) into out, where one bf16 ulp is
# 0.031, above TOL
@pytest.mark.parametrize("scale", [0.0, -0.125, 0.0625])
@pytest.mark.parametrize("D,dtype", [(64, torch.bfloat16),
                                     (128, torch.bfloat16),
                                     (64, torch.float32)])
def test_forward_takes_any_finite_scale(cuda_device, scale, D, dtype):
    """Both forwards at a scale of 0 (uniform attention over the live
    keys), a negative and a positive one, against their plain versions:
    ragged, causal and not, at both key tiles of the bf16 kernel."""
    for B, Tq, Tk, causal in ((1, 200, 200, True), (8, 300, 300, True),
                              (1, 130, 200, False)):
        q, k, v, _ = _train_inputs(B, 12, Tq, Tk, D, dtype, cuda_device,
                                   Tq + D)
        out = flash_attention(q, k, v, causal=causal, scale=scale)
        ref = xla_attention(q, k, v, causal=causal, scale=scale)
        assert (out.float() - ref.float()).abs().max().item() < TOL[dtype]
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                          scale=scale)
        ref_out, ref_lse = fa._flash_fwd_lse_plain(q, k, v, causal=causal,
                                                   scale=scale)
        assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
        assert (out.float() - ref_out.float()).abs().max().item() \
            < TOL[dtype]
        assert (lse - ref_lse).abs().max().item() < 1e-4


@pytest.mark.gpu
def test_flash_kernel_reads_strided_qkv(cuda_device):
    """The serving prefill hands the kernel q/k/v sliced out of one
    ``[B, T, 3, H, D]`` projection: strided, not contiguous."""
    B, T, H, D = 1, 300, 12, 64
    rng = np.random.RandomState(0)
    qkv = torch.from_numpy(rng.normal(0, 1, (B, T, 3, H, D)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    q, k, v = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    assert not q.is_contiguous()
    out = flash_attention(q, k, v, causal=True)
    ref = xla_attention(q, k, v, causal=True)
    assert (out.float() - ref.float()).abs().max().item() \
        < TOL[torch.bfloat16]


@pytest.mark.gpu
def test_grad_attention_launches_lse_forward_then_fused_backward(
        cuda_device):
    """A CUDA call that needs a gradient runs the lse forward, and the
    fused backward on ``.backward()``; the no-grad forward not at all."""
    q, k, v, g = _train_inputs(1, 2, 64, 64, 64, torch.bfloat16,
                               cuda_device, 0)
    for x in (q, k, v):
        x.requires_grad_()
    fwd, bwd, plain = (fa.flash_attention_fwd.launches,
                       fa.flash_attention_bwd.launches,
                       flash_attention.launches)
    out = attention(q, k, v, causal=True)
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches,
            flash_attention.launches) == (fwd + 1, bwd, plain)
    out.backward(g)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches,
            flash_attention.launches) == (fwd + 1, bwd + 1, plain)
    assert all(torch.isfinite(x.grad.float()).all() for x in (q, k, v))


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Tq,Tk,D,causal,dtype", FWD_CASES)
def test_lse_forward_matches_plain(cuda_device, B, H, Tq, Tk, D, causal,
                                   dtype):
    q, k, v, _ = _train_inputs(B, H, Tq, Tk, D, dtype, cuda_device, Tq + D)
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    ref_out, ref_lse = fa._flash_fwd_lse_plain(q, k, v, causal=causal)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Tq)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert (out.float() - ref_out.float()).abs().max().item() < TOL[dtype]
    # lse is fp32 on both sides: log of a sum in another order
    assert (lse - ref_lse).abs().max().item() < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Tq,Tk,D,causal,dtype", TRAIN_CASES)
def test_fused_backward_matches_plain(cuda_device, B, H, Tq, Tk, D, causal,
                                      dtype):
    q, k, v, g = _train_inputs(B, H, Tq, Tk, D, dtype, cuda_device, Tk + D)
    out, lse = fa._flash_fwd_lse_plain(q, k, v, causal=causal)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    delta = (g.float() * out.float()).sum(-1)
    ref = fa._flash_bwd_plain(q, k, v, g, lse, delta, causal=causal)
    assert all(torch.isfinite(x.float()).all() for x in got)
    assert _bwd_err(got, ref, dtype) < BWD_TOL[dtype]


@pytest.mark.gpu
def test_fused_backward_with_lse_cotangent(cuda_device):
    B, H, T, D = 2, 12, 200, 64
    q, k, v, g = _train_inputs(B, H, T, T, D, torch.bfloat16, cuda_device, 1)
    g_lse = torch.from_numpy(np.random.RandomState(2).normal(
        0, 1, (B, H, T)).astype(np.float32)).to(cuda_device)
    out, lse = fa._flash_fwd_lse_plain(q, k, v, causal=True)
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True,
                                 g_lse=g_lse)
    delta = (g.float() * out.float()).sum(-1) - g_lse
    ref = fa._flash_bwd_plain(q, k, v, g, lse, delta, causal=True)
    assert _bwd_err(got, ref, torch.bfloat16) < BWD_TOL[torch.bfloat16]


@pytest.mark.gpu
def test_lse_kernels_read_strided_inputs(cuda_device):
    """Training slices q/k/v out of one ``[B, T, 3, H, D]`` projection
    and hands the backward a transposed cotangent."""
    B, T, H, D = 2, 300, 12, 64
    rng = np.random.RandomState(3)
    qkv = torch.from_numpy(rng.normal(0, 1, (B, T, 3, H, D)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    q, k, v = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    g = torch.from_numpy(rng.normal(0, 1, (B, T, H, D)).astype(
        np.float32)).to(cuda_device, torch.bfloat16).transpose(1, 2)
    assert not q.is_contiguous() and not g.is_contiguous()
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ref_out, ref_lse = fa._flash_fwd_lse_plain(q, k, v, causal=True)
    assert (out.float() - ref_out.float()).abs().max().item() \
        < TOL[torch.bfloat16]
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    delta = (g.float() * out.float()).sum(-1)
    ref = fa._flash_bwd_plain(q, k, v, g, lse, delta, causal=True)
    assert _bwd_err(got, ref, torch.bfloat16) < BWD_TOL[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("Tq,Tk,causal", [(200, 200, True),
                                          (128, 200, False)])
def test_kernels_match_autograd_through_plain_attention(cuda_device, Tq, Tk,
                                                        causal):
    """The whole differentiable path against torch autograd through
    xla_attention, in bf16 (where the two round ds differently:
    AUTOGRAD_TOL)."""
    q, k, v, g = _train_inputs(2, 12, Tq, Tk, 64, torch.bfloat16,
                               cuda_device, 4)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    attention(*leaves, causal=causal).backward(g)
    got = [x.grad for x in leaves]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    xla_attention(*leaves, causal=causal).backward(g)
    ref = [x.grad for x in leaves]
    assert _bwd_err(got, ref, torch.bfloat16) < AUTOGRAD_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Tq,Tk,D,causal,dtype", TRAIN_CASES)
def test_split_backward_kernels_match_plain_and_fused(cuda_device, B, H, Tq,
                                                      Tk, D, causal, dtype):
    """The dq pass and the dk/dv pass against their plain versions and
    against the fused kernel B2 (the same math; B2's dq sums in another
    order), in BWD_TOL's measure; a second dq pass is bitwise the first
    (no atomics, a fixed order of sums)."""
    q, k, v, g = _train_inputs(B, H, Tq, Tk, D, dtype, cuda_device, Tq + 3)
    out, lse = fa._flash_fwd_lse_plain(q, k, v, causal=causal)
    delta = (g.float() * out.float()).sum(-1)
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    dq = fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, causal=causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta,
                                        causal=causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                     before[1] + 1)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    assert all(torch.isfinite(x.float()).all() for x in (dq, dk, dv))
    ref = (fa._flash_bwd_dq_plain(q, k, v, g, lse, delta, causal=causal),
           *fa._flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal=causal))
    assert _bwd_err((dq, dk, dv), ref, dtype) < BWD_TOL[dtype]
    fused = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    assert _bwd_err((dq, dk, dv), fused, dtype) < BWD_TOL[dtype]
    assert torch.equal(dq, fa.flash_attention_bwd_dq(q, k, v, g, lse, delta,
                                                     causal=causal))


@pytest.mark.gpu
# the positive scale is below the default 1 / sqrt(D), as in the forward's
# scale test
@pytest.mark.parametrize("scale", [None, 0.0, -0.125, 0.0625])
@pytest.mark.parametrize("D", [64, 128])
def test_split_mode_backward_is_deterministic_and_reads_strides(
        cuda_device, monkeypatch, D, scale):
    """``_FLASH_BWD = "split"`` sends the autograd backward through the
    two kernels (strided q/k/v and a transposed cotangent, as the model
    hands them over) at any finite scale; neither pass has atomics, so two
    runs agree bitwise.  Then a non-zero lse cotangent through the split
    ``flash_attention_bwd``, twice, bitwise, against the plain versions."""
    B, T, H = 2, 300, 12
    rng = np.random.RandomState(5)
    qkv = torch.from_numpy(rng.normal(0, 1, (B, T, 3, H, D)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    g = torch.from_numpy(rng.normal(0, 1, (B, T, H, D)).astype(
        np.float32)).to(cuda_device, torch.bfloat16).transpose(1, 2)
    monkeypatch.setattr(fa, "_FLASH_BWD", "split")
    runs = []
    for _ in range(2):
        leaves = [qkv[:, :, i].transpose(1, 2).detach().requires_grad_()
                  for i in range(3)]
        before = (fa.flash_attention_bwd.launches,
                  fa.flash_attention_bwd_dq.launches,
                  fa.flash_attention_bwd_dkv.launches)
        attention(*leaves, causal=True, scale=scale).backward(g)
        torch.cuda.synchronize()
        assert (fa.flash_attention_bwd.launches,
                fa.flash_attention_bwd_dq.launches,
                fa.flash_attention_bwd_dkv.launches) == (
                    before[0], before[1] + 1, before[2] + 1)
        runs.append([x.grad for x in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    leaves = [qkv[:, :, i].transpose(1, 2).detach().requires_grad_()
              for i in range(3)]
    xla_attention(*leaves, causal=True, scale=scale).backward(g)
    assert _bwd_err(runs[0], [x.grad for x in leaves],
                    torch.bfloat16) < AUTOGRAD_TOL

    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    g_lse = torch.from_numpy(rng.normal(0, 1, (B, H, T)).astype(
        np.float32)).to(cuda_device)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, scale=scale)
    got = [fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True,
                                  scale=scale, g_lse=g_lse)
           for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*got))
    ref = fa._flash_bwd_plain(q, k, v, g, lse,
                              fa._bwd_delta_plain(g, out, g_lse),
                              causal=True, scale=scale)
    assert _bwd_err(got[0], ref, torch.bfloat16) < BWD_TOL[torch.bfloat16]


@pytest.mark.gpu
def test_nccl_world_of_one_mean_grad_leaves_fp32_gradients(cuda_device):
    """``multi_node_mean_grad`` over NCCL with one rank: a lossless wire
    leaves every fp32 gradient bitwise as it was (one flat bucket); a
    bf16 wire rounds it to bf16 and back."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.models import TransformerLM
    model = TransformerLM(n_vocab=97, d_model=64, n_heads=1, n_layers=2,
                          max_len=32, seed=0, device=cuda_device)
    x = torch.from_numpy(np.random.RandomState(6).randint(0, 97, (2, 32)))
    x = x.to(cuda_device)
    model(x, torch.roll(x, -1, 1)).backward()
    raw = {p: v.grad.clone() for p, v in model.namedparams()}
    comm = create_communicator("pure_nccl")
    try:
        assert comm.size == 1 and dist.get_backend() == "nccl"
        comm.multi_node_mean_grad(model)
        torch.cuda.synchronize()
        assert comm.calls["allreduce_grad"] == 1
        for p, v in model.namedparams():
            assert v.grad.dtype == torch.float32
            assert torch.equal(v.grad, raw[p]), p
        wire = create_communicator("pure_nccl",
                                   allreduce_grad_dtype="bfloat16")
        wire.multi_node_mean_grad(model)
        torch.cuda.synchronize()
        for p, v in model.namedparams():
            assert torch.equal(v.grad, raw[p].bfloat16().float()), p
    finally:
        comm.finalize()
    assert not dist.is_initialized()


@pytest.mark.gpu
def test_nccl_world_of_one_hierarchical_exchange_equals_pure_nccl(
        cuda_device):
    """A world of one on the card: the two-level exchange (a 1 x 1 split,
    two NCCL subgroups of one rank) leaves every gradient bitwise as
    ``pure_nccl``'s on the same wire (lossless, bf16, the int8 inter-node
    hop against the flat int8 wire, residuals included), synchronously
    and launched on its side stream; its reduce-scatter chain and
    all-gather give back the flat vector."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.models import TransformerLM
    model = TransformerLM(n_vocab=97, d_model=64, n_heads=1, n_layers=2,
                          max_len=32, seed=0, device=cuda_device)
    x = torch.from_numpy(np.random.RandomState(6).randint(0, 97, (2, 32)))
    x = x.to(cuda_device)
    model(x, torch.roll(x, -1, 1)).backward()
    raw = {p: v.grad.clone() for p, v in model.namedparams()}
    comms = {}

    def make(*args, **kw):
        comms[len(comms)] = create_communicator(*args, **kw)
        return comms[len(comms) - 1]

    def exchanged(comm, residual=None):
        for p, v in model.namedparams():
            v.grad = raw[p].clone()
        res = comm.multi_node_mean_grad(model, residual=residual)
        torch.cuda.synchronize()
        return {p: v.grad.clone() for p, v in model.namedparams()}, res

    try:
        for flat_kw, hier_kw in (
                ({}, {}),
                (dict(allreduce_grad_dtype="bfloat16"),
                 dict(allreduce_grad_dtype={"dcn": "bfloat16"})),
                (dict(allreduce_grad_dtype="bfloat16"),
                 dict(allreduce_grad_dtype="bfloat16"))):
            flat = make("pure_nccl", **flat_kw)
            hier = make("hierarchical", **hier_kw)
            assert hier.hierarchy and (hier.dcn_size, hier.ici_size) == (1, 1)
            assert [dist.get_backend(g) for g in hier._hop_groups] \
                == ["nccl", "nccl"]
            want, _ = exchanged(flat)
            got, _ = exchanged(hier)
            assert all(torch.equal(got[p], want[p]) for p in want)
            assert hier.calls["ici_reduce_scatter"] == 1
        q_flat = make("pure_nccl", allreduce_grad_dtype="int8")
        q_hier = make("hierarchical", allreduce_grad_dtype={"dcn": "int8"})
        n = q_flat.grad_residual_len_for(model)
        assert n == q_hier.grad_residual_len_for(model) > 0
        r0 = torch.linspace(-1e-3, 1e-3, n, device=cuda_device)
        want, want_res = exchanged(q_flat, r0)
        got, got_res = exchanged(q_hier, r0)
        assert all(torch.equal(got[p], want[p]) for p in want)
        assert torch.equal(got_res, want_res)
        # the chain and its side stream
        flat = torch.randn(4096, device=cuda_device)
        chunk = q_hier.reduce_scatter_grad(flat, residual=r0[:4096]).wait()
        pending = q_hier.reduce_scatter_grad(flat, async_op=True,
                                             residual=r0[:4096])
        assert torch.equal(pending.wait(), chunk)
        lossless = comms[1]
        assert torch.equal(lossless.allgather_flat(
            lossless.reduce_scatter_grad(flat).wait()), flat)
    finally:
        for comm in reversed(comms.values()):
            comm.finalize()
    assert not dist.is_initialized()


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ["int8", "float8_e4m3", "float8_e5m2"])
def test_quantization_on_the_card_equals_the_cpu(cuda_device, wire):
    """``quantize_symmetric``, ``quantize_with_feedback`` and
    ``dequantize_sum`` give the same bits on the card as on the CPU: a
    gradient buffer, an all-zero one and one holding +-inf and NaN."""
    from chainermn_tpu_torch.communicators import _memory_utility as mu
    rng = np.random.RandomState(3)
    buffers = [rng.normal(0, 2e-3, 100003).astype(np.float32),
               np.zeros(4096, np.float32),
               np.asarray([1.0, -2.0, np.inf, -np.inf, np.nan, 0.5] * 9,
                          np.float32)]
    for v in buffers:
        v = torch.from_numpy(v)
        residual = torch.from_numpy(
            rng.normal(0, 1e-4, v.numel()).astype(np.float32))
        cpu = mu.quantize_with_feedback(v, residual, wire)
        card = mu.quantize_with_feedback(v.to(cuda_device),
                                         residual.to(cuda_device), wire)
        for a, b in zip(cpu, card):
            assert torch.equal(a.float(), b.cpu().float())
        q, s = mu.quantize_symmetric(v.to(cuda_device), wire)
        assert torch.equal(q.cpu().float(), mu.quantize_symmetric(
            v, wire)[0].float())
        rows = [mu.quantize_symmetric(v * (k + 1), wire) for k in range(4)]
        qs, ss = torch.stack([r[0] for r in rows]), torch.stack(
            [r[1] for r in rows])
        assert torch.equal(mu.dequantize_sum(qs, ss), mu.dequantize_sum(
            qs.to(cuda_device), ss.to(cuda_device)).cpu())


# the Hopper backward's tile edges (64-row q tiles, 64-key tiles), Tq !=
# Tk both ways, D 128:
# (B, H, Tq, Tk, D, causal)
HOPPER_BWD_CASES = [
    (2, 3, T, T, 64, True) for T in (1, 63, 64, 65, 127, 129, 1024)] + [
    (2, 3, 128, 200, 64, False), (2, 3, 200, 130, 64, False),
    (2, 3, 100, 300, 64, True), (2, 3, 300, 100, 64, True),
    (2, 3, 1, 65, 64, False), (2, 3, 200, 200, 128, True),
    (2, 3, 130, 70, 128, False), (1, 12, 1024, 1024, 128, True)]


def _strided_train_inputs(B, H, T, D, device, seed):
    """q, k, v sliced out of one ``[B, T, 3, H, D]`` projection and a
    transposed ``[B, T, H, D]`` cotangent, as the model hands them over."""
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.normal(0, 1, (B, T, 3, H, D)).astype(
        np.float32)).to(device, torch.bfloat16)
    g = torch.from_numpy(rng.normal(0, 1, (B, T, H, D)).astype(
        np.float32)).to(device, torch.bfloat16).transpose(1, 2)
    return [qkv[:, :, i].transpose(1, 2) for i in range(3)] + [g]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Tq,Tk,D,causal", HOPPER_BWD_CASES)
def test_hopper_backward_matches_plain(cuda_device, B, H, Tq, Tk, D,
                                       causal):
    """The bf16 Hopper kernels -- the backward in both modes, fused (dq,
    dk, dv) and the split backward's dk/dv pass, and the split backward's
    dq pass -- against their plain versions."""
    q, k, v, g = _train_inputs(B, H, Tq, Tk, D, torch.bfloat16, cuda_device,
                               Tq + 7 * Tk + D)
    out, lse = fa._flash_fwd_lse_plain(q, k, v, causal=causal)
    delta = fa._bwd_delta_plain(g, out)
    ref = fa._flash_bwd_plain(q, k, v, g, lse, delta, causal=causal)
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    dq = fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, causal=causal)
    dkv = fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert all(torch.isfinite(x.float()).all() for x in (*got, dq, *dkv))
    assert _bwd_err(got, ref, torch.bfloat16) < BWD_TOL[torch.bfloat16]
    assert _bwd_err((dq, *dkv), ref, torch.bfloat16) \
        < BWD_TOL[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [0.0, -0.125, 0.0625])
@pytest.mark.parametrize("D", [64, 128])
def test_hopper_backward_strided_any_scale_and_lse_cotangent(cuda_device,
                                                             scale, D):
    """Strided q/k/v with a transposed g, a non-zero lse cotangent, and
    scales of 0, below 0 and above 0, in both modes and the dq pass."""
    B, H, T = 2, 12, 300
    q, k, v, g = _strided_train_inputs(B, H, T, D, cuda_device, D)
    assert not q.is_contiguous() and not g.is_contiguous()
    g_lse = torch.from_numpy(np.random.RandomState(D + 1).normal(
        0, 1, (B, H, T)).astype(np.float32)).to(cuda_device)
    out, lse = fa._flash_fwd_lse_plain(q, k, v, causal=True, scale=scale)
    delta = fa._bwd_delta_plain(g, out, g_lse)
    ref = fa._flash_bwd_plain(q, k, v, g, lse, delta, causal=True,
                              scale=scale)
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True,
                                 scale=scale, g_lse=g_lse)
    dq = fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, causal=True,
                                   scale=scale)
    dkv = fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal=True,
                                     scale=scale)
    assert _bwd_err(got, ref, torch.bfloat16) < BWD_TOL[torch.bfloat16]
    assert _bwd_err((dq, *dkv), ref, torch.bfloat16) \
        < BWD_TOL[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
def test_hopper_backward_dk_dv_are_deterministic(cuda_device, D):
    """dk and dv have no atomics: two calls agree bitwise in both modes
    (fused dq's low bits depend on the order of the bulk adds)."""
    q, k, v, g = _strided_train_inputs(8, 12, 1024, D, cuda_device, 3)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    delta = fa.flash_attention_bwd_delta(g, out)
    a = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    b = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    c = fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal=True)
    d = fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal=True)
    assert torch.equal(c[0], d[0]) and torch.equal(c[1], d[1])
    # the same products and sums in both modes
    assert torch.equal(a[1], c[0]) and torch.equal(a[2], c[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128])
def test_delta_pass_and_dq_epilogue_match_plain(cuda_device, dtype, D):
    """The delta pass (strided g, with and without g_lse) against its
    plain version: fp32 sums in another order, 1e-4 for |delta| < 64; the
    dq epilogue bitwise against the scale and cast of the fp32
    accumulator it reads (one fp32 multiply and one rounding on both
    sides)."""
    B, H, T = 2, 12, 300
    rng = np.random.RandomState(D)
    out = torch.from_numpy(rng.normal(0, 1, (B, H, T, D)).astype(
        np.float32)).to(cuda_device, dtype)
    g = torch.from_numpy(rng.normal(0, 1, (B, T, H, D)).astype(
        np.float32)).to(cuda_device, dtype).transpose(1, 2)
    g_lse = torch.from_numpy(rng.normal(0, 1, (B, H, T)).astype(
        np.float32)).to(cuda_device)
    for gl in (None, g_lse):
        before = fa.flash_attention_bwd_delta.launches
        got = fa.flash_attention_bwd_delta(g, out, gl)
        assert fa.flash_attention_bwd_delta.launches == before + 1
        ref = fa._bwd_delta_plain(g, out, gl)
        assert got.shape == (B, H, T) and got.dtype == torch.float32
        assert (got - ref).abs().max().item() < 1e-4
    q, k, v, _ = _train_inputs(B, H, T, T, D, dtype, cuda_device, 5)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    for scale in (None, -0.125):
        s = fa._scale(scale, D)
        acc, dq, _, _ = fa._fused_bwd(q, k, v, o, lse, g, True, s, g_lse)
        assert dq.dtype == dtype
        assert torch.equal(dq, (acc * s).to(dtype))


@pytest.mark.gpu
def test_nhwc_convolution_and_pooling_stay_channels_last(cuda_device):
    """An NHWC bf16 convolution (the link casts its fp32 kernel to bf16
    channels-last in one copy) and max pooling return NHWC-contiguous
    tensors, and cuDNN converts no layout on the way."""
    from torch.profiler import ProfilerActivity, profile
    from chainermn_tpu_torch.nn import functions as F
    from chainermn_tpu_torch.nn import links as L
    conv = L.Convolution2D(64, 128, 3, pad=1, nobias=True, seed=0,
                           layout="NHWC", device=cuda_device)
    x = torch.randn(8, 28, 28, 64, device=cuda_device).bfloat16()
    conv(x)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = conv(x)
        z = F.max_pooling_2d(y, 3, stride=2, pad=1, cover_all=False,
                             layout="NHWC")
        torch.cuda.synchronize()
    assert y.shape == (8, 28, 28, 128) and y.is_contiguous()
    assert z.shape == (8, 14, 14, 128) and z.is_contiguous()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and not [n for n in names
                          if "nchwToNhwc" in n or "nhwcToNchw" in n], names


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_resnet_fp32_steps_on_the_card_match_the_cpu(cuda_device, layout):
    """The small fp32 ResNet of the CPU tests, 3 ``MomentumSGD`` steps on
    the card with TF32 off against the same steps on the CPU.  Tolerances
    as the data-parallel tests against the JAX package (lr 1e-3, so that
    a ReLU kink crossed on one side only stays inside them): losses 1e-4
    relative, parameters and running statistics 1e-3 absolute."""
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.models import Classifier, ResNet
    rng = np.random.RandomState(4)
    shape = (8, 16, 16, 3) if layout == "NHWC" else (8, 3, 16, 16)
    batches = [(rng.normal(0, 1, shape).astype(np.float32),
                rng.randint(0, 10, 8)) for _ in range(3)]
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = []
        for device in (cuda_device, torch.device("cpu")):
            model = Classifier(ResNet([1, 1, 1, 1], n_classes=10, seed=0,
                                      layout=layout, device=device))
            opt = MomentumSGD(lr=1e-3, momentum=0.9).setup(model)
            losses = [opt.update(model, torch.from_numpy(x).to(device),
                                 torch.from_numpy(t).to(device)).item()
                      for x, t in batches]
            state = {p: v.detach().cpu() for p, v in model.namedparams()}
            state.update((p, v.cpu()) for p, v in model.namedpersistent())
            runs.append((losses, state))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    (losses, state), (ref_losses, ref_state) = runs
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert sorted(state) == sorted(ref_state)
    for p, v in ref_state.items():
        np.testing.assert_allclose(state[p].numpy(), v.numpy(), rtol=0,
                                   atol=1e-3, err_msg=p)


def _mlp_step_inputs(device):
    rng = np.random.RandomState(8)
    return (torch.from_numpy(rng.normal(0, 1, (32, 24)).astype(np.float32))
            .to(device), torch.from_numpy(rng.randint(0, 5, 32)).to(device))


def _mlp_run(comm, device, steps, **exchange):
    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.models import MLP, Classifier
    model = Classifier(MLP(n_units=64, n_out=5, seed=0, device=device))
    opt = create_multi_node_optimizer(MomentumSGD(lr=0.1), comm,
                                      **exchange).setup(model)
    x, t = _mlp_step_inputs(device)
    losses = [opt.update(model, x, t).item() for _ in range(steps)]
    return model, opt, losses


@pytest.mark.gpu
def test_double_buffered_exchange_is_asynchronous(cuda_device, monkeypatch):
    """Each step launches its gradient allreduce with ``async_op=True``
    and waits only on the previous step's: the order of launches and
    waits, recorded by wrapping the work handles, is launch 0, launch 1,
    wait 0, launch 2, wait 1.  Where NCCL runs a kernel for it (a world
    of one may copy nothing), that kernel runs on another stream than
    the step's compute kernels."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from chainermn_tpu_torch import create_communicator
    events = []
    all_reduce = dist.all_reduce

    class Work:
        def __init__(self, work, i):
            self.work, self.i = work, i

        def wait(self):
            events.append(("wait", self.i))
            return self.work.wait()

    def recording(tensor, *args, async_op=False, **kwargs):
        work = all_reduce(tensor, *args, async_op=async_op, **kwargs)
        if not async_op:
            return work
        events.append(("launch", len([e for e in events
                                      if e[0] == "launch"])))
        return Work(work, events[-1][1])

    comm = create_communicator("pure_nccl")
    try:
        monkeypatch.setattr(dist, "all_reduce", recording)
        model, opt, losses = _mlp_run(comm, cuda_device, 3,
                                      double_buffering=True)
        assert events == [("launch", 0), ("launch", 1), ("wait", 0),
                          ("launch", 2), ("wait", 1)]
        monkeypatch.setattr(dist, "all_reduce", all_reduce)
        x, t = _mlp_step_inputs(cuda_device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                opt.update(model, x, t)
            torch.cuda.synchronize()
        opt._reset_exchange()
    finally:
        comm.finalize()
    path = "build/test_double_buffered_streams.json"
    os.makedirs("build", exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        kernels = [e for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    nccl = {e["args"].get("stream") for e in kernels
            if "nccl" in e["name"].lower()}
    compute = {e["args"].get("stream") for e in kernels
               if "nccl" not in e["name"].lower()}
    assert compute and not (nccl & compute)
    assert np.isfinite(losses).all()


@pytest.mark.gpu
def test_sharded_exchanges_equal_the_plain_step_at_a_world_of_one(
        cuda_device):
    """``exchange="reduce_scatter"`` and ``zero_sharding`` over NCCL with
    one rank: the same fp32 rule on a flat view of the parameters, so
    the losses and parameters are bitwise the plain DP step's, and the
    gradient never lands on ``Parameter.grad``."""
    from chainermn_tpu_torch import create_communicator
    comm = create_communicator("pure_nccl")
    try:
        runs = {name: _mlp_run(comm, cuda_device, 3, **kw)
                for name, kw in (("plain", {}),
                                 ("rs", dict(exchange="reduce_scatter")),
                                 ("zero", dict(zero_sharding=True)))}
    finally:
        comm.finalize()
    plain_model, _, plain_losses = runs["plain"]
    for name in ("rs", "zero"):
        model, opt, losses = runs[name]
        assert losses == plain_losses, name
        for (p, a), (_, b) in zip(model.namedparams(),
                                  plain_model.namedparams()):
            assert torch.equal(a, b), (name, p)
        assert all(p.grad is None for p in model.parameters())
        assert opt.actual_optimizer._state["flat"]["trace"].numel() \
            == opt._flat_layout()[1]


@pytest.mark.gpu
def test_prefetched_batches_equal_the_base_and_copy_on_a_side_stream(
        cuda_device, tmp_path):
    """The device-feed stage's batches, byte for byte the base iterator's
    stacked batches, copied from pinned memory on a stream other than the
    one the step's kernels run on."""
    from torch.profiler import ProfilerActivity, profile

    from chainermn_tpu_torch.dataset import (DevicePrefetchIterator,
                                             SerialIterator, concat_examples)
    rng = np.random.RandomState(0)
    data = [(rng.randint(0, 256, (3, 32, 32)).astype(np.uint8),
             np.int32(i)) for i in range(24)]
    ref = SerialIterator(data, 4, shuffle=True, seed=5)
    pref = DevicePrefetchIterator(SerialIterator(data, 4, shuffle=True,
                                                 seed=5),
                                  size=2, converter=concat_examples)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            x, t = pref.next()
            (x.float() * 2).sum()   # a kernel on the consumer's stream
            want = concat_examples(ref.next())
            assert x.device.type == "cuda" and x.dtype == torch.uint8
            assert np.array_equal(x.cpu().numpy(), want[0])
            assert np.array_equal(t.cpu().numpy(), want[1])
        torch.cuda.synchronize()
    pref.finalize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    copies = [e for e in events if "HtoD" in e.get("name", "")]
    kernels = {e["args"].get("stream") for e in events
               if e.get("cat") == "kernel"}
    assert copies and all("Pinned" in e["name"] for e in copies)
    assert not {e["args"].get("stream") for e in copies} & kernels
    assert pref.h2d_bytes == pref.h2d_batches * 4 * (3 * 32 * 32 + 4)


@pytest.mark.gpu
def test_dropout_on_the_card_per_seed_and_per_step(cuda_device):
    from chainermn_tpu_torch.core import rng
    from chainermn_tpu_torch.core.link import Chain
    from chainermn_tpu_torch.core.optimizer import SGD
    from chainermn_tpu_torch.nn import functions as F
    from chainermn_tpu_torch.nn import links as L

    x = torch.ones(4096, device=cuda_device)
    key = rng.make_key(3)
    masks = []
    for _ in range(2):
        with rng.key_scope(key, cuda_device):
            assert rng.next_key().device.type == "cuda"
            masks.append(F.dropout(x, 0.5) != 0)
    assert torch.equal(masks[0], masks[1])

    class Dropper(Chain):
        def __init__(self):
            super().__init__()
            self.l1 = L.Linear(8, 64, seed=0, device=cuda_device)

        def forward(self, x, t):
            return F.softmax_cross_entropy(F.dropout(self.l1(x)), t)

    r = np.random.RandomState(2)
    xb = torch.from_numpy(r.normal(0, 1, (16, 8)).astype(np.float32)) \
        .to(cuda_device)
    tb = torch.from_numpy(r.randint(0, 64, 16)).to(cuda_device)
    runs = []
    for seed in (0, 0, 1):
        model = Dropper()
        opt = SGD(lr=0.0)
        opt.seed = seed
        opt.setup(model)
        runs.append([opt.update(model, xb, tb).item() for _ in range(3)])
    assert runs[0] == runs[1]             # the same seed: the same masks
    assert len(set(runs[0])) == 3         # new masks every step
    assert runs[2] != runs[0]


@pytest.mark.gpu
def test_resnet_remat_equals_no_remat_on_the_card(cuda_device):
    """The small fp32 ResNet with and without remat, 3 MomentumSGD steps
    (TF32 off, deterministic cuDNN): losses, parameters and running
    statistics within 1e-5 relative."""
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.models import Classifier, ResNet
    rng = np.random.RandomState(4)
    batches = [(torch.from_numpy(rng.normal(0, 1, (8, 16, 16, 3)).astype(
        np.float32)).to(cuda_device),
        torch.from_numpy(rng.randint(0, 10, 8)).to(cuda_device))
        for _ in range(3)]
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for remat in (False, True):
            model = Classifier(ResNet([1, 1, 1, 1], n_classes=10, seed=0,
                                      layout="NHWC", remat=remat,
                                      device=cuda_device))
            opt = MomentumSGD(lr=1e-3, momentum=0.9).setup(model)
            losses = [opt.update(model, x, t).item() for x, t in batches]
            state = {p: v.detach().cpu() for p, v in model.namedparams()}
            state.update((p, v.cpu()) for p, v in model.namedpersistent())
            runs[remat] = (losses, state)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = saved
    np.testing.assert_allclose(runs[True][0], runs[False][0], rtol=1e-5)
    for p, v in runs[False][1].items():
        got = runs[True][1][p]
        if v.is_floating_point():
            scale = max(v.abs().max().item(), 1e-30)
            assert (got - v).abs().max().item() <= 1e-5 * scale, p
        else:
            assert torch.equal(got, v), p


@pytest.mark.gpu
def test_native_loader_builds_from_the_repo_and_raises_when_broken(
        cuda_device, tmp_path):
    """With a card present, the C++ gather engine builds from the repo's
    copy; a broken source raises, and the iterator runs no other loader
    in its place."""
    from chainermn_tpu_torch.dataset import NativeBatchIterator, TupleDataset
    from chainermn_tpu_torch.utils import native
    lib = native.load_library()
    assert lib is not None and native.library_path().exists()
    x = np.arange(64, dtype=np.float32).reshape(32, 2)
    y = np.arange(32, dtype=np.int32)
    it = NativeBatchIterator(TupleDataset(x, y), 8, shuffle=False)
    bx, by = it.next()
    it.finalize()
    assert np.array_equal(bx, x[:8]) and np.array_equal(by, y[:8])
    bad = tmp_path / "dataloader.cpp"
    bad.write_text("int broken(\n")
    with pytest.raises(native.NativeBuildFailed):
        native.load_library(bad)


def _profiled_trace(fn, tmp_path):
    """``fn()`` under ``torch.profiler`` (host and card): its Chrome
    trace's events."""
    import json
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


@pytest.mark.gpu
def test_striped_paths_run_on_two_side_streams(cuda_device, tmp_path):
    """A world of one on the card (a 1 x 1 split): the striped exchange
    leaves every gradient bitwise as ``pure_nccl``'s, and under
    ``CHAINERMN_TPU_TRACE=full`` the work inside each path's
    ``train.grad_exchange.bucket*`` ranges runs on that path's own side
    stream: two streams, neither the one the caller runs on."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator, observability
    from chainermn_tpu_torch.communicators.mesh_communicator import \
        STRIPED_OP_PATH
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.utils import annotate, device_ops_in_ranges
    model = TransformerLM(n_vocab=97, d_model=64, n_heads=1, n_layers=2,
                          max_len=32, seed=0, device=cuda_device)
    x = torch.from_numpy(np.random.RandomState(6).randint(0, 97, (2, 32)))
    x = x.to(cuda_device)
    model(x, torch.roll(x, -1, 1)).backward()
    raw = {p: v.grad.clone() for p, v in model.namedparams()}
    flat = create_communicator("pure_nccl")
    prev = observability.set_mode("full")
    try:
        striped = create_communicator(
            "hierarchical", stripe_ratio=0.25,
            allreduce_grad_dtype={"dcn": "bfloat16"})
        lossless = create_communicator("hierarchical", stripe_ratio=0.25)
        flat.multi_node_mean_grad(model)
        want = {p: v.grad.clone() for p, v in model.namedparams()}
        for p, v in model.namedparams():
            v.grad = raw[p].clone()
        lossless.multi_node_mean_grad(model)
        torch.cuda.synchronize()
        assert all(torch.equal(v.grad, want[p])
                   for p, v in model.namedparams())

        def exchange():
            with annotate("caller"):   # the caller's own work
                model.cleargrads()
                model(x, torch.roll(x, -1, 1)).backward()
            striped.multi_node_mean_grad(model)

        events = _profiled_trace(exchange, tmp_path)
    finally:
        observability.set_mode(prev)
        flat.finalize()
    assert not dist.is_initialized()
    caller = {op["args"]["stream"]
              for _, op in device_ops_in_ranges(events, "caller")}
    streams = {"dcn": set(), "ici": set()}
    for name, op in device_ops_in_ranges(events, "train.grad_exchange."):
        path = STRIPED_OP_PATH.get(name.rsplit(".", 1)[-1])
        if path and op.get("cat") == "kernel" \
                and "nccl" not in op["name"].lower():
            streams[path].add(op["args"]["stream"])
    assert len(streams["dcn"]) == len(streams["ici"]) == 1, streams
    assert streams["dcn"] != streams["ici"], streams
    assert caller and not (streams["dcn"] | streams["ici"]) & caller, \
        (streams, caller)


@pytest.mark.gpu
def test_full_mode_ranges_hold_the_steps_device_work(cuda_device,
                                                      tmp_path):
    """Under ``CHAINERMN_TPU_TRACE=full`` a multi-node optimizer step on
    the card opens ``record_function`` ranges with the span tracer's
    names: the ``train.grad_exchange`` span around the exchange, and in
    it the per-bucket hop ranges, which hold the exchange's copies and
    kernels."""
    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer,
                                     observability)
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.models import MLP, Classifier
    from chainermn_tpu_torch.utils import device_ops_in_ranges
    prev = observability.set_mode("full")
    comm = create_communicator("hierarchical", stripe_ratio=0.5)
    try:
        model = Classifier(MLP(n_units=64, n_out=10, seed=0,
                               device=cuda_device))
        opt = create_multi_node_optimizer(MomentumSGD(lr=0.1),
                                          comm).setup(model)
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.normal(0, 1, (16, 32)).astype(
            np.float32)).to(cuda_device)
        t = torch.from_numpy(rng.randint(0, 10, 16)).to(cuda_device)
        opt.update(model, x, t)
        events = _profiled_trace(lambda: opt.update(model, x, t), tmp_path)
    finally:
        observability.set_mode(prev)
        comm.finalize()
    assert not dist.is_initialized()
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert "train.grad_exchange" in names, sorted(names)[:20]
    hops = device_ops_in_ranges(events, "train.grad_exchange.bucket")
    assert hops and {name.split(".")[3] for name, _ in hops} \
        <= {"mn_stripe_pack", "mn_stripe_pack_scatter_dcn",
            "mn_stripe_rs_ici", "mn_stripe_allreduce_ici",
            "mn_stripe_allreduce_dcn", "mn_stripe_ag_dcn",
            "mn_stripe_ag_ici"}


@pytest.mark.gpu
@pytest.mark.parametrize("stride,pad,outsize", [(1, 1, None), (2, 1, None),
                                                (2, 1, (9, 9))])
def test_deconvolution_on_the_card_equals_the_cpu(cuda_device, stride, pad,
                                                  outsize):
    """``F.deconvolution_2d`` through cuDNN against the CPU, output and
    the three gradients, TF32 off: 1e-5 absolute (another summation
    order)."""
    from chainermn_tpu_torch.nn import functions as F
    rng = np.random.RandomState(5)
    host = [rng.normal(0, 1, (4, 16, 4, 4)).astype(np.float32),
            rng.normal(0, 0.2, (16, 8, 4, 4)).astype(np.float32),
            rng.normal(0, 1, (8,)).astype(np.float32)]
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = []
        for device in (cuda_device, torch.device("cpu")):
            args = [torch.from_numpy(a).to(device).requires_grad_()
                    for a in host]
            y = F.deconvolution_2d(*args, stride=stride, pad=pad,
                                   outsize=outsize)
            g = torch.from_numpy(np.random.RandomState(6).normal(
                0, 1, tuple(y.shape)).astype(np.float32)).to(device)
            (y * g).sum().backward()
            runs.append([y.detach().cpu()] + [a.grad.cpu() for a in args])
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for got, want in zip(*runs):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)


@pytest.mark.gpu
def test_dcgan_iteration_on_the_card_matches_the_cpu(cuda_device):
    """One ``DCGANUpdater`` iteration of the CPU tests' small DCGAN (n_hidden
    16, ch 32, batch 8, ``Adam(2e-4, beta1=0.5)``) on the card against the
    CPU from the same seeds and noise, TF32 off.  The discriminator's
    loss, gradients (Adam's first moment) and both nets' running
    statistics come before any update: 1e-5.  One Adam step moves a
    weight by at most alpha, and a gradient at the rounding-noise level
    (the biases ahead of a batch normalization have an exact gradient of
    0) picks its direction: parameters within 2 alpha.  The generator's
    loss and gradients are taken through the updated discriminator:
    1e-4 relative and 1e-3 absolute."""
    from chainermn_tpu_torch.core import reporter
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.dataset import SerialIterator
    from chainermn_tpu_torch.models import (DCGANUpdater, Discriminator,
                                            Generator)
    from chainermn_tpu_torch.serializers.npz import DictionarySerializer
    alpha = 2e-4
    rng = np.random.RandomState(0)
    data = rng.normal(0, 0.5, (8, 3, 32, 32)).astype(np.float32)
    z = rng.normal(0, 1, (8, 16)).astype(np.float32)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = []
        for device in (cuda_device, torch.device("cpu")):
            gen = Generator(n_hidden=16, ch=32, seed=0, device=device)
            dis = Discriminator(ch=32, seed=1, device=device)
            gen.make_hidden = lambda n, key=None, d=device: \
                torch.from_numpy(z).to(d)
            updater = DCGANUpdater(
                SerialIterator(data, 8, shuffle=False),
                Adam(alpha=alpha, beta1=0.5).setup(gen),
                Adam(alpha=alpha, beta1=0.5).setup(dis))
            obs = {}
            with reporter.Reporter().scope(obs):
                updater.update()
            s = DictionarySerializer()
            updater.serialize(s)
            runs.append(({k: float(v) for k, v in obs.items()}, s.target))
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    (obs, state), (ref_obs, ref_state) = runs
    np.testing.assert_allclose(obs["dis/loss"], ref_obs["dis/loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(obs["gen/loss"], ref_obs["gen/loss"],
                               rtol=1e-4)
    for key, want in ref_state.items():
        if not key.startswith("optimizer:") or want.dtype.kind != "f":
            continue
        if "avg_" in key or key.startswith("optimizer:dis/opt_state"):
            atol = 1e-5
        elif "opt_state" in key:
            atol = 1e-3
        else:
            atol = 2 * alpha
        np.testing.assert_allclose(state[key], want, rtol=0, atol=atol,
                                   err_msg=key)


# -- sequence parallelism and the mixture of experts --------------------------

def _rel_err(got, ref):
    """Largest |got - ref| relative to the largest |ref|."""
    ref = ref.float().cpu()
    return ((got.float().cpu() - ref).abs().max()
            / ref.abs().max().clamp_min(1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", ["naive", "zigzag"])
@pytest.mark.parametrize("bwd", ["fused", "split"])
def test_ring_replay_on_the_card_matches_the_cpu(cuda_device, monkeypatch,
                                                 schedule, bwd):
    """A 4-rank ring schedule replayed in one process (``_ring_replay``:
    every rank's chunk against every step's, merged) through the lse
    forward and the backward kernels (Tq != Tk and half-chunk diagonals
    in zigzag, a non-zero lse cotangent in every block) against the same
    replay through the plain versions on the CPU: bf16 at T 512 (chunks
    of 128, half-chunks of 64), causal, out and dq, dk, dv relative to
    their largest |ref| (the CPU backward keeps ds in fp32 where the
    kernels cast it to bf16: AUTOGRAD_TOL)."""
    from chainermn_tpu_torch.parallel.ring_attention import _ring_replay
    monkeypatch.setattr(fa, "_FLASH_BWD", bwd)
    q, k, v, g = _train_inputs(1, 2, 512, 512, 64, torch.bfloat16,
                               torch.device("cpu"), 21)
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        leaves = [x.to(device).requires_grad_() for x in (q, k, v)]
        out = _ring_replay(*leaves, 4, schedule, causal=True)
        out.backward(g.to(device))
        runs.append([out.detach()] + [x.grad for x in leaves])
    for got, ref in zip(*runs):
        assert torch.isfinite(got.float()).all()
        assert _rel_err(got, ref) < AUTOGRAD_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["ring", "zigzag", "ulysses"])
def test_sequence_parallel_attention_at_a_world_of_one(cuda_device, mode):
    """Ring (one diagonal block), zigzag (three half-blocks merged) and
    Ulysses (an identity all-to-all) over NCCL with one rank: fp32 out
    and gradients equal attention through the plain version on the
    CPU."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.parallel import (ring_self_attention,
                                              ulysses_attention)
    q, k, v, g = _train_inputs(2, 4, 128, 128, 64, torch.float32,
                               torch.device("cpu"), 22)
    comm = create_communicator("pure_nccl")
    try:
        leaves = [x.to(cuda_device).requires_grad_() for x in (q, k, v)]
        if mode == "ulysses":
            out = ulysses_attention(comm, *leaves, causal=True)
        else:
            out = ring_self_attention(
                comm, *leaves, causal=True,
                schedule="zigzag" if mode == "zigzag" else "naive")
        out.backward(g.to(cuda_device))
    finally:
        comm.finalize()
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = xla_attention(*ref_leaves, causal=True)
    ref.backward(g)
    assert _rel_err(out.detach(), ref.detach()) < 1e-4
    for x, r in zip(leaves, ref_leaves):
        assert _rel_err(x.grad, r.grad) < 1e-4


@pytest.mark.gpu
def test_moe_lm_dispatch_at_a_world_of_one_matches_the_cpu(cuda_device):
    """The MoE LM's dispatch route over NCCL with one rank (one expert,
    a flat all-to-all of one) on the card, fp32 with TF32 off, against
    the dense route with one expert on the CPU (the same routing: at
    capacity factor 1.25 nothing is dropped): the loss, ``moe_aux`` 1 and
    ``moe_dropped`` 0, and every gradient."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.core import reporter
    from chainermn_tpu_torch.models import MoETransformerLM
    kw = dict(n_vocab=97, d_model=64, n_heads=1, n_layers=2, max_len=32,
              seed=0)
    x = torch.from_numpy(np.random.RandomState(7).randint(0, 97, (2, 32)))
    t = torch.roll(x, -1, 1)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    comm = create_communicator("pure_nccl")
    try:
        runs = []
        for ep, device in ((comm, cuda_device), (1, torch.device("cpu"))):
            model = MoETransformerLM(ep_comm=ep, device=device, **kw)
            obs, rep = {}, reporter.Reporter()
            rep.add_observer("main", model)
            with rep.scope(obs):
                loss = model(x.to(device), t.to(device))
            loss.backward()
            runs.append((loss.item(), {k: float(v) for k, v in obs.items()},
                         {p: a.grad for p, a in model.namedparams()}))
    finally:
        comm.finalize()
        torch.backends.cuda.matmul.allow_tf32 = saved
    (loss, obs, grads), (ref_loss, ref_obs, ref_grads) = runs
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    assert obs["main/moe_dropped"] == 0 == ref_obs["main/moe_dropped"]
    assert obs["main/moe_aux"] == pytest.approx(1.0, abs=1e-6)
    for p, r in ref_grads.items():
        assert _rel_err(grads[p], r) < 1e-4, p


@pytest.mark.gpu
def test_store_adapter_over_a_tcp_store_on_the_card_host(cuda_device):
    """The host channel's store adapter over a TCPStore on the card's
    machine (this torch build): a timed-out wait leaves the client
    usable, a p2p round trip and a barrier go through and leave no key
    behind, and the channel hands a CUDA tensor back on the card."""
    import datetime

    import torch.distributed as dist
    from chainermn_tpu_torch.communicators import HostChannel, StoreKV
    server = dist.TCPStore("127.0.0.1", 0, 1, True,
                           timeout=datetime.timedelta(seconds=30),
                           wait_for_workers=False)
    client = dist.TCPStore("127.0.0.1", server.port, 1, False,
                           timeout=datetime.timedelta(seconds=5))
    with pytest.raises(Exception):
        client.wait(["missing"], datetime.timedelta(milliseconds=100))
    kv = StoreKV(client)
    with pytest.raises(TimeoutError):
        kv.blocking_key_value_get("never", 30)
    ch = HostChannel(client=kv, process_id=0, num_processes=1,
                     timeout_ms=5000)
    ch.enable_heartbeat(interval_s=0.2)
    base = server.num_keys()
    try:
        x = torch.arange(6.0, device=cuda_device)
        ch.send_obj(x, 0, tag=1)
        got = ch.recv_obj(0, tag=1)
        assert got.device.type == "cuda" and torch.equal(got, x)
        ch.barrier()
        assert ch.allgather({"r": 0}) == [{"r": 0}]
        assert server.num_keys() == base   # every op took its keys back
    finally:
        ch.monitor.stop_thread()


@pytest.mark.gpu
def test_elastic_rebuild_onto_a_fresh_nccl_world_of_one(cuda_device):
    """A world of one on NCCL rebuilt by ElasticMeshCommunicator((0,),
    epoch=1) over a TCPStore: the old world is aborted, the new one is
    NCCL over the store's ``<ns>/el1/pg`` prefix, its collectives run on
    the card, and a multi-node optimizer moves onto it."""
    import datetime

    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.communicators import (ElasticMeshCommunicator,
                                                   HostChannel, StoreKV)
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.models import MLP, Classifier
    store = dist.TCPStore("127.0.0.1", 0, 1, True,
                          timeout=datetime.timedelta(seconds=30),
                          wait_for_workers=False)
    ch = HostChannel(client=StoreKV(store), process_id=0, num_processes=1)
    boot = create_communicator("pure_nccl")
    model = Classifier(MLP(n_units=16, n_out=3, seed=0, device=cuda_device))
    opt = create_multi_node_optimizer(Adam(), boot,
                                      zero_sharding=True).setup(model)
    x = torch.randn(8, 5, device=cuda_device)
    t = torch.randint(0, 3, (8,), device=cuda_device)
    opt.update(model, x, t)
    el = ElasticMeshCommunicator((0,), epoch=1, channel=ch)
    try:
        assert "nccl" in dist.get_backend() and el.device.type == "cuda"
        assert (el.epoch, el.members, el.stable_rank) == (1, (0,), 0)
        assert el.group is None and dist.get_world_size() == 1
        opt.change_communicator(el)
        assert opt.communicator is el
        loss = opt.update(model, x, t)
        assert torch.isfinite(loss) and loss.device.type == "cuda"
        assert el.calls["reduce_scatter_grad"] == 1
        y = el.allreduce(torch.ones(3, device=cuda_device))
        assert y.device.type == "cuda" and torch.equal(y.cpu(),
                                                        torch.ones(3))
    finally:
        el.finalize()
    assert not dist.is_initialized()


@pytest.mark.gpu
def test_span_writer_and_verify_attention_on_the_card(cuda_device):
    """``write_span_kv`` (idle lane, short span) writes the same pages on
    the card as on the CPU, and ``paged_verify_attention`` reads them
    back within the fp32 tolerance (TF32 off), the idle lane zeros."""
    from chainermn_tpu_torch.ops.paged_attention import \
        paged_verify_attention
    from chainermn_tpu_torch.serving import write_span_kv
    rng = np.random.RandomState(0)
    P, S, H, D = 6, 4, 2, 64
    pools = [rng.normal(0, 1, (P + 1, S, H, D)).astype(np.float32)
             for _ in range(2)]
    kv = rng.normal(0, 1, (3, 5, H, D)).astype(np.float32)
    q = rng.normal(0, 1, (3, 5, H, D)).astype(np.float32)
    bts = np.array([[2, 3, 1], [5, 1, 0], [0, 4, 2]], np.int64)
    start = np.array([3, -1, 6], np.int64)
    n_valid = np.array([5, 5, 2], np.int64)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = []
        for dev in ("cpu", cuda_device):
            k_store, v_store = [torch.from_numpy(a).to(dev) for a in pools]
            args = [torch.from_numpy(a).to(dev) for a in (bts, start,
                                                          n_valid)]
            write_span_kv(k_store, torch.from_numpy(kv).to(dev), *args)
            write_span_kv(v_store, torch.from_numpy(-kv).to(dev), *args)
            out = paged_verify_attention(torch.from_numpy(q).to(dev),
                                         k_store[:P], v_store[:P],
                                         args[0], args[1])
            outs.append([t.cpu() for t in (k_store[:P], v_store[:P], out)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    (kc, vc, oc), (kg, vg, og) = outs
    assert torch.equal(kc, kg) and torch.equal(vc, vg)
    assert (og - oc).abs().max().item() < TOL[torch.float32]
    assert torch.all(og[1] == 0)


#: a greedy token that differs between the card and the CPU in fp32 must
#: sit at a near-tie of the CPU's top two logits
FP32_TIE = 1e-3


@pytest.mark.gpu
def test_engine_spec_and_chunks_on_the_card_match_the_cpu(cuda_device):
    """One engine run with ``spec_k=2`` and ``chunk_tokens=16`` at a tiny
    width (head width 64 for the flash prefill), fp32 with TF32 off, on
    the card and on the CPU: the token lists equal, or the first
    divergence at a top-two gap of the CPU's logits below FP32_TIE; the
    counters' structure the same."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import Request, ServingEngine
    cfg = dict(n_vocab=101, d_model=128, n_heads=2, n_layers=2, max_len=128,
               seed=0)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 101, n) for n in (5, 40, 23, 9)]
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    try:
        for dev in ("cpu", "cuda"):
            model = TransformerLM(device=dev, **cfg)
            eng = ServingEngine(model, num_pages=64, page_size=8,
                                max_batch=4, max_context=64, spec_k=2,
                                chunk_tokens=16, device=dev)
            for i, p in enumerate(prompts):
                eng.submit(Request(p, max_new_tokens=10, request_id=i,
                                   arrival_time=float(i)))
            t = 0.0
            while eng.running or eng.prefilling or eng.scheduler.pending():
                eng.step(now=t)
                t += 1.0
            assert eng.allocator.used_pages == 0 and eng.allocator.check()
            runs[dev] = (model, eng, {r.request_id: list(r.tokens)
                                      for r in eng.completed})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    cpu_model, cpu_eng, want = runs["cpu"]
    _, card_eng, got = runs["cuda"]
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    # the 40- and 23-token prompts chunk
    assert cpu_eng.chunked_admissions == card_eng.chunked_admissions == 2
    assert card_eng.spec_steps > 0
    for i, toks in got.items():
        if toks == want[i]:
            continue
        j = next(j for j, (a, b) in enumerate(zip(toks, want[i])) if a != b)
        seq = torch.tensor([list(prompts[i]) + want[i][:j]])
        with torch.no_grad():
            top2 = torch.topk(cpu_model.logits(seq)[0, -1], 2).values
        assert (top2[0] - top2[1]).item() < FP32_TIE, (i, j)


@pytest.mark.gpu
def test_engine_disagg_and_tp_on_the_card_match_the_cpu(cuda_device):
    """A small fp32 engine (TF32 off) with disaggregated prefill, and with
    tp=1 over a communicator of one (NCCL on the card, a gloo group on the
    CPU: the slice, the gather and the token broadcast at a group of
    one), on the card and on the CPU; and an engine on the CPU whose
    prefill device is the card (a copy of the model there, the flash
    kernel on the scratch pool, each ship a copy from the card into the
    CPU's pool) against the same engine prefilling on the CPU: the token
    lists equal, or the first divergence at a top-two gap of the CPU's
    logits below FP32_TIE; the ships and their bytes the same."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.communicators import MeshCommunicator
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import Request, ServingEngine
    cfg = dict(n_vocab=101, d_model=128, n_heads=2, n_layers=2, max_len=128,
               seed=0)
    rng = np.random.RandomState(2)
    system = rng.randint(0, 101, 20)
    prompts = [system] + [np.concatenate([system, rng.randint(0, 101, n)])
                          for n in (9, 3)] + [rng.randint(0, 101, 33)]
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    card_comm = create_communicator("pure_nccl")
    runs = {}
    try:
        comms = {"cuda": card_comm,
                 "cpu": MeshCommunicator(device="cpu",
                                         group=dist.new_group(
                                             backend="gloo"))}
        for dev in ("cpu", "cuda"):
            model = TransformerLM(device=dev, **cfg)
            for name, kw in (("disagg", dict(disagg=True)),
                             ("tp", dict(tp=1, tp_comm=comms[dev]))):
                eng = ServingEngine(model, num_pages=64, page_size=8,
                                    max_batch=4, max_context=64,
                                    device=dev, **kw)
                for i, p in enumerate(prompts):
                    eng.submit(Request(p, max_new_tokens=10, request_id=i,
                                       arrival_time=float(i)))
                t = 0.0
                while eng.running or eng.prefilling \
                        or eng.scheduler.pending():
                    eng.step(now=t)
                    t += 1.0
                assert eng.allocator.used_pages == 0
                runs[dev, name] = (model, eng, {r.request_id: list(r.tokens)
                                                for r in eng.completed})
        model = runs["cpu", "disagg"][0]
        eng = ServingEngine(model, num_pages=64, page_size=8, max_batch=4,
                            max_context=64, device="cpu", disagg=True,
                            prefill_device="cuda")
        assert eng._model_prefill is not model
        assert eng._model_prefill.device.type == "cuda"
        assert eng._kv_prefill.k_store.device.type == "cuda"
        before = flash_attention.launches
        for i, p in enumerate(prompts):
            eng.submit(Request(p, max_new_tokens=10, request_id=i,
                               arrival_time=float(i)))
        t = 0.0
        while eng.running or eng.prefilling or eng.scheduler.pending():
            eng.step(now=t)
            t += 1.0
        assert eng.allocator.used_pages == 0
        assert flash_attention.launches - before \
            == eng.full_prefills * cfg["n_layers"] > 0
        assert eng.kv.k_store.device.type == "cpu"
        runs["cross", "disagg"] = (model, eng, {r.request_id: list(r.tokens)
                                                for r in eng.completed})
        assert card_comm.calls["allgather"] > 0 and card_comm.calls["bcast"]
        comms["cpu"].finalize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
        card_comm.finalize()
    for dev, name in (("cuda", "disagg"), ("cuda", "tp"),
                      ("cross", "disagg")):
        cpu_model, cpu_eng, want = runs["cpu", name]
        _, card_eng, got = runs[dev, name]
        assert sorted(got) == sorted(want) == list(range(len(prompts)))
        assert (card_eng.transfers, card_eng.transferred_page_bytes) \
            == (cpu_eng.transfers, cpu_eng.transferred_page_bytes)
        for i, toks in got.items():
            if toks == want[i]:
                continue
            j = next(j for j, (a, b) in enumerate(zip(toks, want[i]))
                     if a != b)
            seq = torch.tensor([list(prompts[i]) + want[i][:j]])
            with torch.no_grad():
                top2 = torch.topk(cpu_model.logits(seq)[0, -1], 2).values
            assert (top2[0] - top2[1]).item() < FP32_TIE, (name, i, j)
    assert runs["cuda", "disagg"][1].transfers > 0


@pytest.mark.gpu
def test_fleet_kill_and_join_on_the_card_match_the_cpu(cuda_device):
    """A small fp32 fleet (TF32 off) of two replicas, one killed at its
    second decode step under load and a cold replica joined, on the card
    and on the CPU.  Each fleet's joiner lies on the other device, so the
    weight payload crosses devices both ways: the joiner bitwise the root.
    Every request completes once in both fleets, with the same sheds and
    reroutes; the tokens equal, or the first divergence at a top-two gap
    of the CPU's logits below FP32_TIE; B3 launches 2 layers a flash
    prefill of the card's engines."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import ReplicaFleet, Request, \
        ServingEngine
    cfg = dict(n_vocab=101, d_model=128, n_heads=2, n_layers=2, max_len=64)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 101, n) for n in (9, 30, 17, 5, 24, 12, 8,
                                                 20, 11, 6)]

    def engine(dev, seed=0):
        return ServingEngine(TransformerLM(device=dev, seed=seed, **cfg),
                             num_pages=32, page_size=8, max_batch=2,
                             max_context=64, device=dev)

    def state(eng):
        return [t.cpu() for t in eng.model.state_dict().values()]

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    try:
        for dev, other in (("cpu", "cuda"), ("cuda", "cpu")):
            fleet = ReplicaFleet(engine_factory=lambda rid, d=dev: engine(d),
                                 replicas=2)
            before = flash_attention.launches
            for i, p in enumerate(prompts[:6]):
                fleet.submit(Request(p, 10, tenant=f"t{i % 2}",
                                     request_id=i))
            fleet.replicas[1].kill_at = 2
            fleet.drain(now=1.0)
            joiner = engine(other, seed=123)
            assert fleet.join(engines={2: joiner}) == [2]
            assert all(torch.equal(a, b) for a, b in
                       zip(state(joiner), state(fleet.replicas[0].engine)))
            for i, p in enumerate(prompts[6:], start=6):
                fleet.submit(Request(p, 10, tenant="t0", request_id=i))
            fleet.drain(now=2.0)
            card = [r.engine for r in fleet.replicas.values()
                    if r.engine.device.type == "cuda"]
            assert flash_attention.launches - before == cfg["n_layers"] \
                * sum(e.full_prefills for e in card) > 0
            runs[dev] = (fleet.sheds, fleet.reroutes,
                         fleet.weight_sync_rounds,
                         {r.request_id: [int(t) for t in r.prompt[
                             len(prompts[r.request_id]):]] + list(r.tokens)
                          for r in fleet.completed})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    *counts, want = runs["cpu"]
    *card_counts, got = runs["cuda"]
    assert card_counts == counts and counts[0] == 1 and counts[1] >= 1
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    cpu_model = TransformerLM(device="cpu", seed=0, **cfg)
    for i, toks in got.items():
        if toks == want[i]:
            continue
        j = next(j for j, (a, b) in enumerate(zip(toks, want[i])) if a != b)
        seq = torch.tensor([list(prompts[i]) + want[i][:j]])
        with torch.no_grad():
            top2 = torch.topk(cpu_model.logits(seq)[0, -1], 2).values
        assert (top2[0] - top2[1]).item() < FP32_TIE, (i, j)


@pytest.mark.gpu
def test_last_surface_functions_and_links_on_the_card_match_the_cpu(
        cuda_device):
    """A few of the last slice's functions and links, forward and
    backward in fp32 with TF32 off, on the card against the CPU at small
    shapes (the phases of chip_smoke.py run them all at ResNet-50's
    widths): moves exactly, elementwise within 1e-5 and sums within 1e-4
    of the largest |CPU value|; and the numpy bridge's round trip
    through the card, bitwise."""
    import copy

    from chainermn_tpu_torch.core.link import Sequential
    from chainermn_tpu_torch.nn import functions as F
    from chainermn_tpu_torch.nn import links as L
    from chainermn_tpu_torch.utils.dlpack import from_numpy, to_numpy
    g = np.random.default_rng(0)
    a = g.standard_normal((2, 32, 9, 7), dtype=np.float32)
    w = g.standard_normal((4, 64), dtype=np.float32)
    cases = [
        (0.0, lambda x: F.pad(x, ((0, 0), (0, 0), (2, 3), (4, 1)),
                              mode="reflect"), [a]),
        (0.0, lambda x: F.clip(x, -0.5, 0.5), [a]),
        (0.0, lambda x: F.max(x, axis=(2, 3)), [a]),
        (1e-5, lambda x: F.softplus(x) + F.erf(x), [a]),
        (1e-4, lambda x: F.unpooling_2d(x, 3, stride=2, pad=1), [a]),
        (1e-4, lambda x: F.resize_images(x, (5, 15)), [a]),
        (1e-4, lambda x: F.cumprod(1 + 0.01 * x, axis=1), [a]),
        (1e-4, lambda x, y: F.huber_loss(x, y), [w, w[::-1].copy()]),
    ]
    links = [
        (L.DepthwiseConvolution2D(32, 2, 3, pad=1, seed=1, device="cpu"), a),
        (Sequential(L.GroupNormalization(8, 32, device="cpu"), F.relu,
                    L.Scale(axis=1, W_shape=(32,), bias_term=True,
                            device="cpu")), a),
        (L.Highway(64, seed=2, device="cpu"), w),
        (L.Maxout(64, 16, 4, seed=3, device="cpu"), w),
    ]

    def run(fn, inputs, device, params=()):
        xs = [torch.from_numpy(x).to(device).requires_grad_(True)
              for x in inputs]
        y = fn(*xs)
        gen = torch.Generator().manual_seed(5)
        y.backward(torch.randn(y.shape, generator=gen).to(device))
        return [y.detach().cpu()] + [x.grad.cpu() for x in xs] \
            + [p.grad.cpu() for p in params]

    def close(got, want, tol):
        for gt, wt in zip(got, want):
            err = (gt - wt).abs().max().item()
            assert err <= tol * max(wt.abs().max().item(), 1e-30), err

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for tol, fn, inputs in cases:
            close(run(fn, inputs, cuda_device), run(fn, inputs, "cpu"), tol)
        for link, x in links:
            card = copy.deepcopy(link).to(cuda_device)
            close(run(card, [x], cuda_device, list(card.parameters())),
                  run(link, [x], "cpu", list(link.parameters())), 1e-4)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
    batch = np.random.default_rng(1).integers(0, 256, (4, 3, 32, 32),
                                              dtype=np.uint8)
    t = from_numpy(batch, device=cuda_device)
    assert t.device.type == "cuda"
    np.testing.assert_array_equal(to_numpy(t), batch)


@pytest.mark.gpu
def test_span_clock_and_device_twins_agree_with_the_profiler(cuda_device,
                                                             tmp_path):
    """Under ``full`` in a ``torch.profiler`` capture on the card: each
    span, its ``ts`` mapped through the shard's ``clock_sync`` pairs,
    starts within 200 µs of its ``record_function`` twin (50 µs at the
    median), and each device twin, placed from its anchor, holds the
    kernel launched inside it and ends within 200 µs of the kernel's end
    (its start waits for the host's launch: no bound)."""
    from torch.profiler import ProfilerActivity, profile
    from chainermn_tpu_torch import observability as obs
    from chainermn_tpu_torch.tools import trace_merge
    prev = obs.set_mode("full")
    obs.reset_tracer()
    try:
        x = torch.randn(2048, 2048, device=cuda_device)
        with obs.span("warm", device=cuda_device):
            x @ x
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                with obs.span("train/forward", device=cuda_device):
                    x @ x
            torch.cuda.synchronize()
        path = tmp_path / "trace-rank0.jsonl"
        obs.tracer().export(str(path))
    finally:
        obs.set_mode(prev)
        obs.reset_tracer()
    events = obs.read_jsonl(str(path))
    obs.validate_events(events)
    clock = trace_merge.profiler_clock(next(
        e["args"] for e in events
        if e["ph"] == "M" and e["name"] == "clock_sync"))
    hosts = [clock(e["ts"]) for e in events
             if e["name"] == "train/forward" and e["ph"] == "B"]
    twins = [e for e in events if e["name"] == "train/forward/device"]
    raw = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    ranges = sorted(e.start_ns() / 1e3 for e in raw
                    if e.is_user_annotation() and e.device_type() != cuda
                    and e.name() == "train.forward")
    kernels = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3) for e in raw
                     if e.device_type() == cuda
                     and not e.is_user_annotation())
    assert len(hosts) == len(ranges) == len(kernels) == 20
    gaps = [abs(h - r) for h, r in zip(hosts, ranges)]
    assert statistics.median(gaps) <= 50 and max(gaps) <= 200, gaps
    begins = [clock(e["ts"]) for e in twins if e["ph"] == "B"]
    ends = [clock(e["ts"]) for e in twins if e["ph"] == "E"]
    for b, e, (k0, k1) in zip(begins, ends, kernels):
        assert b - 200 <= k0 and k1 <= e + 200 and e - k1 <= 200, \
            (b, e, k0, k1)


# -- batch norm with its activation (ops/batch_norm.py) -----------------------

bn = importlib.import_module("chainermn_tpu_torch.ops.batch_norm")

# (shape, name): conv1's (C 64, 112^2, batch 4); res5's (C 2048, 7^2, batch
# 16); a row count that is no multiple of a block's 32 rows nor of a split,
# and C 136, whose last channel tile holds one live group of 8; the 2-D
# (N, C) case
BN_SHAPES = [((4, 112, 112, 64), "conv1"), ((16, 7, 7, 2048), "res5"),
             ((3, 13, 11, 136), "ragged"), ((50, 520), "2d")]
BN_ACTS = ["none", "relu", "residual"]
# fp32 against the plain version on the card: the kernels take Welford
# moments and sum in another order (the plain version: E[x^2] - mean^2 and
# torch's tree sums), so y and dx differ by fp32 rounding of the
# statistics (|x^| <= ~5 here): 2e-5 of the largest |ref| for y, mean and
# var, the running statistics and dx; the parameters' gradients sum
# 6e3-2e5 terms in other orders: 1e-4 of their largest |ref|.
BN_TOL, BN_SUM_TOL = 2e-5, 1e-4


def _bn_case(shape, act, dtype, device, seed, plant=False):
    """Inputs from numpy: x with channel means up to 2 and stds 0.5-2,
    gamma, beta, the running statistics, the residual (act "residual")
    and dy.  Where the float64 pre-activation lies within 1e-3 of the ReLU's
    kink, dy is 0, so a last-bit difference of the two sides' statistics
    cannot flip a mask.  ``plant``: channel 0 is constant 0.5 with beta 0
    (and residual 0), so its pre-activation is exactly 0 on both sides."""
    rng = np.random.RandomState(seed)
    C = shape[-1]
    x = (rng.normal(0, 1, shape) * rng.uniform(0.5, 2, C)
         + rng.uniform(-2, 2, C))
    gamma = rng.uniform(0.5, 1.5, C)
    beta = rng.normal(0, 0.5, C)
    s = rng.normal(0, 1, shape) if act == "residual" else None
    if plant:
        x[..., 0] = 0.5
        beta[0] = 0.0
        if s is not None:
            s[..., 0] = 0.0
    dt = torch.float32 if dtype == torch.float32 else torch.bfloat16
    x = torch.from_numpy(x.astype(np.float32)).to(dt)
    if s is not None:
        s = torch.from_numpy(s.astype(np.float32)).to(dt)
    x64 = x.double().numpy()
    axes = tuple(range(len(shape) - 1))
    mean, var = x64.mean(axes), x64.var(axes)
    pre = (x64 - mean) / np.sqrt(var + 2e-5) * gamma + beta
    if s is not None:
        pre = pre + s.double().numpy()
    dy = rng.normal(0, 1, shape)
    if act != "none":
        near = np.abs(pre) < 1e-3
        if plant:
            near[..., 0] = False
        dy[near] = 0.0
    dy = torch.from_numpy(dy.astype(np.float32)).to(dt)

    def dev(a):
        return None if a is None else a.to(device)

    vec = [torch.from_numpy(a.astype(np.float32)).to(device)
           for a in (gamma, beta, rng.normal(0, 1, C), rng.uniform(1, 2, C))]
    return dev(x), vec[0], vec[1], vec[2], vec[3], dev(s), dev(dy)


def _bn_run(fn, x, gamma, beta, avg_mean, avg_var, s, dy, act):
    """``fn`` (batch_norm_act or its plain version) forward and backward
    on fresh leaves and copies of the running statistics: y, mean, var,
    both running statistics, dx, dgamma, dbeta and ds (or None)."""
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, gamma, beta) + ((s,) if s is not None else ())]
    am, av = avg_mean.clone(), avg_var.clone()
    y, mean, var = fn(leaves[0], leaves[1], leaves[2], am, av, eps=2e-5,
                      decay=0.9, relu=act != "none",
                      residual=leaves[3] if s is not None else None)
    y.backward(dy)
    return [y.detach(), mean, var, am, av] + [l.grad for l in leaves] + (
        [] if s is not None else [None])


def _rel(got, want):
    """Largest |got - want| over the largest |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("act", BN_ACTS)
@pytest.mark.parametrize("shape,name", BN_SHAPES)
def test_batch_norm_kernels_match_plain(cuda_device, shape, name, act):
    """fp32: the fused kernels (forward, running statistics, backward)
    against the plain version on the card, each output within its
    tolerance (``BN_TOL``, ``BN_SUM_TOL``)."""
    case = _bn_case(shape, act, torch.float32, cuda_device, seed=len(name))
    got = _bn_run(bn.batch_norm_act, *case, act)
    want = _bn_run(bn.batch_norm_act_plain, *case, act)
    names = ["y", "mean", "var", "avg_mean", "avg_var", "dx", "dgamma",
             "dbeta", "ds"]
    for what, g, w in zip(names, got, want):
        if w is None:
            assert g is None, what
            continue
        tol = BN_SUM_TOL if what in ("dgamma", "dbeta") else BN_TOL
        assert _rel(g, w) <= tol, (what, _rel(g, w))


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["relu", "residual"])
def test_batch_norm_kernel_relu_gradient_is_half_at_zero(cuda_device, act):
    """A channel whose pre-activation is exactly 0 (constant input, beta
    0, residual 0) passes half of dy, as ``F.relu``: its y is 0, ds is
    dy / 2 bitwise, dbeta half the sum of dy, and dx as the plain version's
    on the CPU (on the card the plain mean, a sum times 1/m, misses the
    constant by an ulp, so there the kink is not hit)."""
    case = _bn_case((6, 9, 9, 64), act, torch.float32, cuda_device, seed=3,
                    plant=True)
    got = [None if t is None else t.cpu()
           for t in _bn_run(bn.batch_norm_act, *case, act)]
    want = _bn_run(bn.batch_norm_act_plain,
                   *[None if t is None else t.cpu() for t in case], act)
    dy = case[-1][..., 0].cpu()
    assert torch.equal(got[0][..., 0], torch.zeros_like(got[0][..., 0]))
    scale = dy.abs().sum().item()
    assert abs(got[7][0].item() - 0.5 * dy.sum().item()) <= 1e-5 * scale
    assert abs(got[7][0].item() - want[7][0].item()) <= 1e-5 * scale
    if act == "residual":
        assert torch.equal(got[8][..., 0], 0.5 * dy)
        assert torch.equal(got[8][..., 0], want[8][..., 0])
    assert _rel(got[5][..., 0], want[5][..., 0]) <= BN_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4, 112, 112, 64), (16, 7, 7, 2048)])
def test_batch_norm_kernels_are_deterministic_and_counted(cuda_device,
                                                          shape, dtype):
    """Two identical calls give bitwise the same outputs and gradients
    (the partials merge in a fixed order, no float atomics), and each
    forward and each backward counts one launch."""
    case = _bn_case(shape, "residual", dtype, cuda_device, seed=7)
    f0, b0 = bn.batch_norm_act_fwd.launches, bn.batch_norm_act_bwd.launches
    runs = [_bn_run(bn.batch_norm_act, *case, "residual") for _ in range(2)]
    assert bn.batch_norm_act_fwd.launches == f0 + 2
    assert bn.batch_norm_act_bwd.launches == b0 + 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_batch_norm_kernels_take_strided_inputs_by_copy(cuda_device):
    """A channel slice of a wider NHWC tensor (not contiguous) and a view
    4 bytes off alignment run the kernels on a contiguous copy: outputs,
    statistics and gradients bitwise those of the call on x itself, the
    gradient flowing back through the view."""
    x, gamma, beta, am, av, s, dy = _bn_case((4, 14, 14, 64), "residual",
                                             torch.float32, cuda_device,
                                             seed=5)
    views = [lambda t: torch.cat([t, t], dim=-1)[..., :64],
             lambda t: torch.cat([t.new_zeros(1), t.reshape(-1)])[1:]
             .view(t.shape)]
    for view in views:
        runs = []
        for strided in (True, False):
            leaves = [t.detach().clone().requires_grad_()
                      for t in (x, gamma, beta, s)]
            xin = view(leaves[0]) if strided else leaves[0]
            assert strided != (xin.is_contiguous()
                               and xin.data_ptr() % 16 == 0)
            y, mean, var = bn.batch_norm_act(
                xin, leaves[1], leaves[2], am.clone(), av.clone(),
                relu=True, residual=leaves[3])
            y.backward(dy)
            runs.append([y, mean, var] + [t.grad for t in leaves])
        for a, b in zip(*runs):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_batch_norm_bf16_kernels_track_the_fp32_plain_version(cuda_device):
    """bf16 in and out: y and dx round once from fp32 arithmetic, so
    against the fp32 plain version on the same (bf16-valued) inputs they
    sit within a bf16 rounding (2 ** -8 of the largest |ref|); the fp32
    statistics and parameters' gradients within the fp32 tolerances."""
    case = _bn_case((8, 28, 28, 256), "residual", torch.bfloat16,
                    cuda_device, seed=11)
    got = _bn_run(bn.batch_norm_act, *case, "residual")
    as32 = [None if t is None else t.float() if t.dtype == torch.bfloat16
            else t for t in case]
    want = _bn_run(bn.batch_norm_act_plain, *as32, "residual")
    assert got[0].dtype == torch.bfloat16 and got[5].dtype == torch.bfloat16
    for i in (0, 5, 8):
        assert _rel(got[i], want[i]) <= 2.0 ** -8, i
    for i in (1, 2, 3, 4):
        assert _rel(got[i], want[i]) <= BN_TOL, i
    for i in (6, 7):
        assert _rel(got[i], want[i]) <= BN_SUM_TOL, i


@pytest.mark.gpu
def test_resnet50_bf16_step_through_the_kernels(cuda_device, monkeypatch):
    """One ResNet-50 NHWC bf16 training step (batch 8, 64^2 images) through
    the fused kernels and through the plain batch norm, each against the
    same step in fp32 on the plain path (TF32 off).  Every batch norm runs
    the kernels (53 forward and 53 backward launches).  Both bf16 steps
    stray from fp32 (a 50-layer chain of bf16 roundings); the kernels'
    no further than the plain batch norm's, with 1.25 x of room: the
    loss (or within 1e-2 relative of fp32), and the gradients leaf by
    leaf as |g - g32| / |g32|, the median leaf and the worst (fp32 sums
    in place of bf16 ones)."""
    from chainermn_tpu_torch.models import Classifier, ResNet50
    from chainermn_tpu_torch.nn import links as L
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randint(0, 256, (8, 64, 64, 3)).astype(
        np.uint8)).to(cuda_device)
    t = torch.from_numpy(rng.randint(0, 1000, 8)).to(cuda_device)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def step(dtype, fused):
        model = Classifier(ResNet50(compute_dtype=dtype, layout="NHWC",
                                    input_norm="imagenet",
                                    device=cuda_device))
        with monkeypatch.context() as m:
            if not fused:
                m.setattr(L.BatchNormalization, "_takes_kernel",
                          lambda *a: False)
            f0 = bn.batch_norm_act_fwd.launches
            b0 = bn.batch_norm_act_bwd.launches
            loss = model(x, t)
            loss.backward()
            torch.cuda.synchronize()
            n = (bn.batch_norm_act_fwd.launches - f0,
                 bn.batch_norm_act_bwd.launches - b0)
        grads = {p: v.grad.float() for p, v in model.namedparams()}
        return loss.item(), grads, n

    try:
        loss32, g32, _ = step(None, False)
        loss_k, g_k, n_k = step(torch.bfloat16, True)
        loss_p, g_p, n_p = step(torch.bfloat16, False)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    assert n_k == (53, 53) and n_p == (0, 0)
    assert abs(loss_k - loss32) <= max(1.25 * abs(loss_p - loss32),
                                       1e-2 * abs(loss32)), (
        loss_k, loss_p, loss32)

    def errs(g):
        return sorted(((g[p] - g32[p]).norm() / g32[p].norm().clamp_min(
            1e-30)).item() for p in g32)

    e_k, e_p = errs(g_k), errs(g_p)
    assert statistics.median(e_k) <= 1.25 * statistics.median(e_p), (
        statistics.median(e_k), statistics.median(e_p))
    assert e_k[-1] <= 1.25 * e_p[-1], (e_k[-1], e_p[-1])
