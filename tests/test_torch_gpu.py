"""The port's CUDA kernels against their plain versions, on the card.

Imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Without a card every test skips (the kernels have no CPU mode).
"""

import numpy as np
import pytest
import torch

from chainermn_tpu_torch.ops import flash_attention, xla_attention

# bf16: the kernel and the plain version round p and the output to bf16 at
# different points; 2e-2 is a few bf16 ulps of |out| <= 4.  fp32: the
# kernel sums in another order and uses expf on CUDA cores.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _qkv(B, H, T, D, seed, dtype, device):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.normal(0, 1, (B, H, T, D))
                             .astype(np.float32)).to(device, dtype)
            for _ in range(3)]


@pytest.mark.gpu
@pytest.mark.parametrize("T,D,causal,dtype", [
    (1, 64, True, torch.bfloat16),
    (16, 64, True, torch.bfloat16),
    (200, 64, True, torch.bfloat16),
    (1024, 64, True, torch.bfloat16),
    (128, 64, False, torch.bfloat16),
    (200, 128, True, torch.bfloat16),
    (200, 64, True, torch.float32),
    (130, 128, False, torch.float32),
])
def test_flash_kernel_matches_plain(cuda_device, T, D, causal, dtype):
    q, k, v = _qkv(2, 3, T, D, T + D, dtype, cuda_device)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = xla_attention(q, k, v, causal=causal)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() < TOL[dtype]


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
def test_flash_kernel_refuses_grad(cuda_device):
    q, k, v = _qkv(1, 2, 64, 64, 0, torch.bfloat16, cuda_device)
    q.requires_grad_()
    with pytest.raises(NotImplementedError):
        flash_attention(q, k, v)
