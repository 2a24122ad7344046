"""Fused flash attention: the Hopper kernel and its plain version.

``attention(q, k, v)`` dispatches on where the tensors lie: a CPU tensor
takes :func:`xla_attention`, the plain PyTorch version; a CUDA tensor
launches :func:`flash_attention`, the hand-written kernel in
``csrc/flash_attention.cu`` (the counterpart of
``chainermn_tpu/ops/flash_attention.py::_flash_kernel``), or raises.  A
CUDA tensor never falls back to the plain version.

Layout ``[B, H, T, D]`` as in the JAX package.  The kernel reads q/k/v
through their strides (the last dimension must be dense and rows 16-byte
aligned, else the wrapper makes a contiguous copy) and writes a
contiguous output.  It takes bf16 or fp32 at head dim 64 or 128.

No backward kernel exists yet: a CUDA call that needs a gradient raises
``NotImplementedError`` (the training slice, ROADMAP A2, brings the
``_flash_kernel_lse`` forward and the fused backward).
"""

from __future__ import annotations

import torch

__all__ = ["attention", "flash_attention", "xla_attention",
           "attention_flops", "attention_bytes"]

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_HEAD_DIMS = (64, 128)


def xla_attention(q, k, v, causal=False, scale=None):
    """Plain PyTorch attention, the reference the kernel is held to.

    Dtype discipline of the JAX ``xla_attention``: the dots take the
    storage-dtype values with fp32 accumulation (done here as fp32 dots of
    the exactly upcast inputs), the softmax runs in fp32, and the
    probabilities are cast to v's dtype before the second dot."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        Tq, Tk = s.shape[-2], s.shape[-1]
        qpos = torch.arange(Tq, device=s.device)[:, None]
        kpos = torch.arange(Tk, device=s.device)[None, :]
        s = s.masked_fill(qpos < kpos, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _kernel_view(x):
    """``x`` itself when the kernel can read it through its strides (dense
    last dimension, 16-byte aligned rows), else a contiguous copy."""
    vec = 16 // x.element_size()
    ok = (x.stride(3) == 1 and x.data_ptr() % 16 == 0
          and all(x.stride(i) % vec == 0 for i in range(3)))
    return x if ok else x.contiguous()


def flash_attention(q, k, v, causal=False, scale=None):
    """Launch the CUDA flash kernel.  q: ``[B, H, Tq, D]``, k/v:
    ``[B, H, Tk, D]`` on one CUDA device, bf16 or fp32, D in (64, 128).
    Raises for anything the kernel does not take; counts each launch in
    ``flash_attention.launches``."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bfloat16 or float32 q/k/v "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes [B, H, T, D] tensors")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention has no kernel for head dim {D} "
                         f"(supported: {_HEAD_DIMS})")
    if k.shape != (B, H, Tk, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Tq < 1 or Tk < 1:
        raise ValueError("flash_attention needs Tq >= 1 and Tk >= 1")
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(
            "flash_attention launches a CUDA kernel: q/k/v must lie on one "
            "CUDA device (CPU tensors take xla_attention via attention())")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash attention has no backward kernel yet; the training "
            "slice (ROADMAP A2: _flash_kernel_lse and the fused backward) "
            "brings it")
    from .._build import load_library
    lib = load_library()
    scale = float(scale if scale is not None else 1.0 / (D ** 0.5))
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    out = torch.empty((B, H, Tq, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, H, Tq, Tk, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(bool(causal)), scale, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def attention(q, k, v, causal=False, scale=None):
    """Dispatch on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"attention runs on cuda or cpu, not {q.device}")
    return xla_attention(q, k, v, causal=causal, scale=scale)


def attention_flops(B, H, Tq, Tk, D, causal):
    """Multiply-adds x2 of QK^T and PV that the inputs need: with
    ``causal`` only the (q, k) pairs with k <= q count."""
    if causal:
        pairs = sum(min(q + 1, Tk) for q in range(Tq))
    else:
        pairs = Tq * Tk
    return 4 * B * H * D * pairs


def attention_bytes(B, H, Tq, Tk, D, itemsize):
    """Bytes read and written once each: q, k, v in, out back."""
    return (2 * B * H * Tq * D + 2 * B * H * Tk * D) * itemsize
